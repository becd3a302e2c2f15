"""Label map + atomic file output contract (twin:
``gpu_feature_discovery_tpu/lm/labels.py``).

The output file is the whole API surface the NFD worker consumes, so the
write is atomic: stage into ``<dir>/tfd-tmp/tfd-XXXX``, fsync, then
``os.replace`` over the target and fsync the directory. NFD never sees a
torn file. The write is also churn-free: a daemon cycle whose labels are
byte-identical to the file's skips the write, so the file keeps its
inode and mtime and NFD, which re-parses on every change, stays idle.
The ``write`` fault site (utils/faults.py) fires at every write.
"""

from __future__ import annotations

import io
import os
import shutil
import sys
import tempfile
import threading
import time
from typing import Dict, Optional, TextIO

from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics

TMP_SUBDIR = "tfd-tmp"
TMP_PREFIX = "tfd-"
OUTPUT_MODE = 0o644

# Kubernetes label-value charset ([A-Za-z0-9]([A-Za-z0-9_.-]*[A-Za-z0-9])?,
# max 63). NFD silently drops labels whose values violate it, so values
# sourced from free-form strings (a CUDA device name such as
# "NVIDIA H100 80GB HBM3") are sanitized.
_LABEL_VALUE_SAFE = frozenset(
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789_.-"
)
LABEL_VALUE_MAX = 63


def label_safe_value(value: str, fallback: str = "unknown") -> str:
    """Coerce a free-form string into a valid k8s label value: disallowed
    characters become dashes, the result is trimmed to valid start/end
    characters and 63 chars; empty results take the fallback."""
    safe = "".join(c if c in _LABEL_VALUE_SAFE else "-" for c in value)
    safe = safe[:LABEL_VALUE_MAX].strip("_.-")
    return safe if safe else fallback


class Labels(dict):
    """A ``key=value`` label map; also a Labeler (it labels itself)."""

    def labels(self) -> "Labels":
        return self

    def write_to(self, output: TextIO) -> int:
        """Serialize as one ``key=value`` line per label."""
        total = 0
        for key, value in self.items():
            total += output.write(f"{key}={value}\n")
        return total

    def write_to_file(self, path: str) -> None:
        """Write labels to ``path`` atomically; empty path → stdout.

        Churn-free: when the serialized content equals the file's, no
        staging file, no rename, mtime untouched. Steady-state cycles pay
        one stat(): the last-written bytes are cached per path with the
        file's (mtime, size, inode) signature and compared in memory; the
        disk is read only on an epoch's first cycle or after an
        out-of-band edit, which moves the signature and, if the content
        really differs, triggers a rewrite."""
        from gpu_feature_discovery_tpu_torch.utils.faults import maybe_inject

        maybe_inject("write")
        if not path:
            self.write_to(sys.stdout)
            obs_metrics.LABEL_WRITES.inc()
            obs_metrics.LABELS_PUBLISHED.set(len(self))
            return
        buf = io.StringIO()
        self.write_to(buf)
        contents = buf.getvalue().encode()
        abs_path = os.path.abspath(path)
        if _write_cache_matches(abs_path, contents):
            obs_metrics.LABEL_WRITE_SKIPS.inc()
            return
        # The signature is taken BEFORE the verifying read: an edit that
        # lands after it moves the file off the cached signature.
        pre_sig = _stat_signature(abs_path)
        if pre_sig is not None and _file_contents_equal(abs_path, contents):
            _write_cache_put(abs_path, contents, pre_sig)
            obs_metrics.LABEL_WRITE_SKIPS.inc()
            return
        sig = _write_file_atomically(path, contents, OUTPUT_MODE)
        _write_cache_put(abs_path, contents, sig)
        obs_metrics.LABEL_WRITES.inc()
        obs_metrics.LABEL_FILE_BYTES.set(len(contents))
        obs_metrics.LABELS_PUBLISHED.set(len(self))


# Last bytes this process wrote (or verified on disk) per absolute path,
# with a stat signature that provably describes those bytes.
_write_cache: Dict[str, "tuple[bytes, tuple]"] = {}
_write_cache_lock = threading.Lock()


def _stat_signature(path: str) -> Optional[tuple]:
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (st.st_mtime_ns, st.st_size, st.st_ino)


def _write_cache_matches(abs_path: str, contents: bytes) -> bool:
    with _write_cache_lock:
        cached = _write_cache.get(abs_path)
    if cached is None or cached[0] != contents:
        return False
    sig = _stat_signature(abs_path)
    return sig is not None and sig == cached[1]


def _write_cache_put(abs_path: str, contents: bytes, sig: Optional[tuple]) -> None:
    # ``sig`` comes from the staged temp file before the rename (rename
    # keeps inode, size and mtime) or from a stat taken before the
    # verifying read — never from a stat after the fact, which an
    # out-of-band writer could have raced.
    with _write_cache_lock:
        if sig is None:
            _write_cache.pop(abs_path, None)
        else:
            _write_cache[abs_path] = (contents, sig)


def _file_contents_equal(path: str, contents: bytes) -> bool:
    """True when ``path`` already holds exactly ``contents``; any read
    failure answers False ("write it")."""
    try:
        with open(path, "rb") as f:
            return f.read() == contents
    except OSError:
        return False


def _write_file_atomically(path: str, contents: bytes, perm: int,
                           fsync_file: str = "labels") -> Optional[tuple]:
    """Stage into ``<dir>/tfd-tmp`` then rename over the target. The
    staging dir lives on the target's filesystem so the rename is atomic;
    the temp file is fsynced before the rename and the directory after, so
    a node crash cannot leave the target naming a truncated inode. Both
    fsyncs count in ``tfd_fsyncs_total{file=fsync_file}``.
    Returns the staged file's stat signature, taken before the rename."""
    abs_path = os.path.abspath(path)
    out_dir = os.path.dirname(abs_path)
    tmp_dir = os.path.join(out_dir, TMP_SUBDIR)
    os.makedirs(tmp_dir, exist_ok=True)

    fd, tmp_name = tempfile.mkstemp(prefix=TMP_PREFIX, dir=tmp_dir)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(contents)
            f.flush()
            fsync_start = time.perf_counter()
            obs_metrics.FSYNCS.labels(file=fsync_file).inc()
            os.fsync(f.fileno())
            obs_metrics.FSYNC_DURATION.observe(time.perf_counter() - fsync_start)
        sig = _stat_signature(tmp_name)
        os.replace(tmp_name, abs_path)
    except BaseException:
        try:
            os.remove(tmp_name)
        except OSError:
            pass
        raise
    os.chmod(abs_path, perm)
    _fsync_dir(out_dir, fsync_file)
    return sig


def _fsync_dir(dir_path: str, fsync_file: str) -> None:
    """Persist a just-completed rename. Best-effort: some filesystems
    refuse a directory fsync, and the write itself already succeeded."""
    try:
        dir_fd = os.open(dir_path, os.O_RDONLY)
    except OSError:
        return
    try:
        obs_metrics.FSYNCS.labels(file=fsync_file).inc()
        os.fsync(dir_fd)
    except OSError:
        pass
    finally:
        os.close(dir_fd)


def remove_output_file(path: str) -> None:
    """Delete the output file and the staging dir. An empty path means
    labels went to stdout and there is nothing to clean up."""
    if not path:
        return
    abs_path = os.path.abspath(path)
    with _write_cache_lock:
        _write_cache.pop(abs_path, None)
    tmp_dir = os.path.join(os.path.dirname(abs_path), TMP_SUBDIR)
    shutil.rmtree(tmp_dir, ignore_errors=True)
    if os.path.exists(abs_path):
        os.remove(abs_path)
