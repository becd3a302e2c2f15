"""Where the harness meets the running daemon: the heartbeat file's
touches and the label file's writes, read through inotify and stamped on
this process's monotonic clock; the ``/metrics`` exposition, scraped and
parsed; a free port."""

import bisect
import ctypes
import os
import re
import select
import socket
import struct
import threading
import time
import urllib.request
from typing import Dict, List

IN_ATTRIB = 0x00000004
IN_CLOSE_WRITE = 0x00000008
IN_MOVED_TO = 0x00000080
_EVENT = struct.Struct("iIII")


class HeartbeatWatch:
    """Stamps every touch of ``name`` in ``directory`` (``os.utime`` raises
    IN_ATTRIB) on the monotonic clock, from a thread that does nothing
    else. Each touch is one completed labeling cycle of the daemon."""

    MASK = IN_ATTRIB

    def __init__(self, directory: str, name: str):
        libc = ctypes.CDLL(None, use_errno=True)
        self._fd = libc.inotify_init1(os.O_CLOEXEC | os.O_NONBLOCK)
        if self._fd < 0:
            raise OSError(ctypes.get_errno(), "inotify_init1")
        if libc.inotify_add_watch(self._fd, directory.encode(), self.MASK) < 0:
            raise OSError(ctypes.get_errno(), f"inotify_add_watch {directory}")
        self._name = name.encode()
        self._stop_r, self._stop_w = os.pipe()
        self._lock = threading.Lock()
        self._stamps: List[float] = []
        self._thread = threading.Thread(target=self._run, name="heartbeat-watch", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            ready, _, _ = select.select([self._fd, self._stop_r], [], [])
            if self._stop_r in ready:
                return
            now = time.monotonic()
            try:
                data = os.read(self._fd, 1 << 16)
            except BlockingIOError:
                continue
            touches = 0
            pos = 0
            while pos < len(data):
                _wd, mask, _cookie, length = _EVENT.unpack_from(data, pos)
                name = data[pos + _EVENT.size:pos + _EVENT.size + length].rstrip(b"\0")
                pos += _EVENT.size + length
                if mask & self.MASK and name == self._name:
                    touches += 1
            if touches:
                self._seen(now, touches)

    def _seen(self, now: float, touches: int) -> None:
        with self._lock:
            self._stamps.extend([now] * touches)

    def stamps(self) -> List[float]:
        with self._lock:
            return list(self._stamps)

    def count(self) -> int:
        with self._lock:
            return len(self._stamps)

    def next_after(self, t: float, timeout: float) -> float:
        """The first stamp later than ``t``; waits up to ``timeout`` s."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                i = bisect.bisect_right(self._stamps, t)
                if i < len(self._stamps):
                    return self._stamps[i]
            if time.monotonic() > deadline:
                raise TimeoutError("no labeling cycle completed")
            time.sleep(0.0005)

    def close(self) -> None:
        os.write(self._stop_w, b"x")
        self._thread.join(5)
        for fd in (self._fd, self._stop_r, self._stop_w):
            os.close(fd)


class LabelWatch(HeartbeatWatch):
    """Stamps every write of the label file ``name`` in ``directory`` (the
    daemon renames a staged file into place) and reads the file as each
    is seen: whether it then carried the label ``key``."""

    MASK = IN_MOVED_TO | IN_CLOSE_WRITE

    def __init__(self, directory: str, name: str, key: str):
        self._path = os.path.join(directory, name)
        self._key = key + "="
        self._carried: List[bool] = []
        super().__init__(directory, name)

    def _seen(self, now: float, touches: int) -> None:
        try:
            with open(self._path) as f:
                carried = self._key in f.read()
        except OSError:
            carried = False
        with self._lock:
            self._stamps.append(now)
            self._carried.append(carried)

    def first_carrying_after(self, t: float, timeout: float) -> float:
        """The first write later than ``t`` whose file carried the key;
        waits up to ``timeout`` s."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                i = bisect.bisect_right(self._stamps, t)
                hit = next((s for s, c in zip(self._stamps[i:], self._carried[i:]) if c), None)
            if hit is not None:
                return hit
            if time.monotonic() > deadline:
                raise TimeoutError(f"no label write carried {self._key!r}")
            time.sleep(0.0005)


_SAMPLE = re.compile(r"^([A-Za-z_:][A-Za-z0-9_:]*(?:\{[^}]*\})?)\s+(\S+)")


def parse_exposition(text: str) -> Dict[str, float]:
    """``name{labels}`` -> value for every sample line."""
    out = {}
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        if m:
            try:
                out[m.group(1)] = float(m.group(2))
            except ValueError:
                pass
    return out


def scrape(port: int, timeout: float = 10.0) -> Dict[str, float]:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=timeout) as resp:
        return parse_exposition(resp.read().decode())


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
