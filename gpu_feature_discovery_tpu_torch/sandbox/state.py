"""Persisted last-good label state, ``--state-dir`` (twin:
``gpu_feature_discovery_tpu/sandbox/state.py``).

Without it, a daemon restart during a backend outage strips the node: the
exiting daemon removes its output file, and the new epoch has nothing to
publish until the first successful init. With a state dir, every clean
full cycle persists its label set atomically; the next epoch re-serves it
on its very first write, marked ``nvidia.com/gpu.tfd.restored=true``
until a live cycle replaces it.

The document is the twin's versioned JSON (``{"version": 1,
"saved_unix": ..., "labels": {...}}``), so either package loads the
other's file. It goes through the label file's fsync-before-rename
writer; a truncated or corrupt file loads as "no state" with a warning.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

from gpu_feature_discovery_tpu_torch.lm.labels import Labels, _write_file_atomically

log = logging.getLogger("tfd.sandbox")

STATE_VERSION = 1
STATE_FILENAME = "last-good-labels.json"
STATE_MODE = 0o644


class LabelStateStore:
    """Load/save the last-good label set under one directory. Every
    failure is contained: persistence must never fail a labeling cycle."""

    def __init__(self, state_dir: str):
        self._dir = state_dir
        self._path = os.path.join(state_dir, STATE_FILENAME)
        self._save_warned = False
        self._last_saved: Optional[Dict[str, str]] = None

    @property
    def path(self) -> str:
        return self._path

    def load(self) -> Optional[Labels]:
        """The persisted label set, or None (absent, unreadable, corrupt,
        wrong version, or not a non-empty flat str->str map)."""
        try:
            with open(self._path) as f:
                doc = json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, ValueError) as e:
            log.warning("ignoring unreadable state file %s: %s", self._path, e)
            return None
        if not isinstance(doc, dict) or doc.get("version") != STATE_VERSION:
            log.warning(
                "ignoring state file %s: unsupported document version %r",
                self._path,
                doc.get("version") if isinstance(doc, dict) else None,
            )
            return None
        labels = doc.get("labels")
        if not isinstance(labels, dict) or not labels or not all(
            isinstance(k, str) and isinstance(v, str) for k, v in labels.items()
        ):
            log.warning(
                "ignoring state file %s: labels are not a non-empty "
                "str->str map",
                self._path,
            )
            return None
        return Labels(labels)

    def save(self, labels: Dict[str, str]) -> bool:
        """Persist ``labels`` atomically; False (after a once-per-epoch
        warning) on failure. Callers pass the CLEANED set: status markers
        describe a moment, not the inventory. An unchanged set is not
        rewritten, so ``saved_unix`` records when the content was new."""
        if self._last_saved is not None and dict(labels) == self._last_saved:
            return True
        doc = {
            "version": STATE_VERSION,
            "saved_unix": int(time.time()),
            "labels": dict(labels),
        }
        try:
            os.makedirs(self._dir, exist_ok=True)
            _write_file_atomically(
                self._path, json.dumps(doc, sort_keys=True).encode(), STATE_MODE,
                fsync_file="state",
            )
            self._last_saved = dict(labels)
            return True
        except OSError as e:
            if not self._save_warned:
                self._save_warned = True
                log.warning(
                    "cannot persist label state to %s: %s (restarts will "
                    "start cold)",
                    self._path,
                    e,
                )
            return False
