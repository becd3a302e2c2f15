"""Build and version metadata (twin:
``gpu_feature_discovery_tpu/info/version.py``).

Reference: internal/info/version.go:22-43, version and git commit
injected at link time. Python has no link step, so ``make stamp-torch``
(info/stamp.py) writes ``info/_build_info.py`` (git-ignored) before an
artifact is cut, and a stamped artifact reports its provenance whatever
its environment says. An unstamped checkout falls back to the
``TFD_VERSION``/``TFD_GIT_COMMIT`` environment variables, then to the
defaults. Importing this module imports nothing else of the package, so
``--version`` answers without torch.
"""

import os

DEFAULT_VERSION = "0.1.0"

try:  # The build stamp wins: a released artifact's provenance is fixed.
    from gpu_feature_discovery_tpu_torch.info._build_info import (  # type: ignore
        GIT_COMMIT,
        VERSION,
    )
except ImportError:
    VERSION = os.environ.get("TFD_VERSION", DEFAULT_VERSION)
    GIT_COMMIT = os.environ.get("TFD_GIT_COMMIT", "")


def get_version_string() -> str:
    """The version string as the reference's GetVersionString() forms it."""
    if GIT_COMMIT:
        return f"{VERSION}-{GIT_COMMIT}"
    return VERSION
