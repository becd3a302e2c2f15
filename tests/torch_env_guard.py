"""An autouse fixture for the port's test files that run a daemon, the
port's or the twin's, in this process.

Each run exports its resolved ``--compilation-cache-dir`` into
``os.environ`` (``TFD_RESOLVED_COMPILATION_CACHE_DIR``, one name in both
packages) for the children it starts. A value left there reaches every
later test of the same pytest worker: the twin's ``tests/test_ops.py``
compilation-cache tests read it and fail. Each test gets the variable
back as it found it."""

import os

import pytest

RESOLVED_CACHE_DIR_ENV = "TFD_RESOLVED_COMPILATION_CACHE_DIR"


@pytest.fixture(autouse=True)
def resolved_cache_dir_restored():
    saved = os.environ.get(RESOLVED_CACHE_DIR_ENV)
    yield
    if saved is None:
        os.environ.pop(RESOLVED_CACHE_DIR_ENV, None)
    else:
        os.environ[RESOLVED_CACHE_DIR_ENV] = saved
