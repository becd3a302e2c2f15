"""What an embedder of the port brings, importable by name in a fresh
interpreter: backend builders for ``registry.register`` (a probe child
or broker worker re-registers them from the parent's first frame) and
functions for ``sandbox.SandboxedCall``. Tests put this directory on the
child's ``PYTHONPATH``."""

import os
import time


def build_mock_gpu(config, token):
    from gpu_feature_discovery_tpu_torch.resource.cuda_backend import StaticCudaManager

    return StaticCudaManager.mock_gpu(3)


def build_pid_reporting_gpu(config, token):
    """One mock device named after the process that built it."""
    from gpu_feature_discovery_tpu_torch.resource.cuda_backend import StaticCudaManager

    return StaticCudaManager(f"pid-{os.getpid()}", 1, memory_mb=1024)


def answer():
    return {"pid": os.getpid(), "answer": 42}


def fail():
    raise RuntimeError("the function failed in its child")


def sleep_forever():
    time.sleep(3600)
    return {}


def sleep_a_minute():
    time.sleep(60)
    return {}
