"""Static analysis of the PyTorch/CUDA port and chip_smoke.py: the
undefined-name and unused-local checks of tests/staticcheck.py, which
test_lint.py runs over the JAX package and the tests
(``python tests/staticcheck.py gpu_feature_discovery_tpu_torch
chip_smoke.py`` from the command line)."""

import os

import pytest

import staticcheck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGETS = ("gpu_feature_discovery_tpu_torch", "chip_smoke.py")
CHECKS = {
    "undefined-names": staticcheck.check_undefined_names,
    "unused-locals": staticcheck.check_unused_locals,
}


@pytest.mark.parametrize("check", sorted(CHECKS))
def test_port_is_clean(check):
    files = [p for p in staticcheck._python_files(TARGETS) if "__pycache__" not in p]
    assert os.path.join(REPO, "chip_smoke.py") in files
    assert len(files) > 80, "the port's modules were not found"
    offenders = [f"{os.path.relpath(path, REPO)}:{lineno}: {msg}"
                 for path in files for lineno, msg in CHECKS[check](path)]
    assert not offenders, f"{check}:\n" + "\n".join(offenders)
