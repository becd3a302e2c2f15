"""The twin's supervision primitives (``tests/test_retry_faults.py``) held
against the port: ``utils/retry.py`` ``BackoffPolicy`` and
``utils/faults.py``'s spec parser and countdowns. Each case feeds the
twin and the port the same input (seeded generators for the jitter) and
wants the same delays, the same accept/reject and the same shots, exactly:
both sides compute the delay with the same float operations in the same
order, so no tolerance is needed."""

import random

import numpy as np
import pytest

from gpu_feature_discovery_tpu.config.spec import ConfigError as TwinConfigError
from gpu_feature_discovery_tpu.resource.types import ResourceError as TwinResourceError
from gpu_feature_discovery_tpu.utils import faults as twin_faults
from gpu_feature_discovery_tpu.utils.retry import BackoffPolicy as TwinBackoff
from gpu_feature_discovery_tpu_torch.config.spec import ConfigError as PortConfigError
from gpu_feature_discovery_tpu_torch.resource.types import ResourceError as PortResourceError
from gpu_feature_discovery_tpu_torch.utils import faults as port_faults
from gpu_feature_discovery_tpu_torch.utils.retry import BackoffPolicy as PortBackoff

FAULTS = {"twin": twin_faults, "port": port_faults}
CONFIG_ERRORS = {"twin": TwinConfigError, "port": PortConfigError}
RESOURCE_ERRORS = {"twin": TwinResourceError, "port": PortResourceError}


@pytest.fixture(autouse=True)
def _clean_registries():
    for f in FAULTS.values():
        f.reset()
    yield
    for f in FAULTS.values():
        f.reset()


def test_backoff_grows_exponentially_and_caps():
    for cls in (TwinBackoff, PortBackoff):
        p = cls(base=1.0, factor=2.0, cap=10.0, jitter=0.0)
        assert [p.delay(a) for a in range(5)] == [1.0, 2.0, 4.0, 8.0, 10.0]
        assert p.delay(1000) == 10.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_backoff_jitter_stays_within_fraction(seed):
    rng = np.random.default_rng(seed)
    base, jitter = float(rng.uniform(0.5, 8.0)), float(rng.uniform(0.0, 0.5))
    delays = {}
    for name, cls in (("twin", TwinBackoff), ("port", PortBackoff)):
        p = cls(base=base, factor=1.0, cap=base, jitter=jitter, rng=random.Random(seed))
        delays[name] = [p.delay(a) for a in range(50)]
    assert delays["port"] == delays["twin"]
    assert all(base * (1 - jitter) <= d <= base * (1 + jitter) for d in delays["port"])


def test_backoff_rejects_negative_attempt():
    for cls in (TwinBackoff, PortBackoff):
        with pytest.raises(ValueError):
            cls().delay(-1)


def test_backoff_rng_is_injectable_and_deterministic():
    pinned = [1.027885359692, 1.810004302089, 3.820023454695, 7.557137181038,
              16.756707885325]
    for cls in (TwinBackoff, PortBackoff):
        for _ in range(2):
            p = cls(base=1.0, factor=2.0, cap=30.0, jitter=0.1, rng=random.Random(42))
            assert [round(p.delay(a), 12) for a in range(5)] == pinned


def test_backoff_policies_do_not_share_rng_state():
    for cls in (TwinBackoff, PortBackoff):
        a, b = cls(rng=random.Random(7)), cls(rng=random.Random(7))
        seq_b = [b.delay(i) for i in range(3)]
        for _ in range(10):
            a.delay(3)
        c = cls(rng=random.Random(7))
        assert [c.delay(i) for i in range(3)] == seq_b
        assert cls().rng is not cls().rng


def test_parse_fail_and_raise_entries():
    spec = "pjrt_init:fail:3,write:raise:OSError,generate:raise:RuntimeError:2"
    sites = {name: set(f.parse_fault_spec(spec).sites) for name, f in FAULTS.items()}
    assert sites["port"] == sites["twin"] == {"pjrt_init", "write", "generate"}


@pytest.mark.parametrize("bad", [
    "pjrt_init",
    "pjrt_init:explode:1",
    "pjrt_init:fail",
    "pjrt_init:fail:zero",
    "pjrt_init:fail:0",
    "write:raise:SystemExit",
    ":fail:1",
    "a:fail:1,a:fail:2",
])
def test_malformed_specs_fail_loudly(bad):
    for name, f in FAULTS.items():
        with pytest.raises(CONFIG_ERRORS[name]):
            f.parse_fault_spec(bad)


def test_fail_mode_counts_down_then_disarms():
    for f in FAULTS.values():
        f.load_fault_spec("s:fail:2")
        for _ in range(2):
            with pytest.raises(f.FaultInjected):
                f.maybe_inject("s")
        f.maybe_inject("s")
        f.maybe_inject("other-site")


def test_raise_mode_uses_named_exception_type():
    for name, f in FAULTS.items():
        f.load_fault_spec("w:raise:OSError,r:raise:ResourceError")
        with pytest.raises(OSError):
            f.maybe_inject("w")
        with pytest.raises(RESOURCE_ERRORS[name]):
            f.maybe_inject("r")
        f.maybe_inject("w")
        f.maybe_inject("r")


def test_consume_counts_down_without_raising():
    shots = {}
    for name, f in FAULTS.items():
        f.load_fault_spec("probe.hang:fail:2,probe.segv:raise:OSError")
        shots[name] = [f.consume("probe.hang") for _ in range(3)] + [
            f.consume("probe.segv") for _ in range(2)] + [f.consume("never-armed")]
    assert shots["port"] == shots["twin"] == [True, True, False, True, False, False]


def test_consume_and_fire_share_the_countdown():
    for f in FAULTS.values():
        f.load_fault_spec("site:fail:2")
        assert f.consume("site") is True
        with pytest.raises(f.FaultInjected):
            f.maybe_inject("site")
        assert f.consume("site") is False


def test_consume_loads_lazily_from_environment(monkeypatch):
    assert port_faults.FAULT_SPEC_ENV == twin_faults.FAULT_SPEC_ENV
    monkeypatch.setenv(port_faults.FAULT_SPEC_ENV, "probe.hang:fail:1")
    for f in FAULTS.values():
        f.reset()
        assert f.consume("probe.hang") is True
        assert f.consume("probe.hang") is False


def test_registry_loads_lazily_from_environment(monkeypatch):
    for f in FAULTS.values():
        monkeypatch.setenv(f.FAULT_SPEC_ENV, "envsite:fail:1")
        f.reset()
        with pytest.raises(f.FaultInjected):
            f.maybe_inject("envsite")
        f.maybe_inject("envsite")
        f.reset()
        monkeypatch.delenv(f.FAULT_SPEC_ENV)
        f.maybe_inject("envsite")
