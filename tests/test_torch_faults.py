"""The fault-injection registry of the PyTorch port against its JAX twin.

The same ``TFD_FAULT_SPEC`` strings give the same site/count registries
and the same exception types in both packages, the same bad specs are
refused in both, the chip-fault consume/re-arm sequences agree, and the
sites this port wires (``generate``, ``labeler.<name>``, ``write``,
``pjrt_init``) fire where the twin's do."""

import pytest

from gpu_feature_discovery_tpu.config import new_config as twin_new_config
from gpu_feature_discovery_tpu.config.spec import ConfigError as TwinConfigError
from gpu_feature_discovery_tpu.lm import engine as twin_engine
from gpu_feature_discovery_tpu.lm.labels import Labels as TwinLabels
from gpu_feature_discovery_tpu.utils import faults as twin_faults
from gpu_feature_discovery_tpu_torch.config.flags import new_config
from gpu_feature_discovery_tpu_torch.config.spec import ConfigError
from gpu_feature_discovery_tpu_torch.lm import engine
from gpu_feature_discovery_tpu_torch.lm.labels import Labels
from gpu_feature_discovery_tpu_torch.resource import factory
from gpu_feature_discovery_tpu_torch.utils import faults


@pytest.fixture(autouse=True)
def _clean_registries(monkeypatch):
    monkeypatch.delenv(faults.FAULT_SPEC_ENV, raising=False)
    faults.reset()
    twin_faults.reset()
    yield
    faults.reset()
    twin_faults.reset()


def _registry_view(registry):
    return {
        site: (f.exc_type.__name__, f.remaining)
        for site, f in registry._faults.items()
    }


GOOD_SPECS = [
    "pjrt_init:fail:3,write:raise:OSError,generate:raise:RuntimeError:2",
    "broker.hang:fail:1,broker.crash:fail:2",
    "probe.timeout:fail:1, probe.hang:fail:1 ,probe.segv:fail:1,",
    "chip.0.sick:fail:2,chip.3.slow:fail:1,labeler.health:raise:TimeoutError:4",
    "labeler.device:raise:ResourceError,write:raise:ValueError:1",
    "",
]


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_fault_specs_parse_alike(spec):
    got = faults.parse_fault_spec(spec)
    want = twin_faults.parse_fault_spec(spec)
    assert got.sites == want.sites
    assert _registry_view(got) == _registry_view(want)


BAD_SPECS = [
    "pjrt_init",
    ":fail:1",
    "write:fail",
    "write:fail:1:2",
    "write:raise:SystemExit",
    "write:raise",
    "write:raise:OSError:1:2",
    "write:explode:1",
    "write:fail:zero",
    "write:fail:0",
    "write:fail:1,write:fail:2",
]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_fault_specs_refused_alike(spec):
    with pytest.raises(TwinConfigError):
        twin_faults.parse_fault_spec(spec)
    with pytest.raises(ConfigError):
        faults.parse_fault_spec(spec)


def _countdown_script(mod):
    """maybe_inject / consume outcomes over a fixed call script."""
    mod.load_fault_spec(
        "generate:raise:ValueError:2,probe.hang:fail:1,broker.crash:fail:2"
    )
    out = []
    for site in ["generate", "generate", "generate", "write", "probe.hang"]:
        try:
            mod.maybe_inject(site)
            out.append(None)
        except Exception as e:  # noqa: BLE001 - compared across packages
            out.append(type(e).__name__)
    for site in ["probe.hang", "probe.hang", "broker.crash", "broker.crash",
                 "broker.crash", "broker.hang"]:
        out.append(mod.consume(site))
    out.append(mod.active())
    return out


def test_fire_and_take_countdowns_match_twin():
    got, want = _countdown_script(faults), _countdown_script(twin_faults)
    assert got == want
    assert got[:5] == ["ValueError", "ValueError", None, None, "FaultInjected"]
    assert got[5:] == [False, False, True, True, False, False, True]


def _chip_script(mod):
    mod.load_fault_spec("chip.1.sick:fail:2,chip.0.slow:fail:1,chip.3.sick:fail:1,"
                        "generate:fail:1")
    out = [mod.consume_chip_faults()]
    out.append(mod.consume_chip_faults())
    mod.rearm_chip_faults({1, 3}, {0})
    out.append(mod.consume_chip_faults())
    out.append(mod.consume_chip_faults())
    mod.rearm_chip_faults(frozenset(), frozenset({7}))  # never armed: no-op
    out.append(mod.consume_chip_faults())
    return out


def test_chip_fault_consume_and_rearm_sequences_match_twin():
    got, want = _chip_script(faults), _chip_script(twin_faults)
    assert got == want
    assert got[0] == (frozenset({1, 3}), frozenset({0}))
    assert got[1] == (frozenset({1}), frozenset())
    assert got[2] == (frozenset({1, 3}), frozenset({0}))
    assert got[3] == got[4] == (frozenset(), frozenset())


def test_spec_loads_lazily_from_the_environment(monkeypatch):
    monkeypatch.setenv(faults.FAULT_SPEC_ENV, "write:raise:OSError:1")
    faults.reset()
    assert faults.active()
    with pytest.raises(OSError, match="injected fault at 'write'"):
        faults.maybe_inject("write")
    faults.maybe_inject("write")  # spent
    monkeypatch.setenv(faults.FAULT_SPEC_ENV, "write:nonsense")
    faults.reset()
    with pytest.raises(ConfigError):
        faults.active()


def _engine_outcomes(mod, labels_cls, spec, parallel):
    mod_faults = faults if mod is engine else twin_faults
    mod_faults.load_fault_spec(spec)
    eng = mod.LabelEngine(parallel=parallel, timeout_s=5.0)
    sources = [
        mod.LabelSource("device", lambda: labels_cls({"a": "1"}), offload=False),
        mod.LabelSource("health", lambda: labels_cls({"b": "2"})),
    ]
    out = []
    try:
        for _ in range(3):
            try:
                out.append(dict(eng.generate(sources)))
            except Exception as e:  # noqa: BLE001 - compared across packages
                out.append(type(e).__name__)
    finally:
        eng.close()
    return out


@pytest.mark.parametrize("parallel", [True, False])
@pytest.mark.parametrize("spec", [
    "generate:raise:RuntimeError:1",
    "labeler.health:raise:OSError:2",
    "labeler.device:fail:1",
])
def test_engine_sites_fire_like_twin(spec, parallel):
    got = _engine_outcomes(engine, Labels, spec, parallel)
    want = _engine_outcomes(twin_engine, TwinLabels, spec, parallel)
    assert got == want
    assert isinstance(got[0], str) and got[-1] == {"a": "1", "b": "2"}


def test_write_site_fires_like_twin(tmp_path):
    for mod, labels_cls in ((faults, Labels), (twin_faults, TwinLabels)):
        mod.load_fault_spec("write:raise:OSError:1")
        out = tmp_path / f"tfd-{mod.__name__.split('.')[0]}"
        with pytest.raises(OSError):
            labels_cls({"k": "v"}).write_to_file(str(out))
        assert not out.exists()
        labels_cls({"k": "v"}).write_to_file(str(out))
        assert out.read_text() == "k=v\n"


def test_pjrt_init_fires_on_in_process_acquisition_like_twin(monkeypatch):
    from gpu_feature_discovery_tpu.cmd import main as twin_main

    monkeypatch.setenv("TFD_BACKEND", "mock:v4-8")  # the twin's mock token
    values = {"probe-isolation": "none", "backends": "mock-gpu:2"}
    config = new_config(cli_values=values, environ={})
    twin_config = twin_new_config(
        cli_values={**values, "oneshot": False}, environ={}
    )
    for mod, build in ((faults, lambda: factory.build_manager(config)),
                       (twin_faults, lambda: twin_main._build_manager(twin_config))):
        mod.load_fault_spec("pjrt_init:fail:1")
        with pytest.raises(mod.FaultInjected):
            build()
        build()  # spent: the acquisition succeeds
    # Validation selects without firing the site.
    faults.load_fault_spec("pjrt_init:fail:1")
    assert len(factory.select_manager(config).get_chips()) == 0  # not inited
    with pytest.raises(faults.FaultInjected):
        factory.new_manager(config)
