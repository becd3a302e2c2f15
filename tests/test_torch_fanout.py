"""The twin's fan-out tier (``tests/test_fanout.py``) held against the port:
``utils/fanout.py`` ``BoundedPool``/``Budget``/``ErrorSink`` and the
registry's concurrent per-family acquisition (``BackendSet.acquire_all``)
over providers an embedder registers through ``registry.register``. The
pool cases run the same tasks through the twin's pool and the port's and
want the same order, results and errors; the acquisition cases register
the twin's test providers in both registries.

The registry seam itself is held here too: ``providers()`` in
registration order, ``register`` replacing a provider of the same name,
``resolved_backends_value`` as the twin's, and a provider registered in
this process reaching a probe child and a broker worker, which are fresh
interpreters where the twin's are forks."""

import os
import threading
import time
from pathlib import Path

import pytest

from gpu_feature_discovery_tpu.config import new_config as twin_new_config
from gpu_feature_discovery_tpu.resource import registry as twin_registry
from gpu_feature_discovery_tpu.utils import fanout as twin_fanout
from gpu_feature_discovery_tpu_torch.config import new_config
from gpu_feature_discovery_tpu_torch.resource import registry
from gpu_feature_discovery_tpu_torch.resource.cpu_backend import StaticCpuManager
from gpu_feature_discovery_tpu_torch.resource.cuda_backend import StaticCudaManager
from gpu_feature_discovery_tpu_torch.utils import fanout
from gpu_feature_discovery_tpu_torch.utils.fanout import BoundedPool, ErrorSink

HERE = Path(__file__).parent
FANOUTS = {"twin": twin_fanout, "port": fanout}


def test_width_one_runs_inline_in_order_with_no_pool():
    for mod in FANOUTS.values():
        pool = mod.BoundedPool(1)
        assert pool.pool is None
        order = []
        pool.run([lambda i=i: order.append(i) for i in range(5)])
        assert order == [0, 1, 2, 3, 4]
        ran_on = []
        pool.run([lambda: ran_on.append(threading.current_thread())])
        assert ran_on == [threading.current_thread()]
        pool.shutdown()


def test_bounded_width_overlaps_but_never_exceeds_the_cap():
    pool = BoundedPool(3, name="t-fanout")
    in_flight, peak = [], []
    lock = threading.Lock()

    def task():
        with lock:
            in_flight.append(1)
            peak.append(len(in_flight))
        time.sleep(0.05)
        with lock:
            in_flight.pop()

    started = time.perf_counter()
    pool.run([task] * 9)
    elapsed = time.perf_counter() - started
    pool.shutdown()
    assert max(peak) <= 3
    # 9 x 0.05 s at width 3 is about 3 waves, far under the 0.45 s serial
    # cost: the twin's bound.
    assert elapsed < 0.4, elapsed


def test_run_blocks_until_every_task_finished():
    for mod in FANOUTS.values():
        pool = mod.BoundedPool(4)
        done = []

        def task(i):
            time.sleep(0.01 * (4 - i % 4))
            done.append(i)

        pool.run([lambda i=i: task(i) for i in range(8)])
        assert sorted(done) == list(range(8))
        pool.shutdown()


def test_task_exception_propagates_like_the_inline_loop():
    for mod in FANOUTS.values():
        for width in (2, 1):
            pool = mod.BoundedPool(width)
            with pytest.raises(RuntimeError, match="boom"):
                pool.run([lambda: (_ for _ in ()).throw(RuntimeError("boom"))])
            pool.shutdown()


def test_budget_remaining_and_spent():
    readings = {}
    for name, mod in FANOUTS.items():
        clock = [100.0]
        budget = mod.Budget(2.0, clock=lambda: clock[0])
        seen = [budget.remaining(), budget.spent(grace=0.05)]
        clock[0] += 1.9
        seen += [budget.remaining(), budget.spent(grace=0.05)]
        clock[0] += 0.2
        seen += [budget.spent()]
        unbounded = mod.Budget(None, clock=lambda: clock[0])
        seen += [unbounded.remaining(), unbounded.spent(grace=1e9)]
        readings[name] = seen
    # The same float operations in the same order: equal bit for bit.
    assert readings["port"] == readings["twin"]
    assert readings["port"][0] == pytest.approx(2.0)
    assert readings["port"][2] == pytest.approx(0.1)
    assert readings["port"][1:2] + readings["port"][3:] == [False, False, True, None, False]


def test_error_sink_collects_across_threads():
    sink = ErrorSink()
    threads = [threading.Thread(target=sink.put, args=(i, ValueError(str(i))))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert set(sink.errors) == set(range(8))


# ---------------------------------------------------------------------------
# the registry's per-family acquisition over registered providers
# ---------------------------------------------------------------------------

@pytest.fixture
def registered_for_test():
    """Registers under test-only tokens in both registries; drops them
    after."""
    added = []

    def add(reg, name, family, build):
        reg.register(reg.BackendProvider(name, family, build))
        added.append((reg, name))

    yield add
    for reg, name in added:
        reg._PROVIDERS.pop(name, None)


def _backend_sets(add, gpu_build, cpu_build, clock=time.monotonic):
    add(registry, "slow-test-gpu", registry.FAMILY_GPU, gpu_build)
    add(registry, "slow-test-cpu", registry.FAMILY_CPU, cpu_build)
    config = new_config(cli_values={"probe-isolation": "none"}, environ={})
    return registry.BackendSet(["slow-test-gpu", "slow-test-cpu"], config, clock=clock)


def _mock_gpu(config, token):
    return StaticCudaManager.mock_gpu(1)


def _mock_cpu(config, token):
    return StaticCpuManager.mock_cpu(1)


def _broken(message):
    def build(config, token):
        raise RuntimeError(message)
    return build


def test_acquire_all_overlaps_slow_family_inits(registered_for_test):
    delay = 0.3

    def slow(build):
        def wrapped(config, token):
            time.sleep(delay)
            return build(config, token)
        return wrapped

    bs = _backend_sets(registered_for_test, slow(_mock_gpu), slow(_mock_cpu))
    try:
        started = time.perf_counter()
        bs.acquire_all()
        elapsed = time.perf_counter() - started
        assert all(rt.manager is not None for rt in bs.runtimes)
        # The twin's bound: sequential is >= 0.6 s, concurrent about 0.3 s.
        assert elapsed < 2 * delay - 0.1, f"acquisitions serialized: {elapsed:.3f}s"
        started = time.perf_counter()
        bs.acquire_all()
        assert time.perf_counter() - started < 0.05
    finally:
        bs.release_all()


def test_acquire_all_strict_raises_first_failure_in_flag_order(registered_for_test):
    bs = _backend_sets(registered_for_test, _broken("gpu init exploded"),
                       _broken("cpu init exploded"))
    try:
        with pytest.raises(RuntimeError, match="gpu init exploded"):
            bs.acquire_all(strict=True)
    finally:
        bs.release_all()


def test_acquire_all_nonstrict_contains_failures_per_family(registered_for_test):
    bs = _backend_sets(registered_for_test, _broken("gpu init exploded"), _mock_cpu)
    try:
        bs.acquire_all()
        gpu_rt = next(rt for rt in bs.runtimes if rt.family == "gpu")
        cpu_rt = next(rt for rt in bs.runtimes if rt.family == "cpu")
        assert gpu_rt.manager is None and gpu_rt.down
        assert cpu_rt.manager is not None
    finally:
        bs.release_all()


def test_acquire_all_skips_pool_while_backoff_windows_are_closed(registered_for_test, monkeypatch):
    clock = [0.0]
    bs = _backend_sets(registered_for_test, _broken("down"), _broken("down"),
                       clock=lambda: clock[0])
    try:
        bs.acquire_all()
        assert all(rt.down for rt in bs.runtimes)
        assert not any(rt.attempt_due() for rt in bs.runtimes)
        constructed = []
        original = fanout.BoundedPool.__init__

        def counting_init(self, *args, **kwargs):
            constructed.append(1)
            return original(self, *args, **kwargs)

        monkeypatch.setattr(fanout.BoundedPool, "__init__", counting_init)
        for _ in range(5):
            bs.acquire_all()
        assert not constructed, "pool churned on closed backoff windows"
        assert all(rt.failures == 1 for rt in bs.runtimes)
        clock[0] += 1000.0
        bs.acquire_all()
        assert all(rt.failures == 2 for rt in bs.runtimes)
    finally:
        bs.release_all()


# ---------------------------------------------------------------------------
# the registry seam
# ---------------------------------------------------------------------------

def test_providers_in_registration_order_as_the_twins(registered_for_test):
    twin_names = [p.name for p in twin_registry.providers()]
    port_names = [p.name for p in registry.providers()]
    assert port_names == registry.backend_spec_tokens()
    # The in-tree order is documentation order; a longer prefix before
    # the shorter one it would shadow (the twin's rule).
    assert port_names.index("mock-gpu") < port_names.index("mock-cpu")
    registered_for_test(registry, "embedded-gpu", registry.FAMILY_GPU, _mock_gpu)
    registered_for_test(twin_registry, "embedded-gpu", twin_registry.FAMILY_GPU, _mock_gpu)
    assert [p.name for p in registry.providers()] == port_names + ["embedded-gpu"]
    assert [p.name for p in twin_registry.providers()] == twin_names + ["embedded-gpu"]
    assert registry.provider_for("EMBEDDED-GPU").build is _mock_gpu


def test_register_replaces_a_provider_of_the_same_name(registered_for_test):
    registered_for_test(registry, "embedded-gpu", registry.FAMILY_GPU, _mock_gpu)
    before = [p.name for p in registry.providers()]
    registered_for_test(registry, "embedded-gpu", registry.FAMILY_GPU, _broken("x"))
    assert [p.name for p in registry.providers()] == before
    with pytest.raises(RuntimeError, match="x"):
        registry.provider_for("embedded-gpu").build(None, "embedded-gpu")


@pytest.mark.parametrize("raw", [None, "auto", "mock-gpu:2,cpu"])
def test_resolved_backends_value_is_the_twins(raw):
    cli = {} if raw is None else {"backends": raw}
    twin_raw = cli.get("backends", "auto").replace("mock-gpu:2", "mock-gpu")
    want = twin_registry.resolved_backends_value(
        twin_new_config(cli_values={"backends": twin_raw} if raw else {}, environ={}))
    got = registry.resolved_backends_value(new_config(cli_values=cli, environ={}))
    assert got == (raw or "auto")
    assert want == (twin_raw if raw else "auto")


@pytest.fixture
def embedder_on_child_path(monkeypatch):
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (str(HERE), os.environ.get("PYTHONPATH")) if p))
    monkeypatch.delenv("TFD_BACKEND", raising=False)


def test_a_registered_provider_reaches_a_probe_child(registered_for_test, embedder_on_child_path):
    """The twin's fork inherits the registry; the port's child is a fresh
    interpreter, told the embedder's providers in its first frame."""
    import torch_embedder
    from gpu_feature_discovery_tpu_torch.sandbox.probe import acquire_snapshot_manager

    registered_for_test(registry, "embedded-gpu", registry.FAMILY_GPU,
                   torch_embedder.build_pid_reporting_gpu)
    config = new_config(cli_values={"backends": "embedded-gpu"}, environ={})
    manager = acquire_snapshot_manager(config, timeout_s=30.0)
    manager.init()
    [chip] = manager.get_chips()
    assert chip.get_name().startswith("pid-")
    assert chip.get_name() != f"pid-{os.getpid()}"


def test_a_registered_provider_reaches_a_broker_worker(registered_for_test, embedder_on_child_path):
    import torch_embedder
    from gpu_feature_discovery_tpu_torch import sandbox

    registered_for_test(registry, "embedded-gpu", registry.FAMILY_GPU, torch_embedder.build_mock_gpu)
    config = new_config(cli_values={"backends": "embedded-gpu", "probe-broker": "on",
                                    "probe-timeout": "30s"}, environ={})
    try:
        manager = sandbox.acquire_broker_manager(config)
        manager.init()
        assert [c.get_name() for c in manager.get_chips()] == ["mock-gpu"] * 3
    finally:
        sandbox.close_broker()


def test_a_provider_a_child_cannot_import_stays_unknown_there(registered_for_test,
                                                               embedder_on_child_path):
    from gpu_feature_discovery_tpu_torch.resource.types import ResourceError
    from gpu_feature_discovery_tpu_torch.sandbox.probe import acquire_snapshot_manager

    registered_for_test(registry, "embedded-gpu", registry.FAMILY_GPU,
                   lambda config, token: StaticCudaManager.mock_gpu(1))
    assert registry.child_provider_docs() == []
    config = new_config(cli_values={"backends": "embedded-gpu"}, environ={})
    with pytest.raises(ResourceError, match="embedded-gpu"):
        acquire_snapshot_manager(config, timeout_s=30.0)
