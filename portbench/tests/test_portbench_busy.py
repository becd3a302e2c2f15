"""The busy traffic on the CPU: the tenant's sequencing around the daemon,
the label file's writes as the harness stamps them, and the busy phase's
readers, each with nothing to read where a run had no tenant."""

import json
import os
import subprocess
import sys
import time

import pytest

import catalog
import cell
import seams

ROOT = catalog.HERE.parent


def _run(**kw):
    return cell.Run(cell={"name": "x1-broker.busy", "chips": 1},
                    config=catalog.config("h100x1-daemonset"), **kw)


SPAN = 'tfd_span_duration_seconds_{}{{span="{}"}}'


def test_busy_rpc_ms_is_the_health_rpcs_mean_over_the_busy_phases_edges():
    metric, span = "busy_rpc_ms", "broker.rpc.health"
    start = {SPAN.format("sum", span): 1.0, SPAN.format("count", span): 10.0,
             SPAN.format("sum", "other"): 5.0, SPAN.format("count", "other"): 1.0}
    end = {SPAN.format("sum", span): 1.0 + 20 * 0.0425, SPAN.format("count", span): 30.0,
           SPAN.format("sum", "other"): 50.0, SPAN.format("count", "other"): 9.0}
    # The window's edges are another phase's: they move nothing here.
    run = _run(busy_scrapes=[start, end], scrape_start=end, scrape_end=start)
    assert catalog.reader(metric)(run) == pytest.approx(42.5)
    assert catalog.reader(metric)(_run()) is None
    assert catalog.reader(metric)(_run(busy_scrapes=[start, start])) is None


def test_busy_cycle_ms_is_the_busy_phases_wall_time_over_its_cycles():
    run = _run(busy_stamps=[2.0, 2.05, 2.2, 2.3], stamps=[5.0, 5.01])
    assert catalog.reader("busy_cycle_ms")(run) == pytest.approx(100.0)
    assert catalog.reader("busy_cycle_ms")(_run(busy_stamps=[2.0])) is None


def test_busy_mib_held_is_the_fullest_cards_rise_over_the_tenant():
    run = _run(used_base=[1 << 30, 1 << 30], used_tenant=[80 << 30, 79 << 30],
               busy_used=[[(80 << 30) + (600 << 20), (79 << 30) + (700 << 20)]])
    assert catalog.reader("busy_mib_held")(run) == 700.0
    assert catalog.reader("busy_mib_held")(_run(used_base=[1 << 30])) is None


MIB = 1 << 20


def test_busy_mib_held_skips_an_attempt_in_flight_at_the_last_heartbeats():
    # 750 MiB kept; two of the last five readings caught the next attempt's
    # 40 MiB of inputs.
    used = [[(1000 + 750 + extra) * MIB] for extra in (0, 0, 40, 0, 40, 0, 0, 40)]
    run = _run(used_tenant=[1000 * MIB], busy_used=used)
    assert catalog.reader("busy_mib_held")(run) == 750.0


def test_busy_mib_held_shows_memory_kept_by_every_failed_attempt():
    # 16 MiB more after each of 21 attempts: the last five readings hold
    # 17 attempts' worth at the least, where the least of all would read 16.
    used = [[(1000 + 750 + 16 * (i + 1)) * MIB] for i in range(21)]
    run = _run(used_tenant=[1000 * MIB], busy_used=used)
    assert catalog.reader("busy_mib_held")(run) == 750.0 + 16 * 17


def test_recover_s_is_the_runs_own_reading():
    assert catalog.reader("recover_s")(_run(recover_s=1.75)) == 1.75
    assert catalog.reader("recover_s")(_run()) is None


def _write_atomically(directory, name, text):
    staged = os.path.join(directory, "tfd-tmp", name)
    with open(staged, "w") as f:
        f.write(text)
    os.replace(staged, os.path.join(directory, name))


def test_the_label_watch_stamps_each_write_and_what_it_carried(tmp_path):
    (tmp_path / "tfd-tmp").mkdir()
    key = "nvidia.com/gpu.health.ok"
    watch = seams.LabelWatch(str(tmp_path), "tfd", key)
    try:
        _write_atomically(str(tmp_path), "tfd", "nvidia.com/gpu.count=1\n")
        first = watch.next_after(0.0, 10)
        (tmp_path / "other").write_text(f"{key}=true\n")
        t = time.monotonic()
        with pytest.raises(TimeoutError):
            watch.first_carrying_after(0.0, 0.2)
        _write_atomically(str(tmp_path), "tfd", f"nvidia.com/gpu.count=1\n{key}=true\n")
        hit = watch.first_carrying_after(0.0, 10)
        assert first < t < hit
        assert watch.first_carrying_after(first, 1) == hit
        with pytest.raises(TimeoutError):
            watch.first_carrying_after(hit, 0.2)
        assert watch.count() == 2
    finally:
        watch.close()


def test_the_tenant_holds_nothing_and_prints_nothing_without_a_card():
    out = subprocess.run([sys.executable, str(catalog.HERE / "tenant.py"), "--margin-mib", "1157"],
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 2 and out.stdout == ""


FAKE_TENANT = r"""
import json, os, sys, time
log = sys.argv[1]
def note(**kw):
    with open(log, "a") as f:
        f.write(json.dumps(dict(kw, t=time.monotonic())) + "\n")
note(event="start", pythonpath=os.environ.get("PYTHONPATH"),
     scrubbed=not any(k.startswith(("TFD_", "PORTBENCH_")) for k in os.environ))
if sys.argv[2] == "die":
    sys.exit(3)
print(json.dumps({"pid": os.getpid(), "held_bytes": [0], "free_bytes": [0], "total_bytes": [0],
                  "forbidden_modules": sys.argv[2:] if sys.argv[2] == "jax" else []}), flush=True)
note(event="release", line=sys.stdin.readline())
print(json.dumps({"released": True}), flush=True)
"""


@pytest.fixture
def fake_tenant(tmp_path, monkeypatch):
    log = tmp_path / "tenant.log"

    def use(mode="hold"):
        monkeypatch.setattr(cell, "tenant_command",
                            lambda margin: [sys.executable, "-c", FAKE_TENANT, str(log), mode])
        return log

    return use


def _events(log):
    return [json.loads(line) for line in log.read_text().splitlines()]


@pytest.mark.parametrize("mode, match", [("die", "no report"), ("jax", "held")])
def test_a_tenant_without_a_clean_report_leaves_no_run(fake_tenant, mode, match):
    fake_tenant(mode)
    with pytest.raises(cell.RunError, match=match):
        cell.start_tenant(ROOT, {"margin_mib": 1157})


def test_a_busy_run_sequences_the_tenant_around_the_daemon(fake_tenant, monkeypatch):
    """On the CPU, with a tenant that holds nothing: the tenant is up
    before the daemon's first cycle, the busy phase counts its heartbeats
    from the broker worker's start with the label file read at each, the
    release comes after them, the recovery after the release, and the
    window after both; no process outlives the run."""
    log = fake_tenant()
    monkeypatch.setenv("TFD_BACKENDS", "leaked")
    config = catalog.config("h100x1-daemonset")
    config["env"].update({"TFD_BACKENDS": "mock-gpu:1", "TFD_BURNIN_ALLOW_CPU": "1",
                          "TFD_BURNIN_GEOMETRY": "64x1"})
    mix = catalog.traffic("busy")
    bench = catalog.load_benchmark(ROOT)
    run = cell.run_cell(ROOT, catalog.workload(bench, "x1-broker.busy"), config, mix, 1.0,
                        False, "cpu")
    start, release = _events(log)
    assert start["event"] == "start" and start["pythonpath"] is None and start["scrubbed"]
    assert release["line"] == "release\n"
    assert run.busy_scrapes[0]["tfd_broker_up"] == 1.0
    assert len(run.busy_labels) >= 1 and len(run.busy_stamps) >= mix["tenant"]["busy_cycles"]
    assert all(labels["nvidia.com/gpu.count"] == "1" for labels in run.busy_labels)
    assert start["t"] < run.all_stamps[0] <= run.busy_stamps[0]
    assert run.busy_stamps[-1] < release["t"] <= run.release_t
    assert run.recover_s > 0 and run.release_t + run.recover_s < run.stamps[0]
    assert run.cycles > 10 and run.tenant["held_bytes"] == [0]
    assert catalog.reader("busy_cycle_ms")(run) > 0
    assert catalog.reader("busy_rpc_ms")(run) > 0
    # Every CPU probe reads healthy: the busy check counts its verdicts.
    checks = cell.judge(run, {"stream_sum": 0.0, "burnin": []}, None)
    assert checks["busy_health_labels"]["value"] > 0
    assert not os.path.exists(f"/proc/{run.tenant['pid']}")
