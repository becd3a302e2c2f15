"""The benchmark's data: BENCHMARK.json's grammar, and every configuration,
traffic mix and metric found by name from a file of its own."""

import json
import re

import pytest

import catalog

ROOT = catalog.HERE.parent
BENCH = catalog.load_benchmark(ROOT)


def test_names_and_units_keep_the_grammar():
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[section]:
            catalog.check_name(entry["name"])
            if "unit" in entry:
                catalog.check_unit(entry["unit"])
    for w in BENCH["workloads"]:
        catalog.check_name(w["config"])
        catalog.check_name(w["traffic"])
    for c in BENCH["configs"]:
        for key in c["reduced"]:
            catalog.check_name(key)


@pytest.mark.parametrize("bad", ["", "a b", "a/b", "a,b", "-x", "x" * 65, "µs"])
def test_a_bad_name_is_refused(bad):
    with pytest.raises(catalog.CatalogError):
        catalog.check_name(bad)


@pytest.mark.parametrize("bad", ["", "tokens per s", "µs", "x" * 17])
def test_a_bad_unit_is_refused(bad):
    with pytest.raises(catalog.CatalogError):
        catalog.check_unit(bad)


def test_every_entry_resolves_to_its_file():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert catalog.config(c["name"])["probe"]
    for w in BENCH["workloads"]:
        catalog.config(w["config"])
        catalog.traffic(w["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(catalog.reader(m["name"]))


def test_per_layer_metrics_name_a_layer_and_what_they_move():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["layer"] and "\n" not in m["layer"]
        assert set(m.get("workloads", cells)) <= cells
    # Each cell a per-layer metric is reported in reports what it moves.
    for w in cells:
        reported = {m["name"] for m in catalog.metrics_for(BENCH, w, False)}
        assert {m["moves"] for m in catalog.metrics_for(BENCH, w, True)} <= reported, w


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in catalog.metrics_for(BENCH, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert catalog.metrics_for(BENCH, w["name"], True)


def test_a_new_config_traffic_and_metric_are_found_by_name(tmp_path, monkeypatch):
    for kind in ("configs", "traffic", "metrics"):
        (tmp_path / kind).mkdir()
    (tmp_path / "configs" / "h200x1-new.json").write_text(json.dumps({"probe": {"size": 8}}))
    (tmp_path / "traffic" / "cadence.json").write_text(json.dumps({"args": ["--burnin-interval", "10"]}))
    (tmp_path / "metrics" / "write_ms.py").write_text("def read(run):\n    return run * 2\n")
    monkeypatch.setattr(catalog, "HERE", tmp_path)
    assert catalog.config("h200x1-new") == {"probe": {"size": 8}}
    assert catalog.traffic("cadence")["args"][1] == "10"
    assert catalog.reader("write_ms")(21) == 42
    bench = {"end_to_end": [{"name": "setup_s"}, {"name": "rate", "workloads": ["x1-broker.soak"]}],
             "per_layer": [{"name": "write_ms", "workloads": ["x1-broker.cadence"], "moves": "setup_s"},
                           {"name": "all_cells", "moves": "setup_s"},
                           {"name": "rate_cells", "moves": "rate"}]}
    assert [m["name"] for m in catalog.metrics_for(bench, "x1-broker.cadence", True)] == [
        "write_ms", "all_cells"]
    assert [m["name"] for m in catalog.metrics_for(bench, "x1-broker.soak", True)] == [
        "all_cells", "rate_cells"]
    assert [m["name"] for m in catalog.metrics_for(bench, "x1-broker.cadence", False)] == [
        "setup_s"]
    with pytest.raises(catalog.CatalogError):
        catalog.config("absent")


def test_the_command_names_only_files_under_paths():
    assert BENCH["command"][0] == "python3"
    for word in BENCH["command"][1:]:
        assert any(word.startswith(p + "/") for p in BENCH["paths"])
        assert not word.startswith("/") and ".." not in word
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and not p.endswith("_torch")


SOAK_E2E = {"x1-broker.soak": ["probe_card_ms", "card_mib_held", "setup_s"],
            "x1-inproc.soak": ["probe_card_ms", "card_mib_held", "setup_s"],
            "x4-broker.soak": ["probe_card_ms.multi", "card_mib_held", "setup_s"]}
SPANS = ["probe_cycle_ms", "probe_cycle_p95_ms", "host_cpu_ms", "labelgen_ms"]
GAPS = ["cycle_span_ms", "probe_window_ms", "gap_probe_ms"]
SOAK_PER_LAYER = {
    "x1-broker.soak": SPANS + ["broker_rpc_ms", "probe_ms", "burnin_roofline",
                               "hbm_stream_sum_roofline", "device_idle_pct", "worker_ready_s",
                               "prewarm_s"] + GAPS + ["gap_broker_ms", "gap_labelgen_ms",
                                                      "gap_loop_ms", "fsyncs_per_cycle",
                                                      "worker_import_s"],
    "x1-inproc.soak": SPANS + ["probe_ms", "burnin_roofline", "hbm_stream_sum_roofline",
                               "device_idle_pct", "prewarm_s"] + GAPS + [
                                   "gap_labelgen_ms", "gap_loop_ms", "fsyncs_per_cycle"],
    "x4-broker.soak": SPANS + ["broker_rpc_ms", "probe_ms", "worker_ready_s", "prewarm_s"]
    + GAPS + ["gap_broker_ms", "gap_labelgen_ms", "gap_loop_ms", "fsyncs_per_cycle",
              "worker_import_s", "allreduce_roofline", "gate_spin_ms", "collective_card_ms"],
}


@pytest.mark.parametrize("cell", sorted(SOAK_E2E))
def test_the_soak_cells_report_what_they_reported_before_the_busy_cell(cell):
    assert [m["name"] for m in catalog.metrics_for(BENCH, cell, False)] == SOAK_E2E[cell]
    assert [m["name"] for m in catalog.metrics_for(BENCH, cell, True)] == SOAK_PER_LAYER[cell]


def test_the_busy_cell_reports_the_busy_path_and_the_soaks_window():
    e2e = [m["name"] for m in catalog.metrics_for(BENCH, "x1-broker.busy", False)]
    assert e2e == ["probe_card_ms", "card_mib_held", "setup_s", "busy_mib_held"]
    busy = ["busy_rpc_ms", "busy_cycle_ms", "recover_s"]
    per_layer = [m["name"] for m in catalog.metrics_for(BENCH, "x1-broker.busy", True)]
    assert per_layer == SOAK_PER_LAYER["x1-broker.soak"] + busy
    # Each busy metric is reported in the busy cell alone; the busy phase
    # and the verdict's return are part of its set-up.
    for m in BENCH["per_layer"]:
        if m["name"] in busy:
            assert m["workloads"] == ["x1-broker.busy"] and m["moves"] == "setup_s"
    assert catalog.traffic("busy")["tenant"] == {"margin_mib": 1157, "busy_cycles": 20}
