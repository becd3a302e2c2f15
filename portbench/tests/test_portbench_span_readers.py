"""The span tree's readers: each a mean of its own series over the window's
edges, a count per cycle, or the one spawn's import, and nothing where the
program records no span tree."""

import pytest

import catalog
import cell


def _run(stamps, **kw):
    return cell.Run(cell={"name": "x1-broker.soak", "chips": 1},
                    config=catalog.config("h100x1-daemonset"), stamps=stamps, **kw)


SPAN = "tfd_span_duration_seconds"
GAP = "tfd_probe_gap_seconds"


@pytest.mark.parametrize("metric,key,want", [
    ("cycle_span_ms", SPAN + '_{}{{span="cycle"}}', 13.5),
    ("probe_window_ms", SPAN + '_{}{{span="probe.device"}}', 13.5),
    ("gap_probe_ms", GAP + '_{}{{layer="probe"}}', 13.5),
    ("gap_broker_ms", GAP + '_{}{{layer="broker"}}', 13.5),
    ("gap_labelgen_ms", GAP + '_{}{{layer="labelgen"}}', 13.5),
    ("gap_loop_ms", GAP + '_{}{{layer="loop"}}', 13.5),
])
def test_span_tree_readers_are_means_over_the_windows_edges(metric, key, want):
    """Each reads its own series (another span's or layer's moves it not),
    and nothing where the program records no span tree (the parent)."""
    start = {key.format("sum"): 2.0, key.format("count"): 100.0,
             SPAN + '_sum{span="other"}': 9.0, SPAN + '_count{span="other"}': 1.0}
    end = {key.format("sum"): 2.0 + 0.0135 * 400, key.format("count"): 500.0,
           SPAN + '_sum{span="other"}': 99.0, SPAN + '_count{span="other"}': 2.0}
    run = _run([0.0, 1.0], scrape_start=start, scrape_end=end)
    assert catalog.reader(metric)(run) == pytest.approx(want)
    assert catalog.reader(metric)(_run([0.0, 1.0])) is None
    still = _run([0.0, 1.0], scrape_start=start, scrape_end=start)
    assert catalog.reader(metric)(still) is None


def test_fsyncs_per_cycle_counts_every_file_over_the_windows_cycles():
    start = {'tfd_fsyncs_total{file="labels"}': 10.0, 'tfd_fsyncs_total{file="state"}': 10.0}
    end = {'tfd_fsyncs_total{file="labels"}': 410.0, 'tfd_fsyncs_total{file="state"}': 406.0,
           'tfd_fsyncs_total{file="timings"}': 4.0, "tfd_cycles_total": 5.0}
    run = _run([0.0] + [0.01 * i for i in range(1, 201)], scrape_start=start, scrape_end=end)
    assert catalog.reader("fsyncs_per_cycle")(run) == pytest.approx((400 + 396 + 4) / 200)
    # The parent has no such counter: nothing, not 0.
    assert catalog.reader("fsyncs_per_cycle")(_run([0.0, 1.0], scrape_end={
        "tfd_cycles_total": 5.0})) is None
    assert catalog.reader("fsyncs_per_cycle")(_run([0.0], scrape_end=end)) is None


def test_worker_import_s_is_the_one_spawns_import():
    end = {'tfd_span_duration_seconds_sum{span="worker.import"}': 4.25,
           'tfd_span_duration_seconds_count{span="worker.import"}': 1.0}
    assert catalog.reader("worker_import_s")(_run([0.0, 1.0], scrape_end=end)) == 4.25
    # In process no worker is spawned; the parent records no span.
    assert catalog.reader("worker_import_s")(_run([0.0, 1.0], scrape_end={
        "tfd_probe_duration_seconds_count": 1.0})) is None
