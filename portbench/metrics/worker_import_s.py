"""The broker worker's imports at its start (``tfd_span_duration_seconds``
of ``worker.import``: the spawn to torch's and the probe's modules
loaded) at the window's end, over the set-up's one spawn; nothing where
no worker was spawned or the program records no such span."""

KEY = 'tfd_span_duration_seconds_{}{{span="worker.import"}}'


def read(run):
    count = run.scrape_end.get(KEY.format("count"), 0.0)
    if count <= 0:
        return None
    return run.scrape_end[KEY.format("sum")] / count
