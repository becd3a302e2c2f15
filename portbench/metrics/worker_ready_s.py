"""The broker worker's spawn up to its ready frame
(``tfd_probe_duration_seconds`` at the window's end: the set-up's one
spawn); nothing where no worker was spawned."""


def read(run):
    count = run.scrape_end.get("tfd_probe_duration_seconds_count", 0.0)
    if count <= 0:
        return None
    return run.scrape_end["tfd_probe_duration_seconds_sum"] / count
