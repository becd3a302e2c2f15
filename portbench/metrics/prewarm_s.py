"""The probe's first use (``tfd_first_probe_compile_seconds``: the
worker's pre-warm, or in process the first probe's compile phase)."""


def read(run):
    value = run.scrape_end.get("tfd_first_probe_compile_seconds", 0.0)
    return value if value > 0 else None
