"""Engine: milliseconds of a price's second half, ``price_with_fit`` (the
tables and the priced chunks), on the host's clock from the fit's end to
the answer on the host, outside the profiler; the mean over the traced
run's split prices."""


def read(run):
    spans = (run.halves or {}).get("stream")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
