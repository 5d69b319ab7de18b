"""Engine: milliseconds of a price's first half, ``fit`` (the pilot and
the LSM fit), on the host's clock with the device synchronized at the
half's end, outside the profiler; the mean over the traced run's split
prices."""


def read(run):
    spans = (run.halves or {}).get("fit")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
