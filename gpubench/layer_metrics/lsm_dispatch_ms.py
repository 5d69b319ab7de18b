"""LSM fit: milliseconds the host takes to enqueue a price's backward
pass, the host's edges of the program's ``mcop.lsm`` span; against
``lsm_ms`` it says whether the device waits on the host.  The mean over
the traced prices of ``engine_spans`` (the recorder on, no profiler)."""

from gpubench import engine_spans


def read(run):
    return engine_spans.read(run, "prices", "mcop.lsm", "host")
