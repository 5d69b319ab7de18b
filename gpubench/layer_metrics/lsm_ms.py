"""LSM fit: milliseconds the device takes over a price's backward pass,
the device's edges of the program's ``mcop.lsm`` span (from the stream
reaching its start to the last of its operations); the mean over the
traced prices of ``engine_spans`` (the recorder on, no profiler)."""

from gpubench import engine_spans


def read(run):
    return engine_spans.read(run, "prices", "mcop.lsm", "device")
