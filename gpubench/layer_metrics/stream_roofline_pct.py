"""Kernels: the least time the card could take for a price's stream
(``roofline.count.stream_least_s``, the frozen count of the work at the
cell's shapes) as a share of the device's busy time inside the stream
spans, in percent."""

from gpubench import trace
from gpubench.roofline import count


def read(run):
    spans = run.trace.spans["gpubench.stream"]
    busy = sum(trace.busy_s(run.trace.device, s.start, s.end) for s in spans)
    if not spans or busy <= 0.0:
        return None
    req = run.request
    least = count.stream_least_s(run.config, req.n_strikes, req.n_chunks,
                                 req.antithetic, req.control_variate)
    return 100.0 * least * len(spans) / busy
