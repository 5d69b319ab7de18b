"""LSM fit: device kernels a price's fit launches (the pilot's path kernel
and every operator of the backward induction), counted from the
profiler's trace inside each fit span; the largest count over the traced
prices, since a record the profiler drops can only lower one."""

from gpubench import trace


def read(run):
    counts = [len(trace.inside(run.trace.kernels, [s]))
              for s in run.trace.spans["gpubench.fit"]]
    if not counts or max(counts) == 0:
        return None
    return max(counts)
