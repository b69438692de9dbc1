"""node.mimo_ms: host ms a tick in the program's `runtime.mimo` spans (the
codebook search on each PDC's channel estimates, inside `runtime.pdc`),
over the traced run's window. None where the program has no such span."""

KEY = "span.runtime.mimo.ns"


def read(trace):
    if not trace.units or KEY not in trace.counts:
        return None
    return trace.counts[KEY] / 1e6 / trace.units
