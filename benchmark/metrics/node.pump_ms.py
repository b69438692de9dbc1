"""node.pump_ms: host ms a tick in the program's `runtime.pump` spans (every
node's resampler front end: the radio's new samples to the card, the 9/10
step, the DECT-rate samples back and into the DECT-rate buffer), over the
traced run's window. None where the program has no such span."""

KEY = "span.runtime.pump.ns"


def read(trace):
    if not trace.units or KEY not in trace.counts:
        return None
    return trace.counts[KEY] / 1e6 / trace.units
