"""node.tx_resample_ms: host ms a tick in the program's `runtime.tx_resample`
spans (the 10/9 resampler of every burst a node sends, inside
`runtime.tx`), over the traced run's window. None where the program has no
such span."""

KEY = "span.runtime.tx_resample.ns"


def read(trace):
    if not trace.units or KEY not in trace.counts:
        return None
    return trace.counts[KEY] / 1e6 / trace.units
