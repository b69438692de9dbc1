"""node.runtime_self_ms: host ms a tick in the program's `runtime.process`
spans less their child spans (the stages and the firmware callbacks): the
runtime's own bookkeeping, which node.host_ms only infers, over the traced
run's window. None where the program has no such span."""

KEY = "span.runtime.process.self_ns"


def read(trace):
    if not trace.units or KEY not in trace.counts:
        return None
    return trace.counts[KEY] / 1e6 / trace.units
