"""node.firmware_ms: host ms a tick in the program's `firmware.<callback>`
spans, their self time summed over the callbacks (the firmware's own work,
less any program span inside it), over the traced run's window. None where
the program has no such spans."""


def read(trace):
    keys = [k for k in trace.counts
            if k.startswith("span.firmware.") and k.endswith(".self_ns")]
    if not trace.units or not keys:
        return None
    return sum(trace.counts[k] for k in keys) / 1e6 / trace.units
