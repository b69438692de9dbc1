"""node.d2h_per_tick: the program's reads of device values a tick (its
counter `xfer.d2h`: each read waits for the device), over the traced run's
window. None where the program has no such counter."""

KEY = "xfer.d2h"


def read(trace):
    if not trace.units or KEY not in trace.counts:
        return None
    return trace.counts[KEY] / trace.units
