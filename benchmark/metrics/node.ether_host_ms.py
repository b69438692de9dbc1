"""node.ether_host_ms: host ms a tick in the program's `sim.assemble` and
`sim.deliver` spans (the TX block assembled on the host; the RX rings
filled and the radios' timed commands applied), the ether's host side
without the copies and the device work of `sim.ether`, over the traced
run's window. None where the program has no such spans."""

KEYS = ("span.sim.assemble.ns", "span.sim.deliver.ns")


def read(trace):
    c = trace.counts
    if not trace.units or not all(k in c for k in KEYS):
        return None
    return sum(c[k] for k in KEYS) / 1e6 / trace.units
