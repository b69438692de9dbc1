"""node.vspace_ms: host ms a tick in the scenario's `driver.tick` (the
virtual ether's tick on the device and the simulated radios' host rings),
closed by a device synchronisation, over the traced run's window."""


def read(trace):
    if "vspace" not in trace.spans_ms or not trace.units:
        return None
    return trace.spans_ms["vspace"] / trace.units
