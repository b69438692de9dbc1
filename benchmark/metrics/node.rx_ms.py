"""node.rx_ms: host ms a tick in the port's `rx` span (calls of
`phy.sync.RxStream` by every node's runtime), each call closed by a device
synchronisation, over the traced run's window."""


def read(trace):
    if "rx" not in trace.spans_ms or not trace.units:
        return None
    return trace.spans_ms["rx"] / trace.units
