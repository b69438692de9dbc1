"""node.tx_ms: host ms a tick in the port's `tx` span (calls of
`phy.tx.Tx` by every node's runtime), each call closed by a device
synchronisation, over the traced run's window."""


def read(trace):
    if "tx" not in trace.spans_ms or not trace.units:
        return None
    return trace.spans_ms["tx"] / trace.units
