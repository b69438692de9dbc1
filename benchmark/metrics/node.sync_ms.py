"""node.sync_ms: host ms a tick in the port's `sync` span (calls of
`phy.sync.Sync` by every node's runtime), each call closed by a device
synchronisation, over the traced run's window."""


def read(trace):
    if "sync" not in trace.spans_ms or not trace.units:
        return None
    return trace.spans_ms["sync"] / trace.units
