"""node.host_ms: host ms a tick outside the sync, RX, TX and vspace spans:
the runtime's own work and the firmware (`upper.runtime`, `upper.p2p`),
over the traced run's window."""

SPANS = ("sync", "rx", "tx", "vspace")


def read(trace):
    ticks = trace.unit_ms
    if not ticks:
        return None
    inside = sum(trace.spans_ms.get(s, 0.0) for s in SPANS)
    return (sum(ticks) - inside) / len(ticks)
