"""node.tick_p95_ms: the 95th percentile of the host ms of every
`RunningScenario.tick` of the traced run's window (spans closed by a device
synchronisation, so a traced tick runs slower than an untraced one)."""
from benchmark.core.stats import percentile


def read(trace):
    if not trace.unit_ms:
        return None
    return percentile(trace.unit_ms, 95)
