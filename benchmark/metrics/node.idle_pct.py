"""node.idle_pct: the share of the profiled window in which no operation ran
on the device, 1 - (union of device activity) / (window), in %."""


def read(trace):
    p = trace.profile
    if not p.get("window_s") or not p.get("busy_s"):
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
