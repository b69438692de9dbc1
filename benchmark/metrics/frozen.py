"""The yardstick's arithmetic: frozen copies from the repository's
`chip_smoke.py` (not a metric; the metric readers import it).

- `busy_union`: the busy union of chip_smoke.profile_device, over a traced
  window of many steps instead of one step.
- `tick_rate`: the tick arithmetic of chip_smoke.rt_tick_stats, the
  realtime multiple taken over the window's time instead of a mean tick.
"""
from __future__ import annotations


def busy_union(intervals) -> int:
    """Length of the union of [start, end) intervals (ns): the time in
    which some operation ran on the device."""
    busy, cur_s, cur_e = 0, None, None
    for s0, s1 in sorted(intervals):
        if cur_e is None or s0 > cur_e:
            busy += 0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s0, s1
        else:
            cur_e = max(cur_e, s1)
    return busy + (0 if cur_e is None else cur_e - cur_s)


def tick_rate(n_ticks: int, spp: int, rate: float, window_s: float) -> float:
    """Realtime multiple of a tick loop: radio time advanced (n_ticks spp
    samples at `rate`) over the seconds it took."""
    return n_ticks * spp / rate / window_s
