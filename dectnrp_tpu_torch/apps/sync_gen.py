"""Deadline-scheduled multi-stream UDP generator (a copy of
dectnrp_tpu/apps/sync_gen.py; reference apps/sync/
sync.cpp:53-114): each stream sends one numbered datagram at fixed
period boundaries of the monotonic clock, for cross-SDR synchronization
experiments.
"""
from __future__ import annotations

import argparse
import socket
import time
from dataclasses import dataclass


@dataclass
class StreamConfig:
    port: int
    period_s: float = 0.01
    payload_bytes: int = 32
    host: str = "127.0.0.1"


def run_sync(streams: list[StreamConfig], duration_s: float = 1.0,
             t_start: float | None = None) -> list[int]:
    """Sends until duration elapses; returns datagrams-sent per stream."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    t0 = time.monotonic() if t_start is None else t_start
    counts = [0] * len(streams)
    next_t = [t0 + s.period_s for s in streams]
    end = t0 + duration_s
    try:
        while True:
            i = min(range(len(streams)), key=lambda k: next_t[k])
            t = next_t[i]
            if t > end:
                break
            now = time.monotonic()
            if t > now:
                time.sleep(t - now)
            s = streams[i]
            payload = counts[i].to_bytes(4, "big") \
                + bytes(s.payload_bytes - 4)
            sock.sendto(payload, (s.host, s.port))
            counts[i] += 1
            next_t[i] += s.period_s
    finally:
        sock.close()
    return counts


def main() -> None:
    ap = argparse.ArgumentParser(description="deadline-scheduled UDP streams")
    ap.add_argument("--ports", type=int, nargs="+", required=True)
    ap.add_argument("--period", type=float, default=0.01)
    ap.add_argument("--duration", type=float, default=1.0)
    ap.add_argument("--payload", type=int, default=32)
    a = ap.parse_args()
    counts = run_sync([StreamConfig(p, a.period, a.payload)
                       for p in a.ports], a.duration)
    print({"sent": counts})


if __name__ == "__main__":
    main()
