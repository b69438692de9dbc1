"""UDP round-trip-time measurement client (a copy of
dectnrp_tpu/apps/rtt.py; reference apps/rtt/rtt.cpp):
sends numbered datagrams to the firmware's ingress port, waits for each
echo on the egress port with a timeout, reports RTT statistics.
"""
from __future__ import annotations

import argparse
import socket
import time
from dataclasses import dataclass, field


@dataclass
class RttResult:
    rtts_s: list[float] = field(default_factory=list)
    lost: int = 0

    @property
    def n(self) -> int:
        return len(self.rtts_s)

    def summary(self) -> dict:
        if not self.rtts_s:
            return {"n": 0, "lost": self.lost}
        r = sorted(self.rtts_s)
        return {"n": self.n, "lost": self.lost,
                "min_ms": r[0] * 1e3, "max_ms": r[-1] * 1e3,
                "mean_ms": sum(r) / len(r) * 1e3,
                "p50_ms": r[len(r) // 2] * 1e3}


def run_rtt(tx_port: int, rx_port: int, n: int = 10,
            payload_bytes: int = 32, timeout_s: float = 1.0,
            host: str = "127.0.0.1") -> RttResult:
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    rx.bind((host, rx_port))
    rx.settimeout(timeout_s)
    res = RttResult()
    try:
        for i in range(n):
            probe = i.to_bytes(4, "big") + bytes(payload_bytes - 4)
            t0 = time.monotonic()
            tx.sendto(probe, (host, tx_port))
            try:
                while True:
                    data, _ = rx.recvfrom(65536)
                    if data[:4] == probe[:4]:
                        res.rtts_s.append(time.monotonic() - t0)
                        break
            except socket.timeout:
                res.lost += 1
    finally:
        tx.close()
        rx.close()
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description="DECT NR+ UDP RTT tester")
    ap.add_argument("--tx-port", type=int, required=True)
    ap.add_argument("--rx-port", type=int, required=True)
    ap.add_argument("-n", type=int, default=10)
    ap.add_argument("--payload", type=int, default=32)
    ap.add_argument("--timeout", type=float, default=1.0)
    a = ap.parse_args()
    res = run_rtt(a.tx_port, a.rx_port, a.n, a.payload, a.timeout)
    print(res.summary())


if __name__ == "__main__":
    main()
