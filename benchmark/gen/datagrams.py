"""Datagram traffic for a scenario of p2p nodes: each node's application
queue is topped up before every tick.

Traffic parameters (a JSON file of traffic/):
  generator       "datagrams"
  queue           datagrams each node keeps queued a PT it serves (the FT
                  serves every associated PT, a PT the FT); 0 sends none
  size            bytes a datagram
  warm_periods    beacon periods of this traffic run in set-up, after
                  every PT associated, so every packet shape is built
  drain_ticks     ticks run after the window, without new datagrams, for
                  those already sent to arrive

A datagram is [node index: 1 byte][sequence number: 4 bytes][random bytes
from the seed], so every one is distinct and names its sender.
"""
from __future__ import annotations

import numpy as np


class Datagrams:
    def __init__(self, traffic: dict, seed: int):
        self.queue = int(traffic["queue"])
        self.size = int(traffic["size"])
        self.rng = np.random.default_rng(seed)
        self.seq = 0
        self.pushed: dict[bytes, int] = {}     # datagram -> sender node

    def make(self, node: int) -> bytes:
        self.seq += 1
        body = self.rng.integers(0, 256, self.size - 5, dtype=np.uint8)
        d = bytes([node]) + self.seq.to_bytes(4, "big") + body.tobytes()
        self.pushed[d] = node
        return d

    def top_up(self, node: int, queued: int, peers: int) -> list[bytes]:
        """Datagrams for `node`, whose queue holds `queued`, to keep
        `queue` a peer queued."""
        return [self.make(node)
                for _ in range(max(0, self.queue * peers - queued))]
