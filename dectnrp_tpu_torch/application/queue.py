"""Fixed-size lockable datagram queue (a copy of
dectnrp_tpu/application/queue.py; reference application/queue/queue.cpp).

The reference preallocates `nof_datagrams` slots of `datagram_max_byte` each
behind a spinlock; writers drop on overflow (real-time policy), readers
drain in FIFO order. Two backends with identical semantics: the native C++
queue (common/native.py -> native/dectnrp_rt.cc, the default when a
toolchain exists, like the reference's C++ queue) and a bounded deque +
lock fallback. `make_datagram_queue` picks.
"""
from __future__ import annotations

import threading
from collections import deque


class DatagramQueue:
    def __init__(self, nof_datagrams: int = 64,
                 datagram_max_bytes: int = 2048):
        self.nof_datagrams = nof_datagrams
        self.datagram_max_bytes = datagram_max_bytes
        self._dq: deque[bytes] = deque()
        self._lock = threading.Lock()
        self.dropped = 0
        self.pushed = 0

    def write(self, datagram: bytes) -> bool:
        """FIFO push; drops (returns False) when full or oversized."""
        if len(datagram) > self.datagram_max_bytes:
            self.dropped += 1
            return False
        with self._lock:
            if len(self._dq) >= self.nof_datagrams:
                self.dropped += 1
                return False
            self._dq.append(bytes(datagram))
            self.pushed += 1
            return True

    def read(self) -> bytes | None:
        with self._lock:
            return self._dq.popleft() if self._dq else None

    def read_all(self) -> list[bytes]:
        with self._lock:
            out = list(self._dq)
            self._dq.clear()
            return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)

    @property
    def used_bytes(self) -> int:
        with self._lock:
            return sum(len(d) for d in self._dq)


class NativeBackedDatagramQueue:
    """DatagramQueue API over the C++ queue (native/dectnrp_rt.cc dq_*)."""

    def __init__(self, nof_datagrams: int = 64,
                 datagram_max_bytes: int = 2048):
        from ..common.native import NativeDatagramQueue
        self.nof_datagrams = nof_datagrams
        self.datagram_max_bytes = datagram_max_bytes
        self._q = NativeDatagramQueue(
            max_datagrams=nof_datagrams,
            max_bytes=nof_datagrams * datagram_max_bytes)
        self.pushed = 0
        self._oversize_dropped = 0

    def write(self, datagram: bytes) -> bool:
        if len(datagram) > self.datagram_max_bytes:
            self._oversize_dropped += 1
            return False
        ok = self._q.push(bytes(datagram))
        if ok:
            self.pushed += 1
        return ok

    def read(self) -> bytes | None:
        return self._q.pop(timeout_us=0)

    def read_all(self) -> list[bytes]:
        out = []
        while (d := self._q.pop(timeout_us=0)) is not None:
            out.append(d)
        return out

    def __len__(self) -> int:
        return len(self._q)

    @property
    def dropped(self) -> int:
        return self._q.dropped + self._oversize_dropped


def make_datagram_queue(nof_datagrams: int = 64,
                        datagram_max_bytes: int = 2048):
    """Native C++ queue when the toolchain exists, Python fallback otherwise."""
    from ..common.native import native_available
    cls = NativeBackedDatagramQueue if native_available() else DatagramQueue
    return cls(nof_datagrams, datagram_max_bytes)
