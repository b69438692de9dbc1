"""A mirrored ring of complex64 samples on the host, indexed by global
sample time: the simulated radio's RX ring (radio/hw_simulator.py) and each
node runtime's DECT-rate buffer (upper/runtime.py).

Sample t is stored at column t mod C and again at t mod C + C of an
[A, 2C] array (C the capacity), so every window of the last C samples is
one contiguous view, and a push writes only its own samples, twice: no
stored sample ever moves. Each push adds the bytes it writes, mirror
included (2 · A · n · 8), to the ring's counter in `common/trace.py`.
"""
from __future__ import annotations

import numpy as np

from .trace import count


class MirroredRing:
    """The last `cap` samples of an [n_ant, ·] stream that starts at time 0;
    `counter` counts the bytes written, `what` names the ring in the
    assertion of a window outside it."""

    def __init__(self, n_ant: int, cap: int, counter: str, what: str = "ring"):
        self.cap = cap
        self.buf = np.zeros((n_ant, 2 * cap), np.complex64)
        self.end = 0                    # global time of the next sample pushed
        self._counter, self._what = counter, what

    @property
    def start(self) -> int:
        """Global time of the oldest sample held."""
        return max(0, self.end - self.cap)

    def push(self, x: np.ndarray) -> None:
        """Append [A, n] samples, n <= C: the oldest n fall out of the ring."""
        C, r = self.cap, self.buf
        n = x.shape[-1]
        assert n <= C, f"push of {n} samples into a ring of {C}"
        s = self.end % C
        a = min(n, C - s)               # samples that land below column C
        r[:, s:s + n] = x               # may run on into the mirror half
        r[:, C + s:C + s + a] = x[:, :a]
        r[:, :n - a] = x[:, a:]
        self.end += n
        count(self._counter, 2 * n * r.shape[0] * r.itemsize)

    def skip(self, n: int) -> None:
        """Append n zeros, any n: past the capacity only the last C are
        held, so at most C are written."""
        m = min(n, self.cap)
        self.end += n - m
        self.push(np.zeros((self.buf.shape[0], m), self.buf.dtype))

    def window(self, t0: int, n: int) -> np.ndarray:
        """[A, n] samples of [t0, t0 + n) (must be held): a view, never a
        copy."""
        assert self.start <= t0 and t0 + n <= self.end, \
            f"window [{t0},{t0+n}) outside {self._what} [{self.start},{self.end})"
        s = t0 % self.cap
        return self.buf[:, s:s + n]
