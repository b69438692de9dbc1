"""Live IQ streaming to GNU Radio over TCP (a copy of
dectnrp_tpu/common/tcp_scope.py; reference common/adt/
tcp_scope.hpp, gated by RADIO_BUFFER_RX_TCP_SCOPE): a TCP server that
pushes interleaved float32 I/Q so a GNU Radio flowgraph (gnuradio/
tcp_scope.grc) can display the stream live. Debug-only, best-effort:
samples are dropped when no client is connected.
"""
from __future__ import annotations

import socket
import threading

import numpy as np


class TcpScope:
    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(1)
        self._srv.setblocking(False)
        self.port = self._srv.getsockname()[1]
        self._client: socket.socket | None = None
        self._lock = threading.Lock()
        self.sent_samples = 0
        self.dropped_samples = 0

    def _try_accept(self) -> None:
        if self._client is not None:
            return
        try:
            c, _ = self._srv.accept()
            c.setblocking(True)
            self._client = c
        except BlockingIOError:
            pass

    def push(self, iq: np.ndarray) -> bool:
        """Send one antenna's cf32 samples (interleaved f32 I/Q on the
        wire, GNU Radio's native complex format)."""
        with self._lock:
            self._try_accept()
            if self._client is None:
                self.dropped_samples += len(iq)
                return False
            try:
                self._client.sendall(
                    np.asarray(iq, np.complex64).tobytes())
                self.sent_samples += len(iq)
                return True
            except OSError:
                self._client.close()
                self._client = None
                self.dropped_samples += len(iq)
                return False

    def close(self) -> None:
        with self._lock:
            if self._client is not None:
                self._client.close()
            self._srv.close()
