"""UDP socket application server/client (a copy of
dectnrp_tpu/application/socket_app.py; reference application/sockets/).

`SocketServer` binds one UDP port per data flow and collects inbound
datagrams into per-port DatagramQueues (socket_server.cpp: poll fd ->
filter -> queue -> post application_report_t job). Polling is explicit
(`poll()` from the node event loop) or continuous via `start()`'s reader
thread — the reference always uses a thread; the explicit mode keeps the
lock-step simulator deterministic.

`SocketClient` is the egress side (socket_client.cpp): firmware-received
datagrams are sent to localhost destination ports.
"""
from __future__ import annotations

import selectors
import socket
import threading

from .queue import DatagramQueue


class SocketServer:
    def __init__(self, ports: list[int], host: str = "127.0.0.1",
                 nof_datagrams: int = 64, datagram_max_bytes: int = 2048):
        self.queues: dict[int, DatagramQueue] = {}
        self._socks: dict[int, socket.socket] = {}
        self._sel = selectors.DefaultSelector()
        for p in ports:
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind((host, p))               # p=0 -> ephemeral
            s.setblocking(False)
            bound = s.getsockname()[1]
            self._socks[bound] = s
            self.queues[bound] = DatagramQueue(nof_datagrams,
                                               datagram_max_bytes)
            self._sel.register(s, selectors.EVENT_READ, bound)
        self.ports = list(self._socks)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    @property
    def bound_ports(self) -> list[int]:
        """Actual ports (after 0 -> ephemeral resolution)."""
        return [s.getsockname()[1] for s in self._socks.values()]

    def poll(self, timeout: float = 0.0) -> int:
        """Drain ready sockets into the queues; returns datagram count."""
        n = 0
        for key, _ in self._sel.select(timeout):
            sock, port = key.fileobj, key.data
            while True:
                try:
                    data, _ = sock.recvfrom(65536)
                except BlockingIOError:
                    break
                q = self.queues[port]
                q.write(data)
                n += 1
        return n

    def read_all(self) -> list[bytes]:
        """All queued datagrams across ports, FIFO per port."""
        out: list[bytes] = []
        for q in self.queues.values():
            out.extend(q.read_all())
        return out

    # --- optional reader thread (reference's always-on mode) -------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            self.poll(timeout=0.05)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        for s in self._socks.values():
            self._sel.unregister(s)
            s.close()
        self._socks.clear()


class SocketClient:
    """Egress: firmware -> localhost UDP ports (socket_client.cpp)."""

    def __init__(self, ports: list[int], host: str = "127.0.0.1"):
        self.host = host
        self.ports = list(ports)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sent = 0

    def write(self, datagram: bytes, port_index: int = 0) -> None:
        self._sock.sendto(datagram, (self.host, self.ports[port_index]))
        self.sent += 1

    def write_all(self, datagrams: list[bytes], port_index: int = 0) -> None:
        for d in datagrams:
            self.write(d, port_index)

    def close(self) -> None:
        self._sock.close()
