"""Application layer: datagram IO between user programs and the firmware
(a copy of dectnrp_tpu/application/__init__.py).

Counterpart of reference lib/*/application/: an ingress server
(UDP socket set or TUN virtual NIC) feeding datagram queues that the node
runtime drains into tpoint.work_application(), and an egress client pushing
firmware-received datagrams back out (application_server.hpp,
application_client.hpp, queue/queue.hpp, socket/*, vnic/*).
"""
from .queue import DatagramQueue
from .socket_app import SocketClient, SocketServer

__all__ = ["DatagramQueue", "SocketClient", "SocketServer"]
