"""TUN virtual-NIC application server/client (a copy of
dectnrp_tpu/application/vnic.py; reference application/vnic/).

vnic_server.cpp:37-169 creates a TUN device via ioctl(TUNSETIFF), assigns an
IP, and reads whole IP datagrams from the fd; vnic_client writes firmware-
received datagrams back into the TUN. Requires CAP_NET_ADMIN — callers must
gate on `tun_available()`.
"""
from __future__ import annotations

import fcntl
import os
import struct
import subprocess

# from <linux/if_tun.h>
TUNSETIFF = 0x400454CA
IFF_TUN = 0x0001
IFF_NO_PI = 0x1000


def tun_available() -> bool:
    """True if /dev/net/tun exists and is writable (CAP_NET_ADMIN)."""
    try:
        fd = os.open("/dev/net/tun", os.O_RDWR)
        os.close(fd)
        return True
    except OSError:
        return False


class VnicServer:
    """TUN endpoint: read() returns one IP datagram, write() injects one.

    The reference splits server (read thread -> queue -> PHY job) and
    client (firmware -> TUN); one fd serves both directions here.
    """

    def __init__(self, ifname: str = "tun_dect", ip: str = "172.99.0.1",
                 peer_ip: str = "172.99.0.2", mtu: int = 1500,
                 configure: bool = True):
        self.fd = os.open("/dev/net/tun", os.O_RDWR)
        ifr = struct.pack("16sH22x", ifname.encode(), IFF_TUN | IFF_NO_PI)
        fcntl.ioctl(self.fd, TUNSETIFF, ifr)
        self.ifname = ifname
        self.mtu = mtu
        if configure:
            subprocess.run(["ip", "addr", "add", f"{ip}/24", "dev", ifname],
                           check=True)
            subprocess.run(["ip", "link", "set", ifname, "up",
                            "mtu", str(mtu)], check=True)
        os.set_blocking(self.fd, False)

    def read(self) -> bytes | None:
        """One IP datagram from the OS, or None."""
        try:
            return os.read(self.fd, self.mtu + 4)
        except BlockingIOError:
            return None

    def read_all(self, limit: int = 64) -> list[bytes]:
        out = []
        for _ in range(limit):
            d = self.read()
            if d is None:
                break
            out.append(d)
        return out

    def write(self, datagram: bytes) -> None:
        """Inject one IP datagram toward the OS (vnic_client path)."""
        os.write(self.fd, datagram)

    def close(self) -> None:
        os.close(self.fd)
