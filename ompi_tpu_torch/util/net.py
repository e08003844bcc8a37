"""Network interface enumeration and address selection.

The port's counterpart of ``ompi_tpu.util.net`` (reference:
opal/util/net.c with opal/mca/if, the NIC enumeration, and
mca/reachable/weighted, the pairwise address scoring): btl/tcp publishes
every IPv4 address of this host through the modex and each peer dials
the best-scored one. Interfaces are read from the kernel with
``SIOCGIFADDR`` per interface name (Linux): local queries only, no name
resolution and no packet.
"""

from __future__ import annotations

import fcntl
import ipaddress
import socket
import struct
from typing import List, NamedTuple, Optional

_SIOCGIFADDR = 0x8915


class Interface(NamedTuple):
    name: str
    address: str
    is_loopback: bool
    is_private: bool


def _ipv4_of(sock: socket.socket, name: str) -> Optional[str]:
    try:
        req = struct.pack("256s", name.encode()[:15])
        got = fcntl.ioctl(sock.fileno(), _SIOCGIFADDR, req)
    except OSError:  # no IPv4 address on this interface
        return None
    return socket.inet_ntoa(got[20:24])


def interfaces() -> List[Interface]:
    """IPv4 interfaces of this host (always includes loopback)."""
    out: List[Interface] = []
    try:
        names = [n for _, n in socket.if_nameindex()]
    except OSError:
        names = []
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        for name in names:
            addr = _ipv4_of(s, name)
            if addr is None:
                continue
            ip = ipaddress.ip_address(addr)
            out.append(Interface(name, addr, ip.is_loopback,
                                 ip.is_private and not ip.is_loopback))
    if not any(i.is_loopback for i in out):
        out.append(Interface("lo", "127.0.0.1", True, False))
    return out


def score(addr: str, peer_hint: Optional[str] = None) -> int:
    """Reachability score (higher is better), reachable/weighted style:
    loopback pairs and same-/24 pairs first, then private, public, and
    loopback towards a remote peer last."""
    ip = ipaddress.ip_address(addr)
    if peer_hint is not None:
        peer = ipaddress.ip_address(peer_hint)
        if ip.is_loopback and peer.is_loopback:
            return 100
        if _same24(ip, peer):
            return 90
    if ip.is_loopback:
        return 10
    if ip.is_private:
        return 70
    return 50


def _same24(a, b) -> bool:
    pa = struct.unpack("!I", a.packed)[0] >> 8
    pb = struct.unpack("!I", b.packed)[0] >> 8
    return pa == pb


def pick_peer_address(published: List[str],
                      mine: Optional[List[str]] = None) -> str:
    """Which of a peer's published addresses to dial: the best score
    over every pair of (one of ours, one of theirs)."""
    if not published:
        raise ValueError("peer published no addresses")
    hints = list(mine or [None])
    return max(published, key=lambda a: max(score(a, h) for h in hints))
