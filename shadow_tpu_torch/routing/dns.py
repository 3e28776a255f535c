"""Global name/IP registry (build-time, host-side).

Parity with the reference DNS (ref: dns.c): assigns each registered
host a unique IPv4 address from an incrementing counter, skipping the
reserved ranges of dns.c:74-96, honoring explicit IP requests; resolves
name <-> address both ways. Device code never sees strings — the
registry also exposes the dense ip <-> host-index arrays used to build
socket lookup keys.
"""

from __future__ import annotations

import numpy as np

from shadow_tpu_torch.routing.address import Address, LOOPBACK_IP, str_to_ip

# Reserved IPv4 ranges (prefix, bits) — ref: dns.c:74-96.
_RESTRICTED = [
    ("0.0.0.0", 8), ("10.0.0.0", 8), ("100.64.0.0", 10), ("127.0.0.0", 8),
    ("169.254.0.0", 16), ("172.16.0.0", 12), ("192.0.0.0", 29),
    ("192.0.2.0", 24), ("192.88.99.0", 24), ("192.168.0.0", 16),
    ("198.18.0.0", 15), ("198.51.100.0", 24), ("203.0.113.0", 24),
    ("224.0.0.0", 4), ("240.0.0.0", 4), ("255.255.255.255", 32),
]
_RESTRICTED_INT = [(str_to_ip(p), b) for p, b in _RESTRICTED]


def is_restricted(ip: int) -> bool:
    for prefix, bits in _RESTRICTED_INT:
        mask = ((1 << bits) - 1) << (32 - bits) if bits else 0
        if (ip & mask) == (prefix & mask):
            return True
    return False


def _next_unrestricted(ip: int) -> int:
    """Smallest address >= ip outside every reserved range (skips whole
    ranges at once; the reference's one-at-a-time loop, dns.c:103-110,
    is prohibitive in Python for /8 blocks)."""
    moved = True
    while moved:
        moved = False
        for prefix, bits in _RESTRICTED_INT:
            mask = ((1 << bits) - 1) << (32 - bits) if bits else 0
            if (ip & mask) == (prefix & mask):
                ip = ((prefix & mask) | (~mask & 0xFFFFFFFF)) + 1
                moved = True
    return ip


class DNS:
    def __init__(self):
        self._ip_counter = 0
        self._mac_counter = 0
        self._by_ip: dict[int, Address] = {}
        self._by_name: dict[str, Address] = {}

    def _generate_ip(self) -> int:
        ip = self._ip_counter + 1
        while True:
            ip = _next_unrestricted(ip)
            if ip not in self._by_ip:
                break
            ip += 1
        self._ip_counter = ip
        return ip

    def register(self, host_index: int, name: str, requested_ip: str | None = None) -> Address:
        """Register one host interface; honors a requested IP if it is
        valid, unrestricted, and unused (ref: dns.c register path)."""
        if name in self._by_name:
            raise ValueError(f"duplicate hostname {name}")
        ip = None
        if requested_ip is not None:
            cand = str_to_ip(requested_ip)
            if not is_restricted(cand) and cand not in self._by_ip:
                ip = cand
        if ip is None:
            ip = self._generate_ip()
        self._mac_counter += 1
        addr = Address(host_index=host_index, ip=ip, mac=self._mac_counter, name=name)
        self._by_ip[ip] = addr
        self._by_name[name] = addr
        return addr

    def register_loopback(self, host_index: int, name: str) -> Address:
        return Address(host_index=host_index, ip=LOOPBACK_IP, mac=0,
                       name=name, is_local=True)

    def resolve_ip(self, ip: int) -> Address | None:
        return self._by_ip.get(ip)

    def resolve_name(self, name: str) -> Address | None:
        return self._by_name.get(name)

    def host_ips(self, num_hosts: int) -> np.ndarray:
        """[H] the eth IP of each host index (0 if unregistered)."""
        out = np.zeros(num_hosts, dtype=np.int64)
        for addr in self._by_ip.values():
            if 0 <= addr.host_index < num_hosts:
                out[addr.host_index] = addr.ip
        return out
