"""Host addresses (build-time, host-side).

Parity with the reference's Address object (ref: address.c:23-40):
a host has a unique network IP, a MAC-like unique id, a hostname, and
a local (loopback) flag. Device programs refer to hosts by dense index;
Address maps those indices to the IP/name world applications see.
"""

from __future__ import annotations

from dataclasses import dataclass


def ip_to_str(ip: int) -> str:
    return f"{(ip >> 24) & 255}.{(ip >> 16) & 255}.{(ip >> 8) & 255}.{ip & 255}"


def str_to_ip(s: str) -> int:
    parts = [int(p) for p in s.split(".")]
    if len(parts) != 4 or any(p < 0 or p > 255 for p in parts):
        raise ValueError(f"bad IPv4 literal: {s}")
    return (parts[0] << 24) | (parts[1] << 16) | (parts[2] << 8) | parts[3]


LOOPBACK_IP = str_to_ip("127.0.0.1")


@dataclass(frozen=True)
class Address:
    host_index: int   # dense host id used on device
    ip: int           # unique network IP (host byte order)
    mac: int          # unique id (ref: address.c uniqueMAC)
    name: str
    is_local: bool = False

    @property
    def ip_str(self) -> str:
        return ip_to_str(self.ip)

    def __str__(self) -> str:
        return f"{self.name}-{self.ip_str}"
