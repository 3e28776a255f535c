"""Topology, DNS and addresses (host-side, numpy)."""
