"""Socket table operations (PyTorch port of shadow_tpu/net/sockets.py).

The reference's descriptor table + per-interface bound-socket hash
(ref: host.c:696-767, network_interface.c:255-308) become row scans
over the [H,S] socket arrays; a delivery "lookup" prefers the
(peer ip, peer port)-specific association over the general one.
"""

from __future__ import annotations

import torch

from shadow_tpu_torch.core.events import _first_true, as_tensor, fit_words
from shadow_tpu_torch.net import packetfmt as pf
from shadow_tpu_torch.net.rings import (
    gather_hs,
    ring_advance_push,
    ring_push_at,
    set_hs,
    set_ring,
)
from shadow_tpu_torch.net.state import NetState, SocketFlags, SocketType

I32 = torch.int32
I64 = torch.int64
MIN_RANDOM_PORT = 10000  # ref: definitions.h:94


def set_writable(net: NetState, mask, slot, on):
    """Set/clear WRITABLE for (lane, slot), bumping the out-readiness
    generation on the not-writable -> writable transition."""
    fl = gather_hs(net.sk_flags, slot)
    on = as_tensor(on, torch.bool, mask.device).expand(mask.shape)
    edge = mask & on & ((fl & SocketFlags.WRITABLE) == 0)
    return net.replace(
        sk_flags=set_hs(
            net.sk_flags, mask, slot,
            torch.where(on, fl | SocketFlags.WRITABLE,
                        fl & ~SocketFlags.WRITABLE)),
        sk_out_gen=set_hs(net.sk_out_gen, edge, slot,
                          gather_hs(net.sk_out_gen, slot) + 1),
    )


def sk_enqueue_out(net: NetState, mask, slot, words):
    """Push one fully-formed packet ([H, NWORDS]) onto (lane, slot)'s
    output ring, charging W_LEN payload bytes against the send buffer
    and stamping the per-host app-ordering priority. Returns (net,
    ok[H]); ok False when the ring or send buffer lacks space."""
    BO = net.out_words.shape[2]
    words = fit_words(words, net.out_words.shape[-1])
    length = words[:, pf.W_LEN]

    space_ok = (gather_hs(net.out_bytes, slot) + length) <= gather_hs(
        net.sk_sndbuf, slot)
    ok, pos = ring_push_at(net.out_head, net.out_count, BO, mask & space_ok,
                           slot)
    net = net.replace(
        out_words=set_ring(net.out_words, ok, slot, pos, words),
        out_priority=set_ring(net.out_priority, ok, slot, pos,
                              net.priority_ctr),
        priority_ctr=net.priority_ctr + ok.to(net.priority_ctr.dtype),
    )
    _, count = ring_advance_push(net.out_head, net.out_count, mask, slot, ok)
    ob = gather_hs(net.out_bytes, slot)
    net = net.replace(
        out_count=count,
        out_bytes=set_hs(net.out_bytes, ok, slot, ob + length),
    )
    # datagram writability tracks output capacity: clear it when the
    # ring or byte budget is exhausted (or this enqueue failed); the NIC
    # drain restores it. TCP sockets are excluded.
    full = mask & (gather_hs(net.sk_type, slot) != SocketType.TCP) \
        & (~ok
           | (gather_hs(net.out_count, slot) >= BO)
           | (gather_hs(net.out_bytes, slot)
              >= gather_hs(net.sk_sndbuf, slot)))
    net = set_writable(net, full, slot, False)
    return net, ok


def sk_create(net: NetState, mask, stype):
    """Allocate one socket per masked lane (first free slot). Returns
    (net, slot[H] — -1 where full/unmasked)."""
    free = net.sk_type == SocketType.NONE
    has = free.any(dim=1)
    slot = _first_true(free)
    ok = mask & has
    slot = torch.where(ok, slot, -1)
    stype_b = as_tensor(stype, I32, mask.device).expand(mask.shape)
    net = net.replace(
        sk_type=set_hs(net.sk_type, ok, slot, stype_b),
        sk_flags=set_hs(
            net.sk_flags, ok, slot,
            torch.full(mask.shape, SocketFlags.ACTIVE | SocketFlags.WRITABLE,
                       dtype=I32, device=mask.device)),
        ctr_sk_alloc=net.ctr_sk_alloc + ok.to(I64),
    )
    return net, slot


def sk_bind(net: NetState, mask, slot, ip, port):
    """Bind masked lanes' socket `slot` to (ip, port); port 0 draws an
    ephemeral port (per-host counter, deterministic)."""
    eph = MIN_RANDOM_PORT + net.port_ctr
    port = as_tensor(port, I32, mask.device)
    use_eph = mask & (port == 0)
    port = torch.where(use_eph, eph, port)
    net = net.replace(
        port_ctr=net.port_ctr + use_eph.to(I32),
        sk_bound_ip=set_hs(net.sk_bound_ip, mask, slot,
                           as_tensor(ip, I64, mask.device).expand(mask.shape)),
        sk_bound_port=set_hs(net.sk_bound_port, mask, slot, port),
    )
    return net, port


def lookup_socket(net: NetState, mask, proto, dst_ip, dst_port, src_ip,
                  src_port):
    """Find the receiving socket slot per lane ([H] -> slot or -1); the
    (peer ip, peer port)-specific association wins over the general
    (peer-less) one."""
    pr = proto[:, None]
    dip = dst_ip[:, None]
    dpt = dst_port[:, None]
    sip = src_ip[:, None]
    spt = src_port[:, None]

    base = (
        mask[:, None]
        & (net.sk_type == pr)
        & ((net.sk_flags & SocketFlags.CLOSED) == 0)
        & (net.sk_bound_port == dpt)
        & ((net.sk_bound_ip == 0) | (net.sk_bound_ip == dip))
    )
    general = base & (net.sk_peer_port == 0)
    specific = base & (net.sk_peer_ip == sip) & (net.sk_peer_port == spt)
    g = torch.where(general.any(dim=1), _first_true(general), -1)
    s = torch.where(specific.any(dim=1), _first_true(specific), -1)
    return torch.where(s >= 0, s, g)
