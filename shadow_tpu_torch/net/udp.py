"""UDP datagram socket semantics (PyTorch port of shadow_tpu/net/udp.py;
ref: descriptor/udp.c). Send queues one packet on the socket's output
ring for the NIC; receive buffers packets in arrival order in the input
ring, dropping (counted) when the receive buffer is full, and raises
READABLE."""

from __future__ import annotations

import torch

from shadow_tpu_torch.core.events import NWORDS, as_tensor, u32_to_i32
from shadow_tpu_torch.net import packetfmt as pf
from shadow_tpu_torch.net.rings import (
    gather_hs,
    ring_advance_pop,
    ring_advance_push,
    ring_peek_at,
    ring_push_at,
    set_hs,
    set_ring,
)
from shadow_tpu_torch.net.sockets import sk_enqueue_out
from shadow_tpu_torch.net.state import NetState, SocketFlags

I32 = torch.int32
I64 = torch.int64
DATAGRAM_MAX = 65507  # ref: definitions.h:193


def udp_enqueue_send(net: NetState, mask, slot, dst_ip, dst_port, length,
                     payref):
    """Queue one datagram on (lane, slot)'s output ring. Returns
    (net, ok[H]) — ok False when the send buffer lacks space."""
    H = mask.shape[0]
    dev = mask.device
    src_port = gather_hs(net.sk_bound_port, slot)
    words = torch.zeros((H, NWORDS), dtype=I32, device=dev)
    words[:, pf.W_PROTO] = pf.PROTO_UDP
    words[:, pf.W_LEN] = as_tensor(length, I32, dev)
    words[:, pf.W_PORTS] = pf.pack_ports(src_port,
                                         as_tensor(dst_port, I32, dev))
    words[:, pf.W_PAYREF] = as_tensor(payref, I32, dev)
    words[:, pf.W_DSTIP] = u32_to_i32(as_tensor(dst_ip, I64, dev) & 0xFFFFFFFF)
    words[:, pf.W_STATUS] = pf.PDS_SND_CREATED | pf.PDS_SND_SOCKET_BUFFERED
    return sk_enqueue_out(net, mask, slot, words)


def udp_deliver(net: NetState, mask, slot, src_ip, src_port, length, payref,
                status=None):
    """Push one received datagram into (lane, slot)'s input ring; drop
    (counted) when the receive buffer is full. `status` is the packet's
    delivery-status trail word."""
    H = mask.shape[0]
    BI = net.in_src_ip.shape[2]
    if status is None:
        status = torch.zeros((H,), dtype=I32, device=mask.device)

    space_ok = (gather_hs(net.in_bytes, slot) + length) <= gather_hs(
        net.sk_rcvbuf, slot)
    ok, pos = ring_push_at(net.in_head, net.in_count, BI, mask & space_ok,
                           slot)
    net = net.replace(
        in_src_ip=set_ring(net.in_src_ip, ok, slot, pos, src_ip),
        in_src_port=set_ring(net.in_src_port, ok, slot, pos, src_port),
        in_len=set_ring(net.in_len, ok, slot, pos, length),
        in_payref=set_ring(net.in_payref, ok, slot, pos, payref),
        in_status=set_ring(net.in_status, ok, slot, pos,
                           status | pf.PDS_RCV_SOCKET_BUFFERED),
    )
    _, count = ring_advance_push(net.in_head, net.in_count, mask, slot, ok)
    net = net.replace(in_count=count)
    ib = gather_hs(net.in_bytes, slot)
    net = net.replace(in_bytes=set_hs(net.in_bytes, ok, slot, ib + length))
    # readable on data arrival; every arrival is an edge for ET epoll
    flags = gather_hs(net.sk_flags, slot)
    net = net.replace(
        sk_flags=set_hs(net.sk_flags, ok, slot, flags | SocketFlags.READABLE),
        sk_in_gen=set_hs(net.sk_in_gen, ok, slot,
                         gather_hs(net.sk_in_gen, slot) + 1),
    )
    dropped = mask & ~space_ok
    return net.replace(
        ctr_drop_bufferfull=net.ctr_drop_bufferfull + dropped.to(I64),
        last_drop_status=torch.where(
            dropped, status | pf.PDS_RCV_SOCKET_DROPPED,
            net.last_drop_status),
    )


def udp_recv(net: NetState, mask, slot):
    """Pop one datagram per masked lane. Returns
    (net, got[H], src_ip, src_port, length, payref)."""
    H = mask.shape[0]
    lane = torch.arange(H, device=mask.device)
    BI = net.in_src_ip.shape[2]
    got, pos = ring_peek_at(net.in_head, net.in_count, mask, slot, BI)
    s = slot.clamp(0, net.in_src_ip.shape[1] - 1).to(I64)
    posc = pos.clamp(0, BI - 1).to(I64)
    src_ip = net.in_src_ip[lane, s, posc]
    src_port = net.in_src_port[lane, s, posc]
    length = torch.where(got, net.in_len[lane, s, posc], 0)
    payref = net.in_payref[lane, s, posc]
    head, count = ring_advance_pop(net.in_head, net.in_count, got, slot, BI)
    net = net.replace(in_head=head, in_count=count)
    ib = gather_hs(net.in_bytes, slot)
    net = net.replace(in_bytes=set_hs(net.in_bytes, got, slot, ib - length))
    # clear READABLE when drained
    empty = gather_hs(net.in_count, slot) == 0
    flags = gather_hs(net.sk_flags, slot)
    net = net.replace(
        sk_flags=set_hs(net.sk_flags, got & empty, slot,
                        flags & ~SocketFlags.READABLE))
    return net, got, src_ip, src_port, length, payref
