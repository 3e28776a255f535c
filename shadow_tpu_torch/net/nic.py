"""NIC token buckets, interface qdiscs, upstream-router queue managers,
and the packet send/receive event handlers — the PyTorch port of
shadow_tpu/net/nic.py (ref: network_interface.c, router.c,
router_queue_codel.c, router_queue_single.c, router_queue_static.c).

- Token buckets both directions, refilled analytically per whole 1 ms
  quantum elapsed, capacity = refill + MTU.
- Sending drains up to cfg.nic_drain packets per micro-step through the
  interface qdisc (QDisc.FIFO: lowest head-packet priority; QDisc.RR:
  cyclic from a per-host cursor); longer bursts chain a same-time
  NIC_SEND.
- Loopback delivery is a +1 ns self event (no router, no tokens).
- Remote sends take one Bernoulli reliability draw from the host's
  threefry stream and deliver after the topology latency.
- Arrivals enqueue into the per-host router ring under the router
  queue manager — CoDel (target 10 ms, interval 100 ms, the RFC-8289
  control law as in the reference), SINGLE (one packet) or STATIC
  (drop-tail at ring capacity) — and are drained by the receive-side
  token bucket.
- TCP: a delivered segment enters the connection state machine
  (tcp.tcp_packet_in); a segment that matches no socket is answered
  with a RST when cfg.tcp; a departing TCP packet has its volatile
  header fields stamped at wire time (tcp.stamp_at_wire).
"""

from __future__ import annotations

import torch

from shadow_tpu_torch.compile.specialize import loss_trimmed
from shadow_tpu_torch.core import rng, simtime
from shadow_tpu_torch.core.events import NWORDS, EventKind, emit, u32_to_i32
from shadow_tpu_torch.net import packetfmt as pf
from shadow_tpu_torch.net import tcp as tcp_mod
from shadow_tpu_torch.net.rings import set_hs, set_row
from shadow_tpu_torch.net.sockets import lookup_socket, set_writable
from shadow_tpu_torch.net.state import (
    TB_REFILL_INTERVAL,
    NetConfig,
    NetState,
    QDisc,
    RouterQ,
    SocketType,
    host_of_ip,
)
from shadow_tpu_torch.net.udp import udp_deliver

I32 = torch.int32
I64 = torch.int64

CODEL_TARGET = 10 * simtime.ONE_MILLISECOND
CODEL_INTERVAL = 100 * simtime.ONE_MILLISECOND


def ip_from_word(w):
    """i32 packet word -> i64 IP (bit-exact unsigned reinterpret)."""
    return w.to(I64) & 0xFFFFFFFF


def _set_col(words, i, value):
    w = words.clone()
    w[:, i] = value
    return w


def refill_tokens(net: NetState, mask, now):
    """Analytic token refill to the current 1 ms quantum."""
    q = torch.div(now, TB_REFILL_INTERVAL, rounding_mode="floor")
    dq = (q - net.tb_quantum).clamp(min=0)
    upd = mask & (dq > 0)
    send_cap = net.tb_send_refill + pf.MTU
    recv_cap = net.tb_recv_refill + pf.MTU
    new_send = torch.minimum(send_cap, net.tb_send_tokens + dq * net.tb_send_refill)
    new_recv = torch.minimum(recv_cap, net.tb_recv_tokens + dq * net.tb_recv_refill)
    return net.replace(
        tb_send_tokens=torch.where(upd, new_send, net.tb_send_tokens),
        tb_recv_tokens=torch.where(upd, new_recv, net.tb_recv_tokens),
        tb_quantum=torch.where(upd, q, net.tb_quantum),
    )


def projected_tokens(net: NetState, at_time):
    """Bucket levels (send, recv) projected to `at_time` [H] — what
    refill_tokens would produce on an access at that instant, without
    mutating state (the bulk pass's token gate reads it). Keep in
    lockstep with refill_tokens above."""
    dq = (torch.div(at_time, TB_REFILL_INTERVAL, rounding_mode="floor")
          - net.tb_quantum).clamp(min=0)
    send_cap = net.tb_send_refill + pf.MTU
    recv_cap = net.tb_recv_refill + pf.MTU
    send = torch.minimum(send_cap, net.tb_send_tokens + dq * net.tb_send_refill)
    recv = torch.minimum(recv_cap, net.tb_recv_tokens + dq * net.tb_recv_refill)
    return send, recv


def next_refill_time(now):
    return (torch.div(now, TB_REFILL_INTERVAL, rounding_mode="floor") + 1) \
        * TB_REFILL_INTERVAL


def _empty_words(H, device):
    return torch.zeros((H, NWORDS), dtype=I32, device=device)


def _capture(cfg: NetConfig, net: NetState, mask, src_host, words, now,
             direction: int):
    """Append packets to the per-host pcap capture ring (ref: the
    sent/received pcap hooks, network_interface.c:337-373,414-415): a
    masked store at slot cap_count % C of cap_time/cap_words/cap_meta
    (meta = src host | direction << 24; 1 = received), and cap_count
    advances. No-op (and no device cost) unless cfg.pcap. The host
    drains the ring between windows (utils/pcap.py)."""
    if not cfg.pcap:
        return net
    C = net.cap_time.shape[1]
    pos = net.cap_count % C
    meta = src_host.clamp(0, (1 << 24) - 1).to(I32) | (direction << 24)
    now = torch.broadcast_to(torch.as_tensor(now, dtype=I64,
                                             device=mask.device), mask.shape)
    return net.replace(
        cap_time=set_row(net.cap_time, mask, pos, now),
        cap_words=set_row(net.cap_words, mask, pos, words),
        cap_meta=set_row(net.cap_meta, mask, pos, meta),
        cap_count=net.cap_count + mask.to(I32),
    )


def deliver_packet(cfg: NetConfig, sim, mask, src_host, words, now, buf):
    """Hand one arrived packet per masked lane to the bound socket
    (ref: _networkinterface_receivePacket, network_interface.c:375-419).
    UDP goes to the datagram ring; TCP enters the connection state
    machine. Returns (sim, buf)."""
    net = sim.net
    GH = net.host_ip.shape[0]
    proto = pf.proto_of(words)
    src_port, dst_port = pf.ports_of(words)
    dst_ip = ip_from_word(words[:, pf.W_DSTIP])
    src_ip = torch.where(
        src_host == net.lane_id, dst_ip,
        net.host_ip[src_host.clamp(0, GH - 1).to(I64)])
    # loopback packets keep their loopback src address
    src_ip = torch.where(dst_ip >> 24 == 127, dst_ip, src_ip)

    net = _capture(cfg, net, mask, src_host, words, now, direction=1)
    slot = lookup_socket(net, mask, proto, dst_ip, dst_port, src_ip, src_port)
    found = mask & (slot >= 0)
    words = _set_col(words, pf.W_STATUS, torch.where(
        found, words[:, pf.W_STATUS] | pf.PDS_RCV_SOCKET_PROCESSED,
        words[:, pf.W_STATUS]))
    is_udp = found & (proto == pf.PROTO_UDP)
    net = udp_deliver(
        net, is_udp, slot, src_ip, src_port, words[:, pf.W_LEN],
        words[:, pf.W_PAYREF], status=words[:, pf.W_STATUS])
    nosock = mask & (slot < 0)
    net = net.replace(last_drop_status=torch.where(
        nosock, words[:, pf.W_STATUS] | pf.PDS_RCV_SOCKET_DROPPED,
        net.last_drop_status))
    if cfg.tcp:
        buf = _answer_rst(net, buf, nosock, proto, src_host, src_ip,
                          src_port, dst_port, words, now)
    net = net.replace(
        ctr_drop_nosocket=net.ctr_drop_nosocket + nosock.to(I64),
        ctr_rx_packets=net.ctr_rx_packets + found.to(I64),
        ctr_rx_bytes=net.ctr_rx_bytes + torch.where(
            found, pf.wire_length(proto, words[:, pf.W_LEN]), 0).to(I64),
        ctr_rx_data_bytes=net.ctr_rx_data_bytes
        + torch.where(found, words[:, pf.W_LEN], 0).to(I64),
    )
    sim = sim.replace(net=net)
    if sim.tcp is not None:
        is_tcp = found & (proto == pf.PROTO_TCP)
        sim, buf = tcp_mod.tcp_packet_in(
            cfg, sim, is_tcp, slot, words, src_ip, src_port, now, buf)
    return sim, buf


def _answer_rst(net: NetState, buf, nosock, proto, src_host, src_ip,
                src_port, dst_port, words, now):
    """A TCP segment that matches no socket is answered with RST|ACK so
    an active open to a dead port fails promptly; a RST is never
    answered. The RST belongs to no socket, so it bypasses the NIC
    rings and rides the event fabric directly: PACKET_LOCAL at now + 1
    for a self-addressed segment, else PACKET after the topology
    latency."""
    GH = net.host_ip.shape[0]
    flags = pf.tcp_flags_of(words)
    need_rst = nosock & (proto == pf.PROTO_TCP) \
        & ((flags & pf.TCPF_RST) == 0)
    f_ack = (flags & pf.TCPF_ACK) != 0
    f_syn = (flags & pf.TCPF_SYN) != 0
    rst = torch.zeros_like(words)
    rst[:, pf.W_PROTO] = pf.PROTO_TCP | ((pf.TCPF_RST | pf.TCPF_ACK) << 8)
    rst[:, pf.W_PORTS] = pf.pack_ports(dst_port, src_port)
    rst[:, pf.W_SEQ] = torch.where(f_ack, words[:, pf.W_ACK], 0)
    rst[:, pf.W_ACK] = words[:, pf.W_SEQ] + words[:, pf.W_LEN] \
        + f_syn.to(I32)
    rst[:, pf.W_PAYREF] = pf.PAYREF_NONE
    rst[:, pf.W_DSTIP] = u32_to_i32(src_ip & 0xFFFFFFFF)
    srch = src_host.clamp(0, GH - 1).to(I64)
    rst_local = need_rst & (src_host == net.lane_id)
    vme = net.vertex_of_host[net.lane_id.to(I64)].to(I64)
    vsrc = net.vertex_of_host[srch].to(I64)
    lat = net.latency_ns[vme, vsrc]
    buf = emit(buf, rst_local, net.lane_id, now + 1, EventKind.PACKET_LOCAL,
               rst)
    return emit(buf, need_rst & ~rst_local & (src_host >= 0), src_host,
                now + lat, EventKind.PACKET, rst)


# ---------------------------------------------------------------------
# receive: packet arrival -> router ring -> CoDel dequeue -> delivery,
# fused into one handler pass
# ---------------------------------------------------------------------

def handle_nic_recv(cfg: NetConfig, sim, popped, buf):
    """kinds PACKET, NIC_RECV, PACKET_LOCAL, fused.

    An arriving packet (PACKET) is enqueued into the router ring and —
    when the queue was idle — dequeued and delivered in the SAME
    micro-step (the reference's synchronous router_enqueue ->
    networkinterface_receivePackets chain). NIC_RECV events exist only
    for deferred drains."""
    net = sim.net
    H = net.rq_head.shape[0]
    dev = net.rq_head.device
    lane = torch.arange(H, device=dev)
    now = popped.time
    R = cfg.router_ring

    # -- arrival enqueue (ref: router_enqueue, router.c:104-125) ------
    arr = popped.valid & (popped.kind == EventKind.PACKET)
    was_empty = net.rq_count == 0
    # queue-manager admission (ref: QueueManagerHooks enqueue):
    # CODEL admits to ring capacity (a full ring is an honest overflow
    # error — CoDel itself drops at dequeue); SINGLE holds one packet
    # (router_queue_single.c); STATIC drop-tails at capacity
    # (router_queue_static.c) — both drop the arrival, counted, with
    # the audit trail recorded.
    codel = cfg.router_qdisc == RouterQ.CODEL
    cap = 1 if cfg.router_qdisc == RouterQ.SINGLE else R
    aok = arr & (net.rq_count < cap)
    lost = arr & ~aok if codel else torch.zeros_like(arr)
    apos = (net.rq_head + net.rq_count) % R
    awl = pf.wire_length(pf.proto_of(popped.words), popped.words[:, pf.W_LEN])
    arr_words = _set_col(popped.words, pf.W_STATUS, torch.where(
        aok, popped.words[:, pf.W_STATUS] | pf.PDS_ROUTER_ENQUEUED,
        popped.words[:, pf.W_STATUS]))
    net = net.replace(
        rq_src=set_row(net.rq_src, aok, apos, popped.src),
        rq_enq_ts=set_row(net.rq_enq_ts, aok, apos, popped.time),
        rq_words=set_row(net.rq_words, aok, apos, arr_words),
        rq_count=net.rq_count + aok.to(I32),
        rq_bytes=net.rq_bytes + torch.where(aok, awl, 0).to(I64),
        rq_overflow=net.rq_overflow + lost.sum(dtype=I32),
    )
    if net.rq_overflow_h is not None:
        net = net.replace(rq_overflow_h=net.rq_overflow_h + lost.to(I32))
    if not codel:
        qdrop = arr & ~aok
        net = net.replace(
            ctr_drop_codel=net.ctr_drop_codel + qdrop.to(I64),
            last_drop_status=torch.where(
                qdrop, popped.words[:, pf.W_STATUS] | pf.PDS_ROUTER_DROPPED,
                net.last_drop_status))
    # fused drain: idle queue served immediately; a busy queue already
    # has a drain in flight (nic_recv_pending invariant)
    kick = aok & was_empty & ~net.nic_recv_pending

    # -- drain one packet (deferred NIC_RECV event or fused kick) -----
    ev = popped.valid & (popped.kind == EventKind.NIC_RECV)
    mask = ev | kick
    net = net.replace(nic_recv_pending=net.nic_recv_pending & ~ev)
    net = refill_tokens(net, mask, now)

    bootstrap = now < cfg.bootstrap_end
    have = net.rq_count > 0
    can = bootstrap | (net.tb_recv_tokens >= pf.MTU)
    active = mask & have & can

    # pop head entry
    pos = torch.where(active, net.rq_head, R)
    posc = pos.clamp(0, R - 1).to(I64)
    e_src = net.rq_src[lane, posc]
    e_ts = net.rq_enq_ts[lane, posc]
    e_words = net.rq_words[lane, posc]
    wl = pf.wire_length(pf.proto_of(e_words), e_words[:, pf.W_LEN]).to(I64)
    bytes_after = net.rq_bytes - torch.where(active, wl, 0)
    net = net.replace(
        rq_head=torch.where(active, (net.rq_head + 1) % R, net.rq_head),
        rq_count=net.rq_count - active.to(I32),
        rq_bytes=bytes_after,
    )

    if not codel:
        # single/static managers dequeue without AQM
        # (ref: router_queue_single.c / router_queue_static.c)
        return _finish_recv_common(
            cfg, sim.replace(net=net), popped, buf, mask, active,
            torch.zeros_like(active), e_src, e_words, wl, now, H)

    # CoDel good/bad state (ref: router_queue_codel.c:161-196)
    sojourn = now - e_ts
    below = (sojourn < CODEL_TARGET) | (bytes_after < pf.MTU)
    ie = net.codel_interval_expire
    ok_to_drop = active & ~below & (ie != 0) & (now >= ie)
    new_ie = torch.where(
        active,
        torch.where(below, 0, torch.where(ie == 0, now + CODEL_INTERVAL, ie)),
        ie)
    # empty queue resets the interval state (codel.c:161-166)
    new_ie = torch.where(mask & ~have, 0, new_ie)

    dropping = net.codel_dropping
    # in DROP mode: leave it when delays are low again; drop while
    # now >= next_drop (codel.c:221-241)
    drop_in_dropmode = dropping & ok_to_drop & (now >= net.codel_next_drop)
    enter_drop = ~dropping & ok_to_drop
    drop_now = active & (drop_in_dropmode | enter_drop)

    sqrt_cnt = torch.sqrt(net.codel_drop_count.clamp(min=1).to(torch.float64))
    # control law (RFC 8289; see shadow_tpu/net/nic.py on the deviation
    # from the reference's formula)
    law_from_prev = net.codel_next_drop + (CODEL_INTERVAL / sqrt_cnt).to(I64)
    delta = net.codel_drop_count - net.codel_drop_count_last
    recently = now < net.codel_next_drop + 16 * CODEL_INTERVAL
    restart_count = torch.where(recently & (delta > 1), delta, 1)
    law_restart = now + (CODEL_INTERVAL / torch.sqrt(
        restart_count.clamp(min=1).to(torch.float64))).to(I64)

    new_dropping = torch.where(
        active,
        torch.where(dropping, dropping & ok_to_drop | drop_in_dropmode,
                    enter_drop),
        dropping)
    new_dropping = torch.where(mask & ~have, False, new_dropping)
    net = net.replace(
        codel_interval_expire=new_ie,
        codel_dropping=new_dropping,
        codel_drop_count=torch.where(
            drop_in_dropmode, net.codel_drop_count + 1,
            torch.where(enter_drop & active, restart_count,
                        net.codel_drop_count)).to(I32),
        codel_drop_count_last=torch.where(
            enter_drop & active, restart_count,
            net.codel_drop_count_last).to(I32),
        codel_next_drop=torch.where(
            drop_in_dropmode, law_from_prev,
            torch.where(enter_drop & active, law_restart,
                        net.codel_next_drop)),
        ctr_drop_codel=net.ctr_drop_codel + drop_now.to(I64),
    )

    delivered = active & ~drop_now
    return _finish_recv_common(
        cfg, sim.replace(net=net), popped, buf, mask, delivered, drop_now,
        e_src, e_words, wl, now, H)


def _finish_recv_common(cfg, sim, popped, buf, mask, delivered, drop_now,
                        e_src, e_words, wl, now, H):
    """Tail of the receive handler: delivery merge, token consumption,
    drain chaining."""
    net = sim.net
    dev = mask.device
    bootstrap = now < cfg.bootstrap_end
    net = net.replace(last_drop_status=torch.where(
        drop_now, e_words[:, pf.W_STATUS] | pf.PDS_ROUTER_DROPPED,
        net.last_drop_status))
    # merge loopback deliveries (kind=PACKET_LOCAL, disjoint lanes) into
    # one deliver_packet call
    local = popped.valid & (popped.kind == EventKind.PACKET_LOCAL)
    d_mask = delivered | local
    d_src = torch.where(local, popped.src, e_src)
    d_words = torch.where(local[:, None], popped.words, e_words)
    # audit: dequeued from the router and received by the interface
    d_words = _set_col(d_words, pf.W_STATUS, torch.where(
        delivered,
        d_words[:, pf.W_STATUS] | pf.PDS_ROUTER_DEQUEUED
        | pf.PDS_RCV_INTERFACE_RECEIVED,
        d_words[:, pf.W_STATUS]))
    sim = sim.replace(net=net)
    sim, buf = deliver_packet(cfg, sim, d_mask, d_src, d_words, now, buf)
    net = sim.net

    # consume rx tokens for delivered packets only (CoDel drops happen
    # inside router_dequeue, before bandwidth accounting)
    consume = delivered & ~bootstrap
    net = net.replace(tb_recv_tokens=(
        net.tb_recv_tokens - torch.where(consume, wl, 0)).clamp(min=0))

    # continue or re-arm
    more = net.rq_count > 0
    can_next = bootstrap | (net.tb_recv_tokens >= pf.MTU)
    chain = mask & more & can_next
    wait = mask & more & ~can_next
    buf = emit(buf, chain, net.lane_id, now, EventKind.NIC_RECV,
               _empty_words(H, dev))
    buf = emit(buf, wait, net.lane_id, next_refill_time(now),
               EventKind.NIC_RECV, _empty_words(H, dev))
    net = net.replace(nic_recv_pending=net.nic_recv_pending | chain | wait)
    return sim.replace(net=net), buf


# ---------------------------------------------------------------------
# send: drain socket output rings through the tx token bucket
# ---------------------------------------------------------------------

def _qdisc_select(cfg: NetConfig, net: NetState):
    """Pick the next socket slot to send from per host ([H] -> slot or
    -1). FIFO = lowest head-packet priority (app ordering,
    network_interface.c:484-517); RR = cyclic from the per-host cursor
    (network_interface.c:465-483)."""
    nonempty = net.out_count > 0
    if cfg.qdisc == QDisc.RR:
        S = nonempty.shape[1]
        key = (torch.arange(S, device=nonempty.device)[None, :]
               - net.rr_ptr[:, None].to(I64)) % S
    else:
        BO = net.out_words.shape[2]
        head_pos = (net.out_head % BO).to(I64)
        key = torch.gather(net.out_priority, 2, head_pos[..., None])[..., 0]
    key = torch.where(nonempty, key, torch.iinfo(key.dtype).max)
    sel = key.argmin(dim=1).to(I32)
    found = nonempty.any(dim=1)
    return torch.where(found, sel, -1)


def handle_nic_send(cfg: NetConfig, sim, popped, buf, caps=None):
    """Drain up to cfg.nic_drain packets chosen by the qdisc; chain a
    same-time NIC_SEND event if more remain sendable (ref:
    _networkinterface_sendPackets, network_interface.c:519-579).

    Acts on kind=NIC_SEND events plus lanes whose nic_send_now bit was
    set earlier in this micro-step (the fused form of the reference's
    synchronous networkinterface_wantsSend). `caps`
    (compile/specialize.py Capabilities, None = full program) trims the
    loss draw (see _drain_one)."""
    net = sim.net
    H = net.rq_head.shape[0]
    dev = net.rq_head.device
    ev = popped.valid & (popped.kind == EventKind.NIC_SEND)
    mask = ev | net.nic_send_now
    now = popped.time

    net = net.replace(nic_send_pending=net.nic_send_pending & ~ev,
                      nic_send_now=torch.zeros((H,), dtype=torch.bool,
                                               device=dev))
    net = refill_tokens(net, mask, now)
    sim = sim.replace(net=net)

    bootstrap = now < cfg.bootstrap_end
    for i in range(max(int(cfg.nic_drain), 1)):
        sim, buf, drained = _drain_one(cfg, sim, buf, mask, now, bootstrap,
                                       skip_if_idle=i > 0, caps=caps)
        if not drained:
            break

    # continue or re-arm (guard against lanes that already have a
    # deferred NIC_SEND in flight)
    net = sim.net
    more = (net.out_count > 0).any(dim=1)
    can_next = bootstrap | (net.tb_send_tokens >= pf.MTU)
    chain = mask & more & can_next & ~net.nic_send_pending
    wait = mask & more & ~can_next & ~net.nic_send_pending
    buf = emit(buf, chain, net.lane_id, now, EventKind.NIC_SEND,
               _empty_words(H, dev))
    buf = emit(buf, wait, net.lane_id, next_refill_time(now),
               EventKind.NIC_SEND, _empty_words(H, dev))
    net = net.replace(nic_send_pending=net.nic_send_pending | chain | wait)
    return sim.replace(net=net), buf


def _drain_one(cfg: NetConfig, sim, buf, mask, now, bootstrap,
               skip_if_idle=False, caps=None):
    """One qdisc selection + wire transmission across all lanes (the
    loop body of the reference's send loop). Lanes with no sendable
    packet (or no tokens) are masked off and unchanged.

    A dropped loss capability (compile/specialize.py: reliability
    all-ones, no fault plan touching it) skips the Bernoulli draw and
    the drop bookkeeping. Bit-identical: the draw's counter advance is
    data-independent (rng.uniform returns counters + 1 mod 2**32), so
    the trimmed path advances it arithmetically, masked to 32 bits as
    the draw does, and every later draw lands on the same counter; with
    rel == 1.0 the drop mask is constant False and the skipped updates
    are the identity.

    Returns (sim, buf, drained). With `skip_if_idle`, one host read
    checks for an active lane first; when there is none the pass is
    the identity and is skipped (drained False) — and so is every
    later pass of this micro-step, since nothing changed."""
    net = sim.net
    H = net.rq_head.shape[0]
    lane = torch.arange(H, device=net.rq_head.device)
    can = bootstrap | (net.tb_send_tokens >= pf.MTU)
    sel = _qdisc_select(cfg, net)
    active = mask & can & (sel >= 0)
    if skip_if_idle and not bool(active.any()):
        return sim, buf, False

    # pop the head packet of the selected socket's output ring
    BO = net.out_words.shape[2]
    S = net.out_count.shape[1]
    selc = sel.clamp(0, S - 1).to(I64)
    hpos = (net.out_head[lane, selc] % BO).to(I64)
    words = net.out_words[lane, selc, hpos]              # [H, W]
    length = words[:, pf.W_LEN]
    proto = pf.proto_of(words)
    dst_ip = ip_from_word(words[:, pf.W_DSTIP])

    net = net.replace(
        out_head=set_hs(net.out_head, active, sel,
                        (net.out_head[lane, selc] + 1) % BO),
        out_count=set_hs(net.out_count, active, sel,
                         net.out_count[lane, selc] - 1),
        out_bytes=set_hs(net.out_bytes, active, sel,
                         net.out_bytes[lane, selc] - length),
    )
    # draining freed output capacity: restore WRITABLE for datagram
    # sockets (ref: descriptor_adjustStatus -> epoll EPOLLOUT)
    is_dgram = active & (net.sk_type[lane, selc] == SocketType.UDP)
    net = set_writable(net, is_dgram, sel, True)
    if cfg.qdisc == QDisc.RR:
        net = net.replace(rr_ptr=torch.where(active, (sel + 1) % S,
                                             net.rr_ptr))

    # volatile TCP header fields are stamped at wire time
    # (ref: tcp_networkInterfaceIsAboutToSendPacket, tcp.c:1090-1120)
    if sim.tcp is not None:
        tmask = active & (proto == pf.PROTO_TCP)
        words = tcp_mod.stamp_at_wire(net, sim.tcp, tmask, sel, words, now)
        # a departing ACK cancels the pending delayed ACK
        acked = tmask & ((pf.tcp_flags_of(words) & pf.TCPF_ACK) != 0)
        sim = sim.replace(
            tcp=tcp_mod.wire_ack_departed(sim.tcp, acked, sel))

    wl = pf.wire_length(proto, length).to(I64)
    GH = net.host_ip.shape[0]
    my_ip = net.host_ip[net.lane_id.to(I64)]
    local = active & ((dst_ip == my_ip) | (dst_ip >> 24 == 127))
    remote = active & ~local

    # audit: the packet left the interface (packet.h PDS trail)
    words = _set_col(words, pf.W_STATUS, torch.where(
        active, words[:, pf.W_STATUS] | pf.PDS_SND_INTERFACE_SENT,
        words[:, pf.W_STATUS]))
    net = _capture(cfg, net, active, net.lane_id, words, now, direction=0)

    # loopback: 1ns self delivery, no tokens (network_interface.c:546-554)
    buf = emit(buf, local, net.lane_id, now + 1, EventKind.PACKET_LOCAL,
               words)

    # remote: reliability draw + latency lookup (worker.c:243-304)
    dsth = host_of_ip(net, dst_ip)
    known = remote & (dsth >= 0)
    lossless = loss_trimmed(caps)
    if lossless:
        net = net.replace(rng_ctr=(net.rng_ctr + remote.to(I64)) & rng.M32)
    else:
        u, ctr = rng.uniform(net.rng_keys, net.rng_ctr)
        net = net.replace(rng_ctr=torch.where(remote, ctr, net.rng_ctr))
    vsrc = net.vertex_of_host[net.lane_id.to(I64)].to(I64)
    vdst = net.vertex_of_host[dsth.clamp(0, GH - 1).to(I64)].to(I64)
    lat = net.latency_ns[vsrc, vdst]
    if lossless:
        send = known
    else:
        rel = net.reliability[vsrc, vdst]
        drop = known & ~bootstrap & (length > 0) & (u > rel)
        send = known & ~drop
    words = _set_col(words, pf.W_STATUS, torch.where(
        send, words[:, pf.W_STATUS] | pf.PDS_INET_SENT,
        words[:, pf.W_STATUS]))
    buf = emit(buf, send, dsth, now + lat, EventKind.PACKET, words)

    if cfg.track_paths:
        # per-path packet counters (ref: topology.c:2053-2063 — every
        # routing lookup of a send, dropped or not; loopback never
        # reaches the topology). The reference's scatter-add drops
        # out-of-range indices; so does the in-range mask here.
        P = net.ctr_path_packets.shape
        ok = known & (vsrc >= 0) & (vsrc < P[0]) & (vdst >= 0) & (vdst < P[1])
        net = net.replace(ctr_path_packets=net.ctr_path_packets.index_put(
            (vsrc.clamp(0, P[0] - 1), vdst.clamp(0, P[1] - 1)),
            ok.to(I64), accumulate=True))

    is_retx = (words[:, pf.W_STATUS] & pf.PDS_SND_TCP_RETRANSMITTED) != 0
    if not lossless:
        net = net.replace(
            last_drop_status=torch.where(
                drop, words[:, pf.W_STATUS] | pf.PDS_INET_DROPPED,
                net.last_drop_status),
            ctr_drop_reliability=net.ctr_drop_reliability + drop.to(I64))
    net = net.replace(
        ctr_drop_nosocket=net.ctr_drop_nosocket + (remote & ~known).to(I64),
        ctr_tx_packets=net.ctr_tx_packets + active.to(I64),
        ctr_tx_bytes=net.ctr_tx_bytes + torch.where(active, wl, 0),
        ctr_tx_data_bytes=net.ctr_tx_data_bytes
        + torch.where(active, length, 0).to(I64),
        ctr_tx_retx_bytes=net.ctr_tx_retx_bytes
        + torch.where(active & is_retx, wl, 0),
        tb_send_tokens=(net.tb_send_tokens
                        - torch.where(remote & ~bootstrap, wl, 0)).clamp(min=0),
    )
    return sim.replace(net=net), buf, True


def notify_wants_send(sim, buf, mask, now):
    """App enqueued data on a socket: flag the lane so the send drain
    at the end of this micro-step's pipeline picks it up."""
    net = sim.net.replace(nic_send_now=sim.net.nic_send_now | mask)
    return sim.replace(net=net), buf
