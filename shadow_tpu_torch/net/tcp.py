"""Simulated TCP as batched struct-of-arrays state transitions (PyTorch
port of shadow_tpu/net/tcp.py).

All sockets' TCP state lives in [H,S]-shaped tensors; packet
processing, the state machine (ref: tcp.c:1777-2100), congestion
control (tcp_cong.py), RTO/RTT estimation (ref: tcp.c:991-1026) and
flush (ref: _tcp_flush, tcp.c:1121-...) are masked batch updates over
one (host, socket) pair per lane per micro-step. The design choices
are the reference's, listed in its module docstring: non-wrapping
int32 sequence space from ISS 0, retransmission regenerated from the
[snd_una, snd_end) byte range, OO_RANGES reassembly ranges with the
SACK_RANGES lowest advertised, listener children as separate socket
slots, cwnd/ssthresh in packets, zero-window persist probes on the RTO
timer, the reference's delayed-ACK scheme and buffer autotuning.
Volatile header fields (ack, window, timestamps, SACK) are stamped when
the NIC emits the packet (stamp_at_wire).

Every function here is a masked batch update that reads nothing back
to the host: the reference's lax.fori_loop over FLUSH_SEGMENTS is a
Python loop of FLUSH_SEGMENTS passes, each the identity on lanes with
nothing to send.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from shadow_tpu_torch.core import simtime
from shadow_tpu_torch.core.events import (
    NWORDS, EventKind, _first_true, _Replace, as_tensor, emit, u32_to_i32)
from shadow_tpu_torch.net import packetfmt as pf
from shadow_tpu_torch.net import tcp_cong as cong
from shadow_tpu_torch.net.rings import gather_hs, set_hs, set_ring
from shadow_tpu_torch.net.sockets import (
    set_writable, sk_connect_peer, sk_create, sk_enqueue_out)
from shadow_tpu_torch.net.state import (
    NetConfig, NetState, SocketFlags, SocketType, host_of_ip)

I32 = torch.int32
I64 = torch.int64

MSS = pf.MTU - pf.HDR_TCP          # 1434 payload bytes per segment
OO_RANGES = 4                      # receiver reassembly ranges
ACCEPT_QUEUE = 4                   # pending-children ring per listener
FLUSH_SEGMENTS = 4                 # max segments packetized per flush call
INIT_CWND = 1                      # packets (tcp_cong_reno.c:176-180)
RESTART_CWND = 10                  # cwnd after an RTO
INIT_SSTHRESH = 0x7FFFFFFF


def initial_cwnd(cfg):
    """Initial congestion window in packets (--tcp-windows; 0 = the
    reference's effective 1)."""
    return cfg.tcp_windows or INIT_CWND


def initial_ssthresh(cfg):
    """Initial slow-start threshold in packets (--tcp-ssthresh; 0 =
    discover via loss)."""
    return cfg.tcp_ssthresh or INIT_SSTHRESH


RTO_MIN_MS = 200
RTO_MAX_MS = 60_000
RTO_INIT_MS = 1_000
MAX_BACKOFF = 8                    # cap exponential backoff shift
TIMEWAIT_NS = 60 * simtime.ONE_SECOND  # ref: definitions.h:198

SACK_RANGES = 3                    # advertised SACK list length

# delayed-ACK scheme (ref: tcp.c:2066-2091)
DACK_QUICK_LIMIT = 1000
DACK_QUICK_NS = 1 * simtime.ONE_MILLISECOND
DACK_SLOW_NS = 5 * simtime.ONE_MILLISECOND

# buffer autotuning bounds (ref: definitions.h:101-147)
TCP_WMEM_MAX = 4194304
TCP_RMEM_MAX = 6291456
SEND_BUFFER_MIN = 16384
RECV_BUFFER_MIN = 87380
SNDMEM_SKB = 2404

_I32_MAX = 2**31 - 1


class TcpSt:
    """Connection states (ref: tcp.c:42-47)."""

    CLOSED = 0
    LISTEN = 1
    SYN_SENT = 2
    SYN_RCVD = 3
    ESTABLISHED = 4
    FIN_WAIT_1 = 5
    FIN_WAIT_2 = 6
    CLOSING = 7
    TIME_WAIT = 8
    CLOSE_WAIT = 9
    LAST_ACK = 10


@dataclass
class TcpState(_Replace):
    """All TCP sockets' protocol state, [H,S] per-socket columns (field
    names, shapes and dtypes are the reference's)."""

    st: torch.Tensor           # [H,S] i32 TcpSt
    snd_una: torch.Tensor      # [H,S] i32 oldest unacked
    snd_nxt: torch.Tensor      # [H,S] i32 next to send
    snd_max: torch.Tensor      # [H,S] i32 highest seq ever sent
    snd_end: torch.Tensor      # [H,S] i32 end of app-buffered data
    snd_wnd: torch.Tensor      # [H,S] i32 peer advertised window
    fin_pending: torch.Tensor  # [H,S] bool app called close
    dup_acks: torch.Tensor     # [H,S] i32
    cwnd: torch.Tensor         # [H,S] i32 packets
    ssthresh: torch.Tensor     # [H,S] i32 packets
    ca_acc: torch.Tensor       # [H,S] i32 congestion-avoidance accumulator
    in_recovery: torch.Tensor  # [H,S] bool fast recovery
    recover: torch.Tensor      # [H,S] i32 recovery point
    cub_wmax: torch.Tensor     # [H,S] i32 cubic window before last loss
    cub_epoch_ms: torch.Tensor  # [H,S] i32 cubic epoch start (-1 unset)
    sack_l: torch.Tensor       # [H,S,SACK_RANGES] i32 peer-sacked ranges
    sack_r: torch.Tensor       # [H,S,SACK_RANGES] i32
    rcv_nxt: torch.Tensor      # [H,S] i32
    app_rbytes: torch.Tensor   # [H,S] i32 in-order bytes awaiting recv
    fin_rcvd: torch.Tensor     # [H,S] bool
    fin_rseq: torch.Tensor     # [H,S] i32 seq of peer FIN
    oo_l: torch.Tensor         # [H,S,OO_RANGES] i32 out-of-order [l, r)
    oo_r: torch.Tensor         # [H,S,OO_RANGES] i32
    ts_recent: torch.Tensor    # [H,S] i32 last peer tsval
    srtt_ms: torch.Tensor      # [H,S] i32 (-1 = no sample yet)
    rttvar_ms: torch.Tensor    # [H,S] i32
    rto_ms: torch.Tensor       # [H,S] i32
    backoff: torch.Tensor      # [H,S] i32 exponential backoff shift
    rtx_expire: torch.Tensor   # [H,S] i64 deadline (INVALID = disarmed)
    rtx_event: torch.Tensor    # [H,S] bool a current-gen event is queued
    rtx_fire: torch.Tensor     # [H,S] i64 fire time of that event
    rtx_gen: torch.Tensor      # [H,S] i32 current generation
    parent: torch.Tensor       # [H,S] i32 child -> listener slot (-1)
    aq: torch.Tensor           # [H,S,ACCEPT_QUEUE] i32 ready child slots
    aq_head: torch.Tensor      # [H,S] i32
    aq_count: torch.Tensor     # [H,S] i32
    flush_pending: torch.Tensor   # [H,S] bool a TCP_FLUSH is queued
    dack_scheduled: torch.Tensor  # [H,S] bool a DACK timer is queued
    dack_counter: torch.Tensor    # [H,S] i32 ACK-worthy arrivals pending
    dack_gen: torch.Tensor        # [H,S] i32 stale-event guard
    quick_acks: torch.Tensor      # [H,S] i32 quick ACKs sent so far
    at_init_done: torch.Tensor    # [H,S] bool initial BDP sizing done
    at_copied: torch.Tensor       # [H,S] i32 app bytes copied this RTT
    at_space: torch.Tensor        # [H,S] i32 DRS space watermark
    at_last: torch.Tensor         # [H,S] i64 last DRS reset time
    retx_segs: torch.Tensor    # [H] i64 segments retransmitted
    fr_entries: torch.Tensor   # [H] i64 fast-recovery entries
    drop_oo_full: torch.Tensor  # [H] i64 segs dropped, reassembly full
    drop_rwin: torch.Tensor    # [H] i64 segs dropped, recv buffer full
    probes_sent: torch.Tensor  # [H] i64 zero-window persist probes

    @staticmethod
    def create(num_hosts: int, sockets_per_host: int,
               init_cwnd: int = INIT_CWND,
               init_ssthresh: int = INIT_SSTHRESH,
               device=None) -> "TcpState":
        H, S = num_hosts, sockets_per_host

        def full(shape, v, dt):
            return torch.full(shape, v, dtype=dt, device=device)

        def zi():
            return full((H, S), 0, I32)

        def zb():
            return full((H, S), False, torch.bool)

        def zh():
            return full((H,), 0, I64)

        return TcpState(
            st=zi(), snd_una=zi(), snd_nxt=zi(), snd_max=zi(), snd_end=zi(),
            snd_wnd=full((H, S), MSS, I32),
            fin_pending=zb(), dup_acks=zi(),
            cwnd=full((H, S), init_cwnd, I32),
            ssthresh=full((H, S), init_ssthresh, I32),
            ca_acc=zi(), in_recovery=zb(), recover=zi(),
            cub_wmax=zi(), cub_epoch_ms=full((H, S), -1, I32),
            sack_l=full((H, S, SACK_RANGES), 0, I32),
            sack_r=full((H, S, SACK_RANGES), 0, I32),
            rcv_nxt=zi(), app_rbytes=zi(), fin_rcvd=zb(), fin_rseq=zi(),
            oo_l=full((H, S, OO_RANGES), 0, I32),
            oo_r=full((H, S, OO_RANGES), 0, I32),
            ts_recent=zi(),
            srtt_ms=full((H, S), -1, I32),
            rttvar_ms=zi(),
            rto_ms=full((H, S), RTO_INIT_MS, I32),
            backoff=zi(),
            rtx_expire=full((H, S), simtime.INVALID, I64),
            rtx_event=zb(),
            rtx_fire=full((H, S), simtime.INVALID, I64),
            rtx_gen=zi(),
            parent=full((H, S), -1, I32),
            aq=full((H, S, ACCEPT_QUEUE), 0, I32),
            aq_head=zi(), aq_count=zi(),
            flush_pending=zb(),
            dack_scheduled=zb(), dack_counter=zi(), dack_gen=zi(),
            quick_acks=zi(),
            at_init_done=zb(), at_copied=zi(), at_space=zi(),
            at_last=full((H, S), 0, I64),
            retx_segs=zh(), fr_entries=zh(), drop_oo_full=zh(),
            drop_rwin=zh(), probes_sent=zh(),
        )


# ---------------------------------------------------------------------
# small helpers
# ---------------------------------------------------------------------

def _ms(now):
    return torch.div(now, simtime.ONE_MILLISECOND,
                     rounding_mode="floor").to(I32)


def _set(tcp: TcpState, field: str, mask, slot, value):
    return tcp.replace(**{field: set_hs(getattr(tcp, field), mask, slot,
                                        value)})


def _slot_words(slot, *more):
    """[H, NWORDS] timer-event words: slot in word 0, `more` after."""
    H = slot.shape[0]
    w = torch.zeros((H, NWORDS), dtype=I32, device=slot.device)
    w[:, 0] = slot.to(I32)
    for i, v in enumerate(more, start=1):
        w[:, i] = v
    return w


def _seg_words(net: NetState, mask, slot, flags, seq, length, payref=None):
    """Build [H, NWORDS] TCP packet words addressed to (slot)'s peer.
    Volatile fields (ack/win/ts) are left zero for stamp_at_wire."""
    H = mask.shape[0]
    src_port = gather_hs(net.sk_bound_port, slot)
    dst_port = gather_hs(net.sk_peer_port, slot)
    dst_ip = gather_hs(net.sk_peer_ip, slot)
    words = torch.zeros((H, NWORDS), dtype=I32, device=mask.device)
    words[:, pf.W_PROTO] = pf.PROTO_TCP | (flags << 8)
    words[:, pf.W_LEN] = length
    words[:, pf.W_PORTS] = pf.pack_ports(src_port, dst_port)
    words[:, pf.W_SEQ] = seq
    words[:, pf.W_PAYREF] = pf.PAYREF_NONE if payref is None else payref
    words[:, pf.W_DSTIP] = u32_to_i32(dst_ip & 0xFFFFFFFF)
    # audit trail: every TCP segment is created and throttled-queued
    # (ref: packet.h PDS trail; throttledOutput, tcp.c:222-230)
    words[:, pf.W_STATUS] = (pf.PDS_SND_CREATED
                             | pf.PDS_SND_TCP_ENQUEUE_THROTTLED
                             | pf.PDS_SND_SOCKET_BUFFERED)
    return words


def _adv_window(net: NetState, tcp: TcpState, slot):
    """Receive window to advertise: buffer capacity minus bytes held for
    the app. Out-of-order parked bytes deliberately do not shrink it
    (the reference's monotonic-window-edge rule, which keeps dup-ACKs
    recognisable at the sender)."""
    free = gather_hs(net.sk_rcvbuf, slot) - gather_hs(tcp.app_rbytes, slot)
    return free.clamp(min=0)


def sack_advert(tcp: TcpState, slot):
    """The SACK list a departing packet on (lane, slot) advertises: the
    SACK_RANGES lowest parked reassembly ranges, ascending by left
    edge. Returns ((l1,r1),(l2,r2),(l3,r3)), each [H] i32, zeros where
    absent. Ties take the lowest range index, as jnp.argmin does."""
    H = slot.shape[0]
    rows = torch.arange(H, device=slot.device)
    S = tcp.oo_l.shape[1]
    sc = slot.clamp(0, S - 1).to(I64)
    ool = tcp.oo_l[rows, sc]                            # [H, NR]
    oor = tcp.oo_r[rows, sc]
    key = torch.where(oor > ool, ool, _I32_MAX)
    cols = torch.arange(key.shape[1], device=slot.device)
    out = []
    for _ in range(SACK_RANGES):
        pick = key.argmin(dim=1)                        # [H]
        have = key[rows, pick] != _I32_MAX
        out.append((torch.where(have, ool[rows, pick], 0),
                    torch.where(have, oor[rows, pick], 0)))
        # exclude the picked range from the next round
        key = torch.where(cols[None, :] == pick[:, None], _I32_MAX, key)
    return tuple(out)


def stamp_at_wire(net: NetState, tcp: TcpState, mask, slot, words, now):
    """Fill ack / advertised window / timestamps / SACK on a departing
    TCP packet (ref: tcp_networkInterfaceIsAboutToSendPacket,
    tcp.c:1090-1120)."""
    w = words.clone()

    def put(col, val):
        w[:, col] = torch.where(mask, val, w[:, col])

    put(pf.W_ACK, gather_hs(tcp.rcv_nxt, slot))
    put(pf.W_WIN, _adv_window(net, tcp, slot))
    put(pf.W_TSVAL, _ms(now))
    put(pf.W_TSECHO, gather_hs(tcp.ts_recent, slot))
    cols = ((pf.W_SACKL, pf.W_SACKR), (pf.W_SACKL2, pf.W_SACKR2),
            (pf.W_SACKL3, pf.W_SACKR3))
    for (cl, cr), (sl, sr) in zip(cols, sack_advert(tcp, slot)):
        put(cl, sl)
        put(cr, sr)
    return w


def _enqueue_seg(sim, buf, mask, slot, flags, seq, length, now,
                 retransmit=False):
    """Push one segment on the socket output ring and kick the NIC.
    Returns (sim, buf, ok[H]); ok False when the ring/sndbuf was full
    (the segment was not queued — callers must not advance snd_nxt).
    `retransmit` marks the audit trail's retransmission stages."""
    from shadow_tpu_torch.net import nic

    words = _seg_words(sim.net, mask, slot, flags, seq, length)
    if retransmit:
        words[:, pf.W_STATUS] |= (pf.PDS_SND_TCP_ENQUEUE_RETRANSMIT
                                  | pf.PDS_SND_TCP_DEQUEUE_RETRANSMIT
                                  | pf.PDS_SND_TCP_RETRANSMITTED)
    net, ok = sk_enqueue_out(sim.net, mask, slot, words)
    sim = sim.replace(net=net)
    sim, buf = nic.notify_wants_send(sim, buf, ok, now)
    return sim, buf, ok


def _arm_rtx(sim, buf, mask, slot, now):
    """Ensure an RTO deadline and a covering timer event exist (ref:
    _tcp_setRetransmitTimer). A deadline earlier than the in-flight
    event's fire time emits a replacement event under a bumped
    generation; the old event dies on the generation mismatch."""
    tcp = sim.tcp
    shift = gather_hs(tcp.backoff, slot).clamp(max=MAX_BACKOFF).to(I64)
    rto_ns = (gather_hs(tcp.rto_ms, slot).to(I64) << shift) \
        * simtime.ONE_MILLISECOND
    rto_ns = rto_ns.clamp(max=RTO_MAX_MS * simtime.ONE_MILLISECOND)
    deadline = now + rto_ns
    tcp = _set(tcp, "rtx_expire", mask, slot, deadline)
    in_flight = gather_hs(tcp.rtx_event, slot)
    earlier = mask & in_flight & (deadline < gather_hs(tcp.rtx_fire, slot))
    need_event = (mask & ~in_flight) | earlier
    gen = gather_hs(tcp.rtx_gen, slot) + 1
    tcp = _set(tcp, "rtx_gen", need_event, slot, gen)
    tcp = _set(tcp, "rtx_event", need_event, slot, True)
    tcp = _set(tcp, "rtx_fire", need_event, slot, deadline)
    sim = sim.replace(tcp=tcp)
    buf = emit(buf, need_event, sim.net.lane_id, deadline,
               EventKind.TCP_RTX_TIMER, _slot_words(slot, gen))
    return sim, buf


def _disarm_rtx(tcp: TcpState, mask, slot):
    """Clear the deadline; the in-flight event (if any) sees INVALID and
    dies silently."""
    return _set(tcp, "rtx_expire", mask, slot, simtime.INVALID)


def _sendable(st):
    """States in which stream data may be packetized."""
    return ((st == TcpSt.ESTABLISHED) | (st == TcpSt.CLOSE_WAIT)
            | (st == TcpSt.FIN_WAIT_1) | (st == TcpSt.LAST_ACK))


# ---------------------------------------------------------------------
# app-facing API (the process_emu_* surface for TCP,
# ref: host.c:1111-1359)
# ---------------------------------------------------------------------

def tcp_connect(cfg: NetConfig, sim, mask, slot, dst_ip, dst_port, now, buf):
    """Active open: SYN_SENT + SYN on the wire (ref: tcp_connectToPeer,
    host.c:1193-1230)."""
    slot = slot.to(I64)
    net = sk_connect_peer(sim.net, mask, slot, dst_ip, dst_port)
    sim = sim.replace(net=net)
    tcp = sim.tcp
    tcp = _set(tcp, "st", mask, slot, TcpSt.SYN_SENT)
    tcp = _set(tcp, "snd_una", mask, slot, 0)
    tcp = _set(tcp, "snd_nxt", mask, slot, 1)
    tcp = _set(tcp, "snd_max", mask, slot, 1)
    tcp = _set(tcp, "snd_end", mask, slot, 1)
    sim = sim.replace(tcp=tcp)
    sim, buf, _ = _enqueue_seg(sim, buf, mask, slot, pf.TCPF_SYN, 0, 0, now)
    return _arm_rtx(sim, buf, mask, slot, now)


def tcp_listen(sim, mask, slot):
    """Passive open on a bound socket (ref: host_listenForPeer)."""
    return sim.replace(tcp=_set(sim.tcp, "st", mask, slot, TcpSt.LISTEN))


def tcp_accept(sim, mask, slot):
    """Pop one established child from the listener's accept queue.
    Returns (sim, got[H], child_slot[H])."""
    slot = slot.to(I64)
    tcp = sim.tcp
    cnt = gather_hs(tcp.aq_count, slot)
    head = gather_hs(tcp.aq_head, slot)
    got = mask & (cnt > 0)
    H, S = tcp.aq_head.shape
    lane = torch.arange(H, device=mask.device)
    sc = slot.clamp(0, S - 1).to(I64)
    child = tcp.aq[lane, sc, head.clamp(0, ACCEPT_QUEUE - 1).to(I64)]
    child = torch.where(got, child, -1)
    tcp = _set(tcp, "aq_head", got, slot, (head + 1) % ACCEPT_QUEUE)
    tcp = _set(tcp, "aq_count", got, slot, cnt - 1)
    # listener readable while children remain queued
    drained = got & (cnt - 1 == 0)
    flags = gather_hs(sim.net.sk_flags, slot)
    net = sim.net.replace(
        sk_flags=set_hs(sim.net.sk_flags, drained, slot,
                        flags & ~SocketFlags.READABLE))
    return sim.replace(net=net, tcp=tcp), got, child


def tcp_send(cfg: NetConfig, sim, mask, slot, nbytes, now, buf):
    """Append nbytes of stream data (ref: tcp_sendUserData,
    tcp.c:2126-2190), up to the send-buffer limit. Returns (sim, buf,
    accepted[H] bytes)."""
    slot = slot.to(I64)
    tcp = sim.tcp
    st = gather_hs(tcp.st, slot)
    can = mask & ((st == TcpSt.ESTABLISHED) | (st == TcpSt.CLOSE_WAIT)
                  | (st == TcpSt.SYN_SENT) | (st == TcpSt.SYN_RCVD))
    una = gather_hs(tcp.snd_una, slot)
    end = gather_hs(tcp.snd_end, slot)
    sndbuf = gather_hs(sim.net.sk_sndbuf, slot)
    room = (sndbuf - (end - una)).clamp(min=0)
    accepted = torch.where(
        can, torch.minimum(as_tensor(nbytes, I32, mask.device), room), 0)
    tcp = _set(tcp, "snd_end", can, slot, end + accepted)
    # stream buffer exhausted: drop WRITABLE until ACK progress frees room
    bfull = can & (room - accepted <= 0)
    sim = sim.replace(tcp=tcp, net=set_writable(sim.net, bfull, slot, False))
    sim, buf = tcp_flush(cfg, sim, mask, slot, now, buf)
    return sim, buf, accepted


def tcp_recv(sim, mask, slot, maxbytes, now, buf):
    """Consume in-order received bytes (ref: tcp_receiveUserData,
    tcp.c:2192-...). Returns (sim, buf, nread[H], eof[H]). A window
    update ACK goes out only when the read reopens a constrained window
    (was < 2 MSS, grew by >= 1 MSS): receiver silly-window avoidance."""
    slot = slot.to(I64)
    tcp = sim.tcp
    net = sim.net
    win_before = _adv_window(net, tcp, slot)
    avail = gather_hs(tcp.app_rbytes, slot)
    nread = torch.where(
        mask, torch.minimum(as_tensor(maxbytes, I32, mask.device), avail), 0)
    tcp = _set(tcp, "app_rbytes", mask, slot, avail - nread)

    # receive-buffer autotuning (Linux DRS; ref: tcp.c:535-564)
    at_on = mask & net.autotune_rcv & (nread > 0)
    copied = gather_hs(tcp.at_copied, slot) + nread
    space = torch.maximum(2 * copied, gather_hs(tcp.at_space, slot))
    cur = gather_hs(net.sk_rcvbuf, slot)
    srtt = gather_hs(tcp.srtt_ms, slot)
    my_down = net.bw_down_kibps[net.lane_id.to(I64)]
    max_rmem = torch.div(my_down * 1024 * srtt.clamp(min=0).to(I64), 1000,
                         rounding_mode="floor").clamp(TCP_RMEM_MAX,
                                                      10 * TCP_RMEM_MAX)
    growing = at_on & (space > cur)
    tcp = _set(tcp, "at_space", growing, slot, space)
    new_size = torch.minimum(space.to(I64), max_rmem).to(I32)
    net = net.replace(sk_rcvbuf=set_hs(
        net.sk_rcvbuf, growing & (new_size > cur), slot, new_size))
    tcp = _set(tcp, "at_copied", at_on, slot, copied)
    last = gather_hs(tcp.at_last, slot)
    tcp = _set(tcp, "at_last", at_on & (last == 0), slot, now)
    rtt_ns = srtt.clamp(min=0).to(I64) * simtime.ONE_MILLISECOND
    reset = at_on & (last > 0) & (srtt > 0) & (now - last > rtt_ns)
    tcp = _set(tcp, "at_last", reset, slot, now)
    tcp = _set(tcp, "at_copied", reset, slot, 0)
    sim = sim.replace(net=net)
    eof = mask & gather_hs(tcp.fin_rcvd, slot) & (avail - nread == 0) & (
        gather_hs(tcp.rcv_nxt, slot) > gather_hs(tcp.fin_rseq, slot))
    drained = mask & (avail - nread == 0) & ~eof
    flags = gather_hs(sim.net.sk_flags, slot)
    net = sim.net.replace(
        sk_flags=set_hs(sim.net.sk_flags, drained, slot,
                        flags & ~SocketFlags.READABLE))
    sim = sim.replace(net=net, tcp=tcp)
    win_after = _adv_window(net, tcp, slot)
    update = mask & (win_before < 2 * MSS) & (win_after - win_before >= MSS)
    sim, buf, _ = _enqueue_seg(sim, buf, update, slot, pf.TCPF_ACK,
                               gather_hs(tcp.snd_nxt, slot), 0, now)
    return sim, buf, nread, eof


def tcp_close(cfg: NetConfig, sim, mask, slot, now, buf):
    """Active/passive close (ref: tcp_close, tcp.c:604-699): mark the
    FIN pending; flush emits it once all data is out."""
    slot = slot.to(I64)
    tcp = sim.tcp
    st = gather_hs(tcp.st, slot)
    # buffered stream data exists iff snd_end advanced past the SYN
    has_data = gather_hs(tcp.snd_end, slot) > 1
    to_finwait = mask & ((st == TcpSt.ESTABLISHED) | (st == TcpSt.SYN_RCVD))
    to_lastack = mask & (st == TcpSt.CLOSE_WAIT)
    # close during active open with data already submitted: defer —
    # the FIN_WAIT_1 transition happens when the SYN|ACK establishes
    deferred = mask & (st == TcpSt.SYN_SENT) & has_data
    # a never-connected, listening or empty-handshake socket is freed
    direct = mask & ((st == TcpSt.CLOSED) | (st == TcpSt.LISTEN)
                     | ((st == TcpSt.SYN_SENT) & ~has_data))
    tcp = _set(tcp, "st", to_finwait, slot, TcpSt.FIN_WAIT_1)
    tcp = _set(tcp, "st", to_lastack, slot, TcpSt.LAST_ACK)
    tcp = _set(tcp, "fin_pending", to_finwait | to_lastack | deferred,
               slot, True)
    sim = sim.replace(tcp=tcp)
    sim = _free_socket(cfg, sim, direct, slot)
    return tcp_flush(cfg, sim, mask & ~direct, slot, now, buf)


def _free_socket(cfg, sim, mask, slot):
    """Release a socket slot for reuse (ref: descriptor close + handle
    recycling, host.c:696-767)."""
    net = sim.net
    net = net.replace(
        sk_type=set_hs(net.sk_type, mask, slot, 0),
        sk_flags=set_hs(net.sk_flags, mask, slot, 0),
        sk_bound_ip=set_hs(net.sk_bound_ip, mask, slot, 0),
        sk_bound_port=set_hs(net.sk_bound_port, mask, slot, 0),
        sk_peer_ip=set_hs(net.sk_peer_ip, mask, slot, 0),
        sk_peer_port=set_hs(net.sk_peer_port, mask, slot, 0),
        # autotune may have grown the buffers; a recycled slot starts
        # from the configured defaults again
        sk_sndbuf=set_hs(net.sk_sndbuf, mask, slot, cfg.sndbuf),
        sk_rcvbuf=set_hs(net.sk_rcvbuf, mask, slot, cfg.rcvbuf),
        ctr_sk_free=net.ctr_sk_free + mask.to(I64),
    )
    tcp = sim.tcp
    for field, v in (
            ("st", 0), ("snd_una", 0), ("snd_nxt", 0), ("snd_max", 0),
            ("snd_end", 0), ("snd_wnd", MSS), ("fin_pending", False),
            ("dup_acks", 0), ("cwnd", initial_cwnd(cfg)),
            ("ssthresh", initial_ssthresh(cfg)), ("ca_acc", 0),
            ("in_recovery", False), ("cub_wmax", 0), ("cub_epoch_ms", -1),
            ("rcv_nxt", 0), ("app_rbytes", 0), ("fin_rcvd", False),
            ("ts_recent", 0), ("srtt_ms", -1), ("rttvar_ms", 0),
            ("rto_ms", RTO_INIT_MS), ("backoff", 0)):
        tcp = _set(tcp, field, mask, slot, v)
    tcp = _disarm_rtx(tcp, mask, slot)
    tcp = _set(tcp, "parent", mask, slot, -1)
    tcp = _set(tcp, "aq_head", mask, slot, 0)
    tcp = _set(tcp, "aq_count", mask, slot, 0)
    S = tcp.oo_l.shape[1]
    sel = (mask[:, None] & (torch.arange(S, device=mask.device)[None, :]
                            == slot[:, None]))[..., None]
    tcp = tcp.replace(
        oo_l=torch.where(sel, 0, tcp.oo_l),
        oo_r=torch.where(sel, 0, tcp.oo_r),
        sack_l=torch.where(sel, 0, tcp.sack_l),
        sack_r=torch.where(sel, 0, tcp.sack_r),
    )
    tcp = _set(tcp, "flush_pending", mask, slot, False)
    tcp = _set(tcp, "dack_scheduled", mask, slot, False)
    tcp = _set(tcp, "dack_counter", mask, slot, 0)
    # stale DACK events for a reused slot die on generation mismatch
    tcp = _set(tcp, "dack_gen", mask, slot, gather_hs(tcp.dack_gen, slot) + 1)
    for field in ("quick_acks", "at_copied", "at_space", "at_last"):
        tcp = _set(tcp, field, mask, slot, 0)
    tcp = _set(tcp, "at_init_done", mask, slot, False)
    return sim.replace(net=net, tcp=tcp)


# ---------------------------------------------------------------------
# flush: packetize allowed stream bytes onto the output ring
# (ref: _tcp_flush, tcp.c:1121-...)
# ---------------------------------------------------------------------

def _flush_one_segment(cfg, sim, buf, mask, slot, now):
    """Packetize one admissible MSS-bounded segment per masked lane (one
    iteration of _tcp_flush's drain-while-sendable loop)."""
    tcp = sim.tcp
    can_data = mask & _sendable(gather_hs(tcp.st, slot))
    una = gather_hs(tcp.snd_una, slot)
    nxt = gather_hs(tcp.snd_nxt, slot)
    end = gather_hs(tcp.snd_end, slot)
    cwnd_b = gather_hs(tcp.cwnd, slot) * MSS
    wnd = torch.minimum(cwnd_b, gather_hs(tcp.snd_wnd, slot))
    usable = una + wnd - nxt
    seg = torch.minimum((end - nxt).clamp(max=MSS), usable)
    do = can_data & (seg > 0)
    sim, buf, sent = _enqueue_seg(sim, buf, do, slot, pf.TCPF_ACK, nxt, seg,
                                  now)
    nxt_sent = nxt + torch.where(sent, seg, 0)
    tcp = _set(sim.tcp, "snd_nxt", sent, slot, nxt_sent)
    tcp = _set(tcp, "snd_max", sent, slot,
               torch.maximum(gather_hs(tcp.snd_max, slot), nxt_sent))
    return sim.replace(tcp=tcp), buf


def tcp_flush(cfg: NetConfig, sim, mask, slot, now, buf):
    for _ in range(FLUSH_SEGMENTS):
        sim, buf = _flush_one_segment(cfg, sim, buf, mask, slot, now)
    # FIN rides once all data is packetized (FIN seq == snd_end)
    tcp = sim.tcp
    nxt = gather_hs(tcp.snd_nxt, slot)
    end = gather_hs(tcp.snd_end, slot)
    fin = mask & gather_hs(tcp.fin_pending, slot) & (nxt == end)
    sim, buf, fsent = _enqueue_seg(sim, buf, fin, slot,
                                   pf.TCPF_FIN | pf.TCPF_ACK, nxt, 0, now)
    tcp = sim.tcp
    tcp = _set(tcp, "snd_nxt", fsent, slot, nxt + 1)
    tcp = _set(tcp, "snd_max", fsent, slot,
               torch.maximum(gather_hs(tcp.snd_max, slot), nxt + 1))
    # outstanding data must be covered by a retransmission deadline; a
    # zero peer window with data waiting and nothing in flight arms the
    # same timer as a persist timer
    una = gather_hs(tcp.snd_una, slot)
    nxt = gather_hs(tcp.snd_nxt, slot)
    outstanding = mask & (una < nxt)
    persist = mask & (una == nxt) & (gather_hs(tcp.snd_end, slot) > nxt) \
        & (gather_hs(tcp.snd_wnd, slot) == 0)
    need = (outstanding | persist) & (
        gather_hs(tcp.rtx_expire, slot) == simtime.INVALID)

    # more admissible data than this pass packetized: chain a same-time
    # TCP_FLUSH event, unwound by the window fixpoint
    can2 = mask & _sendable(gather_hs(tcp.st, slot))
    wnd2 = torch.minimum(gather_hs(tcp.cwnd, slot) * MSS,
                         gather_hs(tcp.snd_wnd, slot))
    seg2 = torch.minimum((gather_hs(tcp.snd_end, slot) - nxt).clamp(max=MSS),
                         una + wnd2 - nxt)
    BO2 = sim.net.out_words.shape[2]
    room2 = (gather_hs(sim.net.out_count, slot) < BO2) & (
        gather_hs(sim.net.out_bytes, slot) + seg2
        <= gather_hs(sim.net.sk_sndbuf, slot))
    chain = can2 & (seg2 > 0) & room2 \
        & ~gather_hs(tcp.flush_pending, slot)
    tcp = _set(tcp, "flush_pending", chain, slot, True)
    sim = sim.replace(tcp=tcp)
    buf = emit(buf, chain, sim.net.lane_id, now, EventKind.TCP_FLUSH,
               _slot_words(slot))
    return _arm_rtx(sim, buf, need, slot, now)


# ---------------------------------------------------------------------
# segment regeneration for retransmission
# ---------------------------------------------------------------------

def sack_clip_len(una, seg, sack_l, sack_r):
    """Clip a retransmission starting at snd_una so it ends at the first
    peer-sacked left edge above una (sacked bytes need no resend; ref:
    tcp_retransmit_tally.cc compute_lost). una: [H] i32; seg: [H] i32
    proposed length; sack_l/sack_r: [H, SACK_RANGES] i32. Returns the
    clipped [H] length."""
    above = (sack_r > sack_l) & (sack_l > una[:, None])
    first_sacked = torch.where(above, sack_l, _I32_MAX).amin(dim=1)
    return torch.minimum(seg, (first_sacked - una).clamp(min=1))


def _retransmit_one(cfg, sim, mask, slot, now, buf):
    """Re-send the segment at snd_una (ref: _tcp_retransmitPacket). SYN
    / SYN|ACK / FIN are regenerated from the state machine; data
    segments from the [snd_una, snd_end) byte range."""
    tcp = sim.tcp
    st = gather_hs(tcp.st, slot)
    una = gather_hs(tcp.snd_una, slot)
    end = gather_hs(tcp.snd_end, slot)
    fin_ever = gather_hs(tcp.fin_pending, slot) & (
        gather_hs(tcp.snd_max, slot) == end + 1)

    is_syn = mask & (una == 0) & (st == TcpSt.SYN_SENT)
    is_synack = mask & (una == 0) & (st == TcpSt.SYN_RCVD)
    is_fin = mask & ~is_syn & ~is_synack & fin_ever & (una == end)
    is_data = mask & ~is_syn & ~is_synack & ~is_fin & (una < end)

    sim, buf, _ = _enqueue_seg(sim, buf, is_syn, slot, pf.TCPF_SYN, 0, 0,
                               now, retransmit=True)
    sim, buf, _ = _enqueue_seg(sim, buf, is_synack, slot,
                               pf.TCPF_SYN | pf.TCPF_ACK, 0, 0, now,
                               retransmit=True)
    sim, buf, _ = _enqueue_seg(sim, buf, is_fin, slot,
                               pf.TCPF_FIN | pf.TCPF_ACK, una, 0, now,
                               retransmit=True)
    seg = (end - una).clamp(max=MSS)
    H = mask.shape[0]
    lane = torch.arange(H, device=mask.device)
    S = tcp.sack_l.shape[1]
    sc = slot.clamp(0, S - 1).to(I64)
    seg = sack_clip_len(una, seg, tcp.sack_l[lane, sc], tcp.sack_r[lane, sc])
    sim, buf, _ = _enqueue_seg(sim, buf, is_data, slot, pf.TCPF_ACK, una, seg,
                               now, retransmit=True)
    sent = is_syn | is_synack | is_fin | is_data
    resent_end = torch.where(is_data, una + seg, una + 1)
    tcp = sim.tcp
    tcp = tcp.replace(retx_segs=tcp.retx_segs + sent.to(I64))
    return sim.replace(tcp=tcp), buf, sent, resent_end


# ---------------------------------------------------------------------
# inbound packet processing (ref: tcp_processPacket, tcp.c:1777-2100)
# ---------------------------------------------------------------------

def tcp_packet_in(cfg: NetConfig, sim, mask, slot, words, src_ip, src_port,
                  now, buf):
    """Process one inbound TCP segment per masked lane, already matched
    to socket `slot` (the child-specific association wins over the
    listener)."""
    tcp = sim.tcp
    net = sim.net
    H = mask.shape[0]
    dev = mask.device
    slot = slot.to(I64)

    flags = pf.tcp_flags_of(words)
    seq = words[:, pf.W_SEQ]
    ack = words[:, pf.W_ACK]
    length = words[:, pf.W_LEN]
    peer_win = words[:, pf.W_WIN]
    tsval = words[:, pf.W_TSVAL]
    tsecho = words[:, pf.W_TSECHO]
    f_syn = (flags & pf.TCPF_SYN) != 0
    f_ack = (flags & pf.TCPF_ACK) != 0
    f_fin = (flags & pf.TCPF_FIN) != 0
    f_rst = (flags & pf.TCPF_RST) != 0
    st = gather_hs(tcp.st, slot)

    # ---- RST tears the connection down ------------------------------
    rst = mask & f_rst & (st != TcpSt.CLOSED) & (st != TcpSt.LISTEN)
    sim = _free_socket(cfg, sim, rst, slot)
    tcp, net = sim.tcp, sim.net
    mask = mask & ~rst
    st = gather_hs(tcp.st, slot)

    # ---- LISTEN + SYN: spawn a child in SYN_RCVD ---------------------
    # A full backlog (queued children plus children still in handshake)
    # drops the SYN unanswered; the client's SYN retransmit retries.
    syn_to_listen = mask & (st == TcpSt.LISTEN) & f_syn
    in_handshake = ((tcp.parent == slot[:, None])
                    & (tcp.st == TcpSt.SYN_RCVD)).sum(dim=1, dtype=I32)
    backlog = gather_hs(tcp.aq_count, slot) + in_handshake
    syn_ok = syn_to_listen & (backlog < ACCEPT_QUEUE)
    net, child = sk_create(net, syn_ok, SocketType.TCP)
    spawned = syn_to_listen & (child >= 0)
    net = net.replace(
        sk_bound_ip=set_hs(net.sk_bound_ip, spawned, child,
                           gather_hs(net.sk_bound_ip, slot)),
        sk_bound_port=set_hs(net.sk_bound_port, spawned, child,
                             gather_hs(net.sk_bound_port, slot)),
        sk_peer_ip=set_hs(net.sk_peer_ip, spawned, child, src_ip),
        sk_peer_port=set_hs(net.sk_peer_port, spawned, child, src_port),
    )
    tcp = _set(tcp, "st", spawned, child, TcpSt.SYN_RCVD)
    tcp = _set(tcp, "rcv_nxt", spawned, child, seq + 1)
    tcp = _set(tcp, "ts_recent", spawned, child, tsval)
    tcp = _set(tcp, "snd_una", spawned, child, 0)
    tcp = _set(tcp, "snd_nxt", spawned, child, 1)
    tcp = _set(tcp, "snd_max", spawned, child, 1)
    tcp = _set(tcp, "snd_end", spawned, child, 1)
    tcp = _set(tcp, "snd_wnd", spawned, child, peer_win.clamp(min=MSS))
    tcp = _set(tcp, "parent", spawned, child, slot)
    sim = sim.replace(net=net, tcp=tcp)
    sim, buf, _ = _enqueue_seg(sim, buf, spawned, child,
                               pf.TCPF_SYN | pf.TCPF_ACK, 0, 0, now)
    sim, buf = _arm_rtx(sim, buf, spawned, child, now)
    tcp, net = sim.tcp, sim.net
    # everything below operates on the matched socket only
    mask = mask & ~syn_to_listen
    st = gather_hs(tcp.st, slot)

    # ---- repeat SYN to a SYN_RCVD child: re-offer SYN|ACK ------------
    resyn = mask & (st == TcpSt.SYN_RCVD) & f_syn & ~f_ack
    sim, buf, _ = _enqueue_seg(sim, buf, resyn, slot,
                               pf.TCPF_SYN | pf.TCPF_ACK, 0, 0, now)
    tcp, net = sim.tcp, sim.net
    mask = mask & ~resyn

    # ---- SYN_SENT + SYN|ACK: complete active open --------------------
    synack = mask & (st == TcpSt.SYN_SENT) & f_syn & f_ack & (ack == 1)
    # a deferred close (tcp_close during the handshake) lands the
    # connection straight in FIN_WAIT_1
    est_st = torch.where(gather_hs(tcp.fin_pending, slot),
                         TcpSt.FIN_WAIT_1, TcpSt.ESTABLISHED).to(I32)
    tcp = _set(tcp, "st", synack, slot, est_st)
    tcp = _set(tcp, "rcv_nxt", synack, slot, seq + 1)
    tcp = _set(tcp, "snd_una", synack, slot, 1)
    tcp = _set(tcp, "snd_wnd", synack, slot, peer_win.clamp(min=MSS))
    tcp = _set(tcp, "ts_recent", synack, slot, tsval)
    tcp = _set(tcp, "backoff", synack, slot, 0)
    tcp = _disarm_rtx(tcp, synack, slot)
    # establish raises WRITABLE through the helper so the out-gen edge
    # fires for watches armed during the handshake
    net = set_writable(net, synack, slot, True)
    sim = sim.replace(net=net, tcp=tcp)
    st = gather_hs(tcp.st, slot)

    # ---- ts_recent update (in-window segments) -----------------------
    inwin = mask & (seq <= gather_hs(tcp.rcv_nxt, slot))
    tcp = _set(tcp, "ts_recent",
               inwin & (tsval >= gather_hs(tcp.ts_recent, slot)), slot, tsval)

    # ---- SYN_RCVD + final ACK: ESTABLISHED + accept queue ------------
    # A completing ACK that races a full accept queue is ignored: the
    # child stays SYN_RCVD and its SYN|ACK retransmit re-offers.
    est_cand = mask & (st == TcpSt.SYN_RCVD) & f_ack & ~f_syn & (ack == 1)
    parent = gather_hs(tcp.parent, slot)
    queue_ok = est_cand & (parent >= 0) & (
        gather_hs(tcp.aq_count, parent) < ACCEPT_QUEUE)
    est_child = est_cand & (queue_ok | (parent < 0))
    tcp = _set(tcp, "st", est_child, slot, TcpSt.ESTABLISHED)
    tcp = _set(tcp, "snd_una", est_child, slot, 1)
    tcp = _set(tcp, "backoff", est_child, slot, 0)
    tcp = _disarm_rtx(tcp, est_child, slot)
    pos = (gather_hs(tcp.aq_head, parent)
           + gather_hs(tcp.aq_count, parent)) % ACCEPT_QUEUE
    tcp = tcp.replace(aq=set_ring(tcp.aq, queue_ok, parent, pos, slot))
    tcp = _set(tcp, "aq_count", queue_ok, parent,
               gather_hs(tcp.aq_count, parent) + 1)
    pfl = gather_hs(net.sk_flags, parent)
    net = net.replace(
        sk_flags=set_hs(net.sk_flags, queue_ok, parent,
                        pfl | SocketFlags.READABLE),
        # each newly queued child is an IN edge on the listener
        sk_in_gen=set_hs(net.sk_in_gen, queue_ok, parent,
                         gather_hs(net.sk_in_gen, parent) + 1),
    )
    st = gather_hs(tcp.st, slot)

    # ---- ACK processing ----------------------------------------------
    conn = mask & f_ack & (st >= TcpSt.ESTABLISHED)
    una = gather_hs(tcp.snd_una, slot)
    nxt = gather_hs(tcp.snd_nxt, slot)
    wnd_prev = gather_hs(tcp.snd_wnd, slot)
    tcp = _set(tcp, "snd_wnd", conn, slot, peer_win)
    # scoreboard = the advertised SACK list (the receiver re-sends its
    # full parked set each ACK); an empty list clears it
    sack_l3 = torch.stack([words[:, pf.W_SACKL], words[:, pf.W_SACKL2],
                           words[:, pf.W_SACKL3]], dim=1)
    sack_r3 = torch.stack([words[:, pf.W_SACKR], words[:, pf.W_SACKR2],
                           words[:, pf.W_SACKR3]], dim=1)
    S_ = tcp.sack_l.shape[1]
    sel_sk = (conn[:, None] & (torch.arange(S_, device=dev)[None, :]
                               == slot[:, None]))[..., None]
    tcp = tcp.replace(
        sack_l=torch.where(sel_sk, sack_l3[:, None, :], tcp.sack_l),
        sack_r=torch.where(sel_sk, sack_r3[:, None, :], tcp.sack_r),
    )

    smax = gather_hs(tcp.snd_max, slot)
    new_ack = conn & (ack > una) & (ack <= smax)
    # an ACK above a rewound snd_nxt means those bytes arrived from the
    # pre-rewind transmission: jump forward
    heal = new_ack & (ack > nxt)
    tcp = _set(tcp, "snd_nxt", heal, slot, ack)
    nxt = torch.where(heal, ack, nxt)
    # a true duplicate ACK carries no data, no SYN/FIN and no window
    # update (RFC 5681 §2)
    dup_ack = conn & (ack == una) & (una < nxt) & (length == 0) \
        & ~f_syn & ~f_fin & (peer_win == wnd_prev)

    # RTT sample (Karn-safe via timestamps, ref: tcp.c:991-1026)
    rtt = (_ms(now) - tsecho).clamp(min=1)
    srtt = gather_hs(tcp.srtt_ms, slot)
    rttvar = gather_hs(tcp.rttvar_ms, slot)
    first = new_ack & (srtt < 0)
    srtt_n = torch.where(first, rtt, srtt + (rtt - srtt) // 8)
    rttvar_n = torch.where(first, rtt // 2,
                           (3 * rttvar + (srtt - rtt).abs()) // 4)
    rto_n = (srtt_n + (4 * rttvar_n).clamp(min=1)).clamp(RTO_MIN_MS,
                                                          RTO_MAX_MS)
    sample = new_ack & (tsecho > 0)
    tcp = _set(tcp, "srtt_ms", sample, slot, srtt_n)
    tcp = _set(tcp, "rttvar_ms", sample, slot, rttvar_n)
    tcp = _set(tcp, "rto_ms", sample, slot, rto_n)
    tcp = _set(tcp, "backoff", new_ack, slot, 0)

    # New-ack congestion hooks, fed the number of packets the ACK
    # covers (ref: tcp.c:1710-1717 nPacketsAcked)
    alg = cfg.tcp_cong
    in_rec = gather_hs(tcp.in_recovery, slot)
    recover = gather_hs(tcp.recover, slot)
    cwnd = gather_hs(tcp.cwnd, slot)
    ssth = gather_hs(tcp.ssthresh, slot)
    ca = gather_hs(tcp.ca_acc, slot)
    n_acked = torch.where(new_ack, (ack - una + MSS - 1) // MSS, 0)

    full_rec = new_ack & in_rec & (ack >= recover)
    partial = new_ack & in_rec & (ack < recover)
    normal = new_ack & ~in_rec

    # slow start: cwnd += n, spilling leftover acks into congestion
    # avoidance at ssthresh
    ss = normal & (cwnd < ssth)
    grown = cwnd + n_acked
    spill = ss & (grown >= ssth)
    cwnd1 = torch.where(ss, torch.minimum(grown, ssth), cwnd)
    # leaving fast recovery deflates to ssthresh and continues in CA
    cwnd1 = torch.where(full_rec, ssth, cwnd1)
    ca_in = torch.where(spill, grown - ssth,
                        torch.where(full_rec | (normal & ~ss), n_acked, 0))
    in_ca = (normal & ~ss) | spill | full_rec
    # transitions reset the CA accumulator
    ca_base = torch.where(spill | full_rec, 0, ca)
    cwnd1, ca1, epoch1 = cong.ca_update(
        alg, in_ca, cwnd1, torch.where(in_ca, ca_base, ca), ca_in,
        gather_hs(tcp.cub_wmax, slot), gather_hs(tcp.cub_epoch_ms, slot),
        _ms(now))
    tcp = _set(tcp, "cwnd", new_ack, slot, cwnd1)
    tcp = _set(tcp, "ca_acc", new_ack, slot, ca1)
    tcp = _set(tcp, "cub_epoch_ms", in_ca, slot, epoch1)
    tcp = _set(tcp, "in_recovery", full_rec, slot, False)
    tcp = _set(tcp, "dup_acks", new_ack, slot, 0)
    tcp = _set(tcp, "snd_una", new_ack, slot, ack)

    # ---- buffer autotuning (ref: tcp.c:407-592) ----------------------
    # Initial sizing on the first RTT sample: the bandwidth-delay
    # product from the topology's latencies and the bottleneck of local
    # and peer bandwidth, x1.25.
    lane_id = net.lane_id.to(I64)
    at_init = sample & first & ~gather_hs(tcp.at_init_done, slot)
    peer_ip = gather_hs(net.sk_peer_ip, slot)
    self_ip = net.host_ip[lane_id]
    is_loop = (peer_ip == self_ip) | ((peer_ip >> 24) == 127)
    peer_h = host_of_ip(net, peer_ip)
    GHn = net.host_ip.shape[0]
    ph = peer_h.clamp(0, GHn - 1).to(I64)
    vsrc = net.vertex_of_host[lane_id].to(I64)
    vdst = net.vertex_of_host[ph].to(I64)
    rtt_topo_ms = torch.div(
        net.latency_ns[vsrc, vdst] + net.latency_ns[vdst, vsrc],
        simtime.ONE_MILLISECOND, rounding_mode="floor").clamp(min=1)
    my_up = net.bw_up_kibps[lane_id]
    peer_up = net.bw_up_kibps[ph]
    peer_down = net.bw_down_kibps[ph]
    my_down = net.bw_down_kibps[lane_id]
    # KiBps * ms * 1.25 / 1000 -> bytes (the delay-bandwidth product)
    bdp_snd = rtt_topo_ms * torch.minimum(my_up, peer_down) * 1280 // 1000
    bdp_rcv = rtt_topo_ms * torch.minimum(my_down, peer_up) * 1280 // 1000
    init_snd = torch.where(
        is_loop, TCP_WMEM_MAX,
        bdp_snd.clamp(SEND_BUFFER_MIN, TCP_WMEM_MAX)).to(I32)
    init_rcv = torch.where(
        is_loop, TCP_RMEM_MAX,
        bdp_rcv.clamp(RECV_BUFFER_MIN, TCP_RMEM_MAX)).to(I32)
    net = net.replace(
        sk_sndbuf=set_hs(net.sk_sndbuf, at_init & net.autotune_snd, slot,
                         init_snd),
        sk_rcvbuf=set_hs(net.sk_rcvbuf, at_init & net.autotune_rcv, slot,
                         init_rcv),
    )
    tcp = _set(tcp, "at_init_done", at_init, slot, True)
    # runtime send-buffer growth with cwnd (ref: tcp.c:566-592), grow-only
    srtt_now = torch.where(sample, srtt_n, srtt).clamp(min=0).to(I64)
    max_wmem = (my_up * 1024 * srtt_now // 1000).clamp(TCP_WMEM_MAX,
                                                       10 * TCP_WMEM_MAX)
    want_snd = torch.minimum(SNDMEM_SKB * 2 * cwnd1.to(I64),
                             max_wmem).to(I32)
    cur_snd = gather_hs(net.sk_sndbuf, slot)
    net = net.replace(sk_sndbuf=set_hs(
        net.sk_sndbuf, new_ack & net.autotune_snd & (want_snd > cur_snd),
        slot, want_snd))
    # ACK progress reopened stream-buffer room: restore WRITABLE
    wroom = new_ack & (gather_hs(net.sk_sndbuf, slot)
                       - (gather_hs(tcp.snd_end, slot) - ack) > 0)
    net = set_writable(net, wroom, slot, True)

    # dup-ack counting / fast retransmit; ssthresh and the entry cwnd
    # come from the configured algorithm
    da = gather_hs(tcp.dup_acks, slot) + 1
    tcp = _set(tcp, "dup_acks", dup_ack, slot, da)
    enter_fr = dup_ack & (da == 3) & ~in_rec
    ssth_fr = cong.ssthresh_on_loss(alg, cwnd)
    tcp = _set(tcp, "ssthresh", enter_fr, slot, ssth_fr)
    tcp = _set(tcp, "cwnd", enter_fr, slot,
               cong.cwnd_on_recovery_entry(alg, ssth_fr))
    wmax1, ep1 = cong.on_loss_event(
        alg, enter_fr, cwnd, gather_hs(tcp.cub_wmax, slot),
        gather_hs(tcp.cub_epoch_ms, slot))
    tcp = _set(tcp, "cub_wmax", enter_fr, slot, wmax1)
    tcp = _set(tcp, "cub_epoch_ms", enter_fr, slot, ep1)
    tcp = _set(tcp, "in_recovery", enter_fr, slot, True)
    tcp = _set(tcp, "recover", enter_fr, slot, nxt)
    tcp = tcp.replace(fr_entries=tcp.fr_entries + enter_fr.to(I64))
    # window inflation while in recovery (classic AIMD forgoes it)
    if alg != cong.AIMD:
        inflate = dup_ack & in_rec
        tcp = _set(tcp, "cwnd", inflate, slot, gather_hs(tcp.cwnd, slot) + 1)

    sim = sim.replace(net=net, tcp=tcp)
    sim, buf, _, _ = _retransmit_one(cfg, sim, enter_fr | partial, slot, now,
                                     buf)
    tcp = sim.tcp

    # re-arm / disarm the RTO deadline after progress
    still_out = new_ack & (ack < smax)
    done = new_ack & (ack >= smax)
    rto_ns = gather_hs(tcp.rto_ms, slot).to(I64) * simtime.ONE_MILLISECOND
    tcp = _set(tcp, "rtx_expire", still_out, slot, now + rto_ns)
    tcp = _disarm_rtx(tcp, done, slot)
    sim = sim.replace(tcp=tcp)

    # push more data: the window may have opened (new_ack), a pure
    # window-update ACK may have reopened a closed window, or the
    # connection just established with buffered data (synack)
    reopened = conn & (wnd_prev == 0) & (peer_win > 0)
    sim, buf = tcp_flush(cfg, sim, new_ack | synack | reopened, slot, now,
                         buf)
    tcp, net = sim.tcp, sim.net
    st = gather_hs(tcp.st, slot)

    # ---- ACK of our FIN: teardown transitions ------------------------
    smax2 = gather_hs(tcp.snd_max, slot)
    fin_ever = gather_hs(tcp.fin_pending, slot) & (
        smax2 == gather_hs(tcp.snd_end, slot) + 1)
    fin_acked = mask & f_ack & fin_ever & (ack == smax2)
    tcp = _set(tcp, "st", fin_acked & (st == TcpSt.FIN_WAIT_1), slot,
               TcpSt.FIN_WAIT_2)
    tcp = _set(tcp, "st", fin_acked & (st == TcpSt.CLOSING), slot,
               TcpSt.TIME_WAIT)
    closed_now = fin_acked & (st == TcpSt.LAST_ACK)
    sim = sim.replace(net=net, tcp=tcp)
    sim = _free_socket(cfg, sim, closed_now, slot)
    tcp, net = sim.tcp, sim.net
    # TIME_WAIT entered via CLOSING: arm the 60 s reaper
    tw1 = fin_acked & (st == TcpSt.CLOSING)
    w = _slot_words(slot)
    buf = emit(buf, tw1, net.lane_id, now + TIMEWAIT_NS,
               EventKind.TCP_CLOSE_TIMER, w)
    st = gather_hs(tcp.st, slot)

    # ---- inbound data (ref: tcp.c data path + unordered input) -------
    has_data = mask & (length > 0) & (
        (st == TcpSt.ESTABLISHED) | (st == TcpSt.FIN_WAIT_1)
        | (st == TcpSt.FIN_WAIT_2))
    rcv_nxt = gather_hs(tcp.rcv_nxt, slot)
    seg_end = seq + length
    old = has_data & (seg_end <= rcv_nxt)
    fresh = has_data & ~old

    # receive-buffer guard: drop segments that cannot be stored
    oo_bytes = (tcp.oo_r - tcp.oo_l).sum(dim=2, dtype=I32)
    freeb = gather_hs(net.sk_rcvbuf, slot) - gather_hs(tcp.app_rbytes, slot) \
        - gather_hs(oo_bytes, slot)
    fits = fresh & (length <= freeb)
    tcp = tcp.replace(drop_rwin=tcp.drop_rwin + (fresh & ~fits).to(I64))

    inorder = fits & (seq <= rcv_nxt)
    adv = torch.where(inorder, seg_end - rcv_nxt, 0)
    rcv1 = rcv_nxt + adv
    rbytes = gather_hs(tcp.app_rbytes, slot) + adv
    # merge any reassembly range now contiguous (unrolled bounded scan)
    lane = torch.arange(H, device=dev)
    S = tcp.oo_l.shape[1]
    sc = slot.clamp(0, S - 1).to(I64)
    for _ in range(OO_RANGES):
        ool = tcp.oo_l[lane, sc]      # [H, NR]
        oor = tcp.oo_r[lane, sc]
        hit = (ool <= rcv1[:, None]) & (oor > ool)     # contiguous/overlap
        take = (hit & inorder[:, None]).any(dim=1)
        pick = _first_true(hit)
        new_r = oor[lane, pick]
        gain = torch.where(take & (new_r > rcv1), new_r - rcv1, 0)
        rcv1 = rcv1 + gain
        rbytes = rbytes + gain
        # clear the consumed range
        tcp = tcp.replace(
            oo_l=set_ring(tcp.oo_l, take & inorder, slot, pick, 0),
            oo_r=set_ring(tcp.oo_r, take & inorder, slot, pick, 0),
        )
    tcp = _set(tcp, "rcv_nxt", inorder, slot, rcv1)
    tcp = _set(tcp, "app_rbytes", inorder, slot, rbytes)

    # out-of-order: park [seq, seg_end) in a reassembly range
    ooseg = fits & (seq > rcv_nxt)
    ool = tcp.oo_l[lane, sc]
    oor = tcp.oo_r[lane, sc]
    overlap = (seq[:, None] <= oor) & (seg_end[:, None] >= ool) & (oor > ool)
    mergeable = overlap.any(dim=1)
    mpick = _first_true(overlap)
    empty_rng = oor <= ool
    has_empty = empty_rng.any(dim=1)
    epick = _first_true(empty_rng)
    do_merge = ooseg & mergeable
    do_new = ooseg & ~mergeable & has_empty
    dropped_oo = ooseg & ~mergeable & ~has_empty
    tcp = tcp.replace(drop_oo_full=tcp.drop_oo_full + dropped_oo.to(I64))
    pick = torch.where(do_merge, mpick, epick)
    nl = torch.where(do_merge, torch.minimum(ool[lane, pick], seq), seq)
    nr = torch.where(do_merge, torch.maximum(oor[lane, pick], seg_end),
                     seg_end)
    tcp = tcp.replace(
        oo_l=set_ring(tcp.oo_l, do_merge | do_new, slot, pick, nl),
        oo_r=set_ring(tcp.oo_r, do_merge | do_new, slot, pick, nr),
    )

    # readable status for the app; each in-order arrival is an edge
    readable = inorder & (gather_hs(tcp.app_rbytes, slot) > 0)
    fl = gather_hs(net.sk_flags, slot)
    net = net.replace(
        sk_flags=set_hs(net.sk_flags, readable, slot,
                        fl | SocketFlags.READABLE),
        sk_in_gen=set_hs(net.sk_in_gen, readable, slot,
                         gather_hs(net.sk_in_gen, slot) + 1),
    )

    # ---- peer FIN ----------------------------------------------------
    fin_seen = mask & f_fin & (st >= TcpSt.ESTABLISHED) & (
        st != TcpSt.TIME_WAIT)
    tcp = _set(tcp, "fin_rcvd", fin_seen, slot, True)
    tcp = _set(tcp, "fin_rseq", fin_seen, slot, seg_end)
    # consume the FIN only when all data before it has arrived
    rn = gather_hs(tcp.rcv_nxt, slot)
    fin_now = mask & gather_hs(tcp.fin_rcvd, slot) & (
        rn == gather_hs(tcp.fin_rseq, slot)) & (
        st != TcpSt.TIME_WAIT) & (st >= TcpSt.ESTABLISHED)
    tcp = _set(tcp, "rcv_nxt", fin_now, slot, rn + 1)
    to_close_wait = fin_now & (st == TcpSt.ESTABLISHED)
    to_closing = fin_now & (st == TcpSt.FIN_WAIT_1)
    to_timewait = fin_now & (st == TcpSt.FIN_WAIT_2)
    tcp = _set(tcp, "st", to_close_wait, slot, TcpSt.CLOSE_WAIT)
    tcp = _set(tcp, "st", to_closing, slot, TcpSt.CLOSING)
    tcp = _set(tcp, "st", to_timewait, slot, TcpSt.TIME_WAIT)
    buf = emit(buf, to_timewait, net.lane_id, now + TIMEWAIT_NS,
               EventKind.TCP_CLOSE_TIMER, w)
    # EOF is app-visible readability (recv returns 0)
    fl = gather_hs(net.sk_flags, slot)
    net = net.replace(
        sk_flags=set_hs(net.sk_flags, fin_now, slot,
                        fl | SocketFlags.READABLE),
        sk_in_gen=set_hs(net.sk_in_gen, fin_now, slot,
                         gather_hs(net.sk_in_gen, slot) + 1),
    )

    # ---- ACK generation (ref: tcp.c:2050-2091) -----------------------
    # Loss-signalling ACKs (old/out-of-order/dropped data) and handshake
    # ACKs go out immediately; plain ACKs for in-order data (and the
    # FIN's ACK) coalesce behind one delayed-ACK send. A SYN|ACK to an
    # already-ESTABLISHED peer elicits an immediate pure ACK.
    resynack = mask & f_syn & f_ack & (st >= TcpSt.ESTABLISHED)
    ooseg_ack = fits & (seq > rcv_nxt)
    dropped_ack = fresh & ~fits
    alive = st != TcpSt.CLOSED
    immediate = (old | ooseg_ack | dropped_ack | synack | resynack) & alive
    delayed = (inorder | fin_now) & ~immediate & alive
    sim = sim.replace(net=net, tcp=tcp)
    sim, buf, _ = _enqueue_seg(sim, buf, immediate, slot, pf.TCPF_ACK,
                               gather_hs(tcp.snd_nxt, slot), 0, now)
    tcp = sim.tcp
    cnt = gather_hs(tcp.dack_counter, slot) + 1
    tcp = _set(tcp, "dack_counter", delayed, slot, cnt)
    sched = delayed & ~gather_hs(tcp.dack_scheduled, slot)
    nq = gather_hs(tcp.quick_acks, slot)
    quick = nq < DACK_QUICK_LIMIT
    delay = torch.where(quick, DACK_QUICK_NS, DACK_SLOW_NS)
    tcp = _set(tcp, "quick_acks", sched & quick, slot, nq + 1)
    tcp = _set(tcp, "dack_scheduled", sched, slot, True)
    buf = emit(buf, sched, sim.net.lane_id, now + delay,
               EventKind.TCP_DACK_TIMER,
               _slot_words(slot, gather_hs(tcp.dack_gen, slot)))
    return sim.replace(tcp=tcp), buf


# ---------------------------------------------------------------------
# timer event handlers
# ---------------------------------------------------------------------

def handle_tcp_rtx(cfg: NetConfig, sim, popped, buf):
    """kind=TCP_RTX_TIMER (ref: retransmit timer + exponential backoff,
    tcp.c:1280-...). The single in-flight event per socket re-arms
    itself while the deadline keeps moving."""
    if sim.tcp is None:
        return sim, buf
    mask = popped.valid & (popped.kind == EventKind.TCP_RTX_TIMER)
    slot = popped.words[:, 0].to(I64)
    egen = popped.words[:, 1]
    now = popped.time
    tcp = sim.tcp

    # superseded events (generation mismatch) die silently
    mask = mask & (egen == gather_hs(tcp.rtx_gen, slot))
    deadline = gather_hs(tcp.rtx_expire, slot)
    disarmed = mask & (deadline == simtime.INVALID)
    pending = mask & ~disarmed & (now < deadline)
    due = mask & ~disarmed & ~pending

    # the in-flight event dies unless re-emitted
    tcp = _set(tcp, "rtx_event", disarmed, slot, False)
    buf = emit(buf, pending, sim.net.lane_id, deadline,
               EventKind.TCP_RTX_TIMER, _slot_words(slot, egen))
    tcp = _set(tcp, "rtx_fire", pending, slot, deadline)

    # timeout: collapse to slow start and go back to snd_una
    una = gather_hs(tcp.snd_una, slot)
    nxt = gather_hs(tcp.snd_nxt, slot)
    live = due & (una < nxt)

    # persist expiry: zero window, data waiting, nothing in flight —
    # send one byte past the window; backoff caps the probe rate
    probe = due & (una == nxt) & (gather_hs(tcp.snd_end, slot) > nxt) \
        & (gather_hs(tcp.snd_wnd, slot) == 0)
    sim2 = sim.replace(tcp=tcp)
    sim2, buf, psent = _enqueue_seg(sim2, buf, probe, slot, pf.TCPF_ACK,
                                    nxt, 1, now)
    tcp = sim2.tcp
    tcp = _set(tcp, "snd_nxt", psent, slot, nxt + 1)
    tcp = _set(tcp, "snd_max", psent, slot,
               torch.maximum(gather_hs(tcp.snd_max, slot), nxt + 1))
    tcp = _set(tcp, "backoff", psent, slot,
               (gather_hs(tcp.backoff, slot) + 1).clamp(max=MAX_BACKOFF))
    tcp = tcp.replace(probes_sent=tcp.probes_sent + psent.to(I64))
    sim = sim2.replace(tcp=tcp)
    cwnd = gather_hs(tcp.cwnd, slot)
    # timeout hook: ssthresh from the configured algorithm, restart
    # from RESTART_CWND
    tcp = _set(tcp, "ssthresh", live, slot,
               cong.ssthresh_on_loss(cfg.tcp_cong, cwnd))
    tcp = _set(tcp, "cwnd", live, slot, RESTART_CWND)
    wmax_t, ep_t = cong.on_loss_event(
        cfg.tcp_cong, live, cwnd, gather_hs(tcp.cub_wmax, slot),
        gather_hs(tcp.cub_epoch_ms, slot))
    tcp = _set(tcp, "cub_wmax", live, slot, wmax_t)
    tcp = _set(tcp, "cub_epoch_ms", live, slot, ep_t)
    tcp = _set(tcp, "ca_acc", live, slot, 0)
    tcp = _set(tcp, "in_recovery", live, slot, False)
    tcp = _set(tcp, "dup_acks", live, slot, 0)
    tcp = _set(tcp, "backoff", live, slot,
               (gather_hs(tcp.backoff, slot) + 1).clamp(max=MAX_BACKOFF))
    tcp = _set(tcp, "rtx_event", due, slot, False)
    tcp = _disarm_rtx(tcp, due, slot)
    sim = sim.replace(tcp=tcp)
    sim, buf, _, resent_end = _retransmit_one(cfg, sim, live, slot, now, buf)
    # go-back-N: snd_nxt rewinds to just past the retransmitted segment
    # (as actually sent, SACK clip included)
    tcp = sim.tcp
    rewind = live & (resent_end < nxt)
    tcp = _set(tcp, "snd_nxt", rewind, slot, resent_end)
    sim = sim.replace(tcp=tcp)
    return _arm_rtx(sim, buf, live | probe, slot, now)


def handle_tcp_flush(cfg: NetConfig, sim, popped, buf):
    """kind=TCP_FLUSH: continue packetizing admissible stream data (the
    unwound remainder of one logical _tcp_flush call)."""
    if sim.tcp is None:
        return sim, buf
    mask = popped.valid & (popped.kind == EventKind.TCP_FLUSH)
    slot = popped.words[:, 0].to(I64)
    sim = sim.replace(tcp=_set(sim.tcp, "flush_pending", mask, slot, False))
    return tcp_flush(cfg, sim, mask, slot, popped.time, buf)


def handle_tcp_dack(cfg: NetConfig, sim, popped, buf):
    """kind=TCP_DACK_TIMER: the delayed-ACK send task (ref:
    _tcp_sendACKTaskCallback, tcp.c:1767-1775): clear the scheduled flag
    and send one pure ACK if an ACK-worthy arrival is still
    unacknowledged."""
    if sim.tcp is None:
        return sim, buf
    mask = popped.valid & (popped.kind == EventKind.TCP_DACK_TIMER)
    slot = popped.words[:, 0].to(I64)
    egen = popped.words[:, 1]
    tcp = sim.tcp
    # stale events for recycled slots die on generation mismatch
    mask = mask & (egen == gather_hs(tcp.dack_gen, slot))
    tcp = _set(tcp, "dack_scheduled", mask, slot, False)
    fire = mask & (gather_hs(tcp.dack_counter, slot) > 0)
    tcp = _set(tcp, "dack_counter", fire, slot, 0)
    sim = sim.replace(tcp=tcp)
    sim, buf, _ = _enqueue_seg(sim, buf, fire, slot, pf.TCPF_ACK,
                               gather_hs(tcp.snd_nxt, slot), 0, popped.time)
    return sim, buf


def wire_ack_departed(tcp: TcpState, mask, slot):
    """A packet carrying an ACK just hit the wire for (lane, slot):
    cancel any pending delayed ACK (ref: tcp.c:1105-1108). Called by the
    NIC send drain after stamp_at_wire."""
    return _set(tcp, "dack_counter", mask, slot, 0)


def handle_tcp_close(cfg: NetConfig, sim, popped, buf):
    """kind=TCP_CLOSE_TIMER: the TIME_WAIT reaper (ref: 60 s close
    timer, tcp.c:604-699)."""
    if sim.tcp is None:
        return sim, buf
    mask = popped.valid & (popped.kind == EventKind.TCP_CLOSE_TIMER)
    slot = popped.words[:, 0].to(I64)
    reap = mask & (gather_hs(sim.tcp.st, slot) == TcpSt.TIME_WAIT)
    return _free_socket(cfg, sim, reap, slot), buf
