"""Bulk window pass: process a host's whole window of UDP packet
arrivals in ONE vectorized pass instead of one micro-step per event
(PyTorch port of shadow_tpu/net/bulk.py).

Order-dependent quantities (ranks, suffix sums) come from an
EventOrder over each row's event slots, in one of the reference's two
bit-identical forms: the [H,K,K] compare cube or a per-row sort. The
token-bucket evolution — a chain of refill-then-consume steps
f_i(x) = min(cap, x + dq_i*refill) - w_i — telescopes into the closed
form

    F(s0) = min(s0 + (q_K - q_0)*refill - sum(w),
                min_i [cap - w_i + (q_K - q_i)*refill - suffw_i])

because min-affine maps compose associatively.

Semantics contract: for every ELIGIBLE host, the final state is
bit-identical to what the serial micro-step engine produces; hosts
that fail eligibility are left untouched and the window fixpoint that
runs right after picks them up. Eligibility (per host): every
in-window event is a remote UDP PACKET arrival; the NIC is quiescent
(router ring, deferred NIC events and socket rings empty); CoDel is in
its idle good state; the token buckets, projected by one analytic
refill to the first in-window arrival, cover the whole window; the
app's bulk handler accepts the host and its replies fit the send and
receive buffers.

The pass reads no value back to the host: its event count stays a
device tensor that the engine adds into EngineStats.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from shadow_tpu_torch.compile.specialize import loss_trimmed
from shadow_tpu_torch.core import rng, simtime
from shadow_tpu_torch.core.events import (
    EventKind, _tie_key, u32_to_i32)
from shadow_tpu_torch.net import packetfmt as pf
from shadow_tpu_torch.net.nic import ip_from_word, projected_tokens
from shadow_tpu_torch.net.state import (
    TB_REFILL_INTERVAL,
    NetConfig,
    QDisc,
    RouterQ,
    SocketFlags,
    host_of_ip,
    ip_of_hosts,
)

I32 = torch.int32
I64 = torch.int64
INT32_MAX = 2**31 - 1


@dataclass(frozen=True)
class EventOrder:
    """Per-row total order over the window's event slots under the
    deterministic comparator (time, then the (src, seq) tie key; the
    row is the destination), in one of two bit-identical forms:

    - "cube": prec[h, j, k] = slot j strictly precedes slot k; ranks
      and suffix sums are masked [H,K,K] reductions.
    - "sort": perm[h, p] = slot at ascending position p, inv its
      inverse; ranks and suffix sums are cumsums in sorted order.

    Ties in (time, tie) occur only between INVALID/stale slots; the
    slot index breaks them in both forms."""

    prec: Any = None   # [H,K,K] bool (cube) or None
    perm: Any = None   # [H,K] i64 (sort) or None
    inv: Any = None    # [H,K] i64 (sort) or None

    def _sorted(self, value):
        return torch.gather(value, 1, self.perm)

    def _unsorted(self, value):
        return torch.gather(value, 1, self.inv)


# Above this many prec-cube elements (H*K*K) the sort form is used off
# the CPU too (the reference's budget, kept as it is).
CUBE_BUDGET_ACCEL = 1_000_000_000


def _default_impl(H: int, K: int, device) -> str:
    """The reference's rule: "sort" on the CPU, "cube" elsewhere while
    the cube fits CUBE_BUDGET_ACCEL."""
    if torch.device(device).type == "cpu":
        return "sort"
    return "cube" if H * K * K <= CUBE_BUDGET_ACCEL else "sort"


def make_order(t, tie, impl: str | None = None) -> EventOrder:
    H, K = t.shape
    if impl is None:
        impl = _default_impl(H, K, t.device)
    if impl == "sort":
        # lexsort by (t, tie): a stable sort by the secondary key, then
        # a stable sort by the primary; equal pairs keep slot order
        p1 = torch.argsort(tie, dim=1, stable=True)
        p2 = torch.argsort(torch.gather(t, 1, p1), dim=1, stable=True)
        perm = torch.gather(p1, 1, p2)
        return EventOrder(perm=perm, inv=torch.argsort(perm, dim=1))
    if impl != "cube":
        raise ValueError(f"unknown order impl {impl!r}")
    tj, tk = t[:, :, None], t[:, None, :]
    ej, ek = tie[:, :, None], tie[:, None, :]
    ar = torch.arange(K, device=t.device)
    jlt = ar[:, None] < ar[None, :]
    prec = (tj < tk) | ((tj == tk) & ((ej < ek) | ((ej == ek) & jlt)))
    return EventOrder(prec=prec)


def rank_in_order(order: EventOrder, weight):
    """[H,K] i32 number of weighted events strictly preceding each slot
    under the total order (exclusive prefix count)."""
    w = weight.to(I32)
    if order.prec is not None:
        return torch.where(order.prec, w[:, :, None], 0).sum(dim=1,
                                                             dtype=I32)
    ws = order._sorted(w)
    pref = torch.cumsum(ws, dim=1, dtype=I32) - ws
    return order._unsorted(pref)


def suffix_sum(order: EventOrder, value):
    """[H,K] sum of value_i over events strictly AFTER each slot."""
    if order.prec is not None:
        return torch.where(order.prec, value[:, None, :],
                           torch.zeros((), dtype=value.dtype,
                                       device=value.device)).sum(
            dim=2, dtype=value.dtype)
    v = order._sorted(value)
    incl = torch.cumsum(v, dim=1, dtype=value.dtype)
    return order._unsorted(incl[:, -1:] - incl)


@dataclass(frozen=True)
class BulkDeliveries:
    """The window's UDP arrivals presented to the app bulk handler, in
    SLOT layout ([H,K] aligned with the event queue's slots; use the
    rank helpers for time-order-dependent logic)."""

    mask: Any       # [H,K] bool — matched, delivered-to-app arrivals
    time: Any       # [H,K] i64
    tie: Any        # [H,K] i64 order tie key
    order: Any      # EventOrder over the row's slots
    slot: Any       # [H,K] i32 receiving socket
    src_ip: Any     # [H,K] i64
    src_port: Any   # [H,K] i32
    length: Any     # [H,K] i32
    payref: Any     # [H,K] i32


@dataclass(frozen=True)
class BulkSends:
    """App's reply sends, one per delivered event at the event's time.
    Every send is remote with length > 0; `nic_draw_ctr` is the
    absolute per-host RNG counter of the NIC's reliability draw for
    this send (int64-carried u32). The app owns the draw-stream layout
    and advances sim.net.rng_ctr past ALL of the window's draws."""

    mask: Any           # [H,K] bool
    slot: Any           # [H,K] i32 sending socket
    dst_ip: Any         # [H,K] i64
    dst_host: Any       # [H,K] i32 (-1 = resolve from dst_ip)
    dst_port: Any       # [H,K] i32
    length: Any         # [H,K] i32
    payref: Any         # [H,K] i32
    nic_draw_ctr: Any   # [H,K] i64 holding u32


class AppBulk:
    """Interface an on-device app exposes to opt into the bulk pass.

    max_send_len: static upper bound on reply payload length.
    resolves_dst: True = every masked send carries dst_host >= 0, so
    the pass skips the ip->host lookup.
    precheck(cfg, sim) -> [H] bool — app-side eligibility (no mutation).
    run(cfg, sim, d: BulkDeliveries) -> (sim, BulkSends) — consume
    EVERY delivery in d.mask and stage at most one reply per event.
    """

    max_send_len: int = 0
    resolves_dst: bool = False

    def precheck(self, cfg, sim):
        raise NotImplementedError

    def run(self, cfg, sim, d):
        raise NotImplementedError


def _eligibility(cfg: NetConfig, sim, inwin, t, wl, nonboot, app_ok,
                 send_wire: int):
    net = sim.net
    q = sim.events
    kind_ok = (~inwin | (q.kind == EventKind.PACKET)).all(dim=1)
    # a stopped process's app is masked off in the serial path
    kind_ok = kind_ok & ~net.proc_stopped
    proto = q.words[:, :, pf.W_PROTO] & 0xFF
    udp_ok = (~inwin | (proto == pf.PROTO_UDP)).all(dim=1)
    quiesced = (
        (net.rq_count == 0)
        & ~net.nic_recv_pending
        & ~net.nic_send_pending
        & (net.out_count.sum(dim=1) == 0)
        & (net.in_count.sum(dim=1) == 0)
    )
    codel_ok = ~net.codel_dropping & (net.codel_interval_expire == 0)
    # token budgets with ONE projected refill, to the window's first
    # in-window arrival (the serial path's level at its first pull).
    # Worst prefix need of n transfers w_i: sum(w) - w_last + MTU.
    live = inwin & nonboot
    t_first = torch.where(live, t, simtime.INVALID).amin(dim=1)
    send_tok, recv_tok = projected_tokens(net, t_first)
    recv_need = torch.where(live, wl, 0).sum(dim=1)
    recv_min = torch.where(live, wl, INT32_MAX).amin(dim=1)
    recv_ok = (recv_need == 0) | (recv_tok >= recv_need - recv_min + pf.MTU)
    n_live = live.sum(dim=1)
    send_ok = (n_live == 0) | (
        send_tok >= (n_live.to(I64) - 1) * send_wire + pf.MTU)
    return (kind_ok & udp_ok & quiesced & codel_ok & recv_ok & send_ok
            & app_ok)


def _lookup_bulk(net, mask, dst_ip, dst_port, src_ip, src_port):
    """lookup_socket vectorized over [H,K] events: the peer-specific
    association beats the general one."""
    skt = net.sk_type[:, None, :]
    skf = net.sk_flags[:, None, :]
    bip = net.sk_bound_ip[:, None, :]
    bpt = net.sk_bound_port[:, None, :]
    pip = net.sk_peer_ip[:, None, :]
    ppt = net.sk_peer_port[:, None, :]
    base = (
        mask[:, :, None]
        & (skt == pf.PROTO_UDP)
        & ((skf & SocketFlags.CLOSED) == 0)
        & (bpt == dst_port[:, :, None])
        & ((bip == 0) | (bip == dst_ip[:, :, None]))
    )
    general = base & (ppt == 0)
    specific = base & (pip == src_ip[:, :, None]) & (
        ppt == src_port[:, :, None])

    def first(m):
        # argmax over an integer cast: the first True of each row
        idx = m.to(torch.uint8).argmax(dim=2).to(I32)
        return torch.where(m.any(dim=2), idx, -1)

    g = first(general)
    s = first(specific)
    return torch.where(s >= 0, s, g)


def _gather_hs_bulk(arr, slot):
    """arr[H,S] -> [H,K] values at (h, slot[h,k]) via a one-hot reduce
    (the slot domain S is small; slot -1 gives 0)."""
    S = arr.shape[1]
    sel = slot[:, :, None] == torch.arange(S, device=arr.device)[None, None, :]
    return torch.where(sel, arr[:, None, :], 0).sum(dim=2, dtype=arr.dtype)


def _per_socket(mask, slot, S):
    """[H,S] i32 count of masked events per socket slot."""
    ar = torch.arange(S, device=slot.device)
    return (mask[:, :, None] & (slot[:, :, None] == ar[None, None, :])).sum(
        dim=1, dtype=I32)


def make_bulk_fn(cfg: NetConfig, app_bulk: AppBulk,
                 order_impl: str | None = None,
                 caps=None) -> Callable | None:
    """Build the per-window bulk pass ``bulk_fn(sim, wend) -> (sim,
    events consumed as a [] i64 tensor)``, or None when the config
    cannot support it (the reference's static preconditions).
    `order_impl` forces the EventOrder form ("cube"/"sort"); None takes
    _default_impl's rule for the state's device.

    `caps` (compile/specialize.py, None = full program) with a dropped
    loss capability leaves the NIC-egress reliability draw out:
    uniform_at is a pure counter query (the app owns every window draw
    advance — BulkSends.nic_draw_ctr), so skipping it moves no RNG
    state, and with rel == 1.0 the drop mask it fed is constant
    False."""
    lossless = loss_trimmed(caps)
    if cfg.tcp or cfg.qdisc != QDisc.FIFO:
        return None
    if cfg.router_qdisc != RouterQ.CODEL:
        # single/static managers drop at enqueue; the closed form
        # assumes every window arrival is admitted
        return None
    if cfg.pcap or cfg.track_paths:
        # per-event capture / per-path counters stay on the serial path
        return None
    if cfg.out_ring < 2 or cfg.outbox_capacity < cfg.event_capacity:
        return None
    if cfg.cpu_threshold_ns >= 0:
        return None
    # replies must fit one MTU on the wire, so the serial drain's
    # max(tokens - w, 0) floor never engages mid-window
    if app_bulk.max_send_len + pf.HDR_UDP > pf.MTU:
        return None

    def bulk_fn(sim, wend):
        net = sim.net
        q = sim.events
        H, K = q.time.shape
        dev = q.time.device
        GH = net.host_ip.shape[0]
        lane = net.lane_id

        t = q.time
        inwin = t < wend
        tie = _tie_key(q.src, q.seq)
        length = q.words[:, :, pf.W_LEN]
        wl = torch.where(inwin, (length + pf.HDR_UDP).to(I64), 0)
        nonboot = t >= cfg.bootstrap_end
        app_ok = app_bulk.precheck(cfg, sim)
        sndbuf_ok = net.sk_sndbuf.amin(dim=1) > app_bulk.max_send_len

        # ---- receive side: router dequeue + socket delivery ----------
        pw = q.words[:, :, pf.W_PORTS]
        src_port = pw & 0xFFFF
        dst_port = (pw >> 16) & 0xFFFF
        dst_ip = ip_from_word(q.words[:, :, pf.W_DSTIP])
        src_ip = ip_of_hosts(cfg, net, q.src)
        payref = q.words[:, :, pf.W_PAYREF]

        slot = _lookup_bulk(net, inwin, dst_ip, dst_port, src_ip, src_port)
        # receive-buffer fit (with empty input rings the serial path
        # drops exactly the datagrams with length > sk_rcvbuf): fall
        # back rather than model the drop
        rcvbuf_at = _gather_hs_bulk(net.sk_rcvbuf, slot)
        rcv_fit = (~inwin | (slot < 0) | (length <= rcvbuf_at)).all(dim=1)

        elig = _eligibility(cfg, sim, inwin, t, wl, nonboot,
                            app_ok & sndbuf_ok & rcv_fit,
                            app_bulk.max_send_len + pf.HDR_UDP)

        ev = inwin & elig[:, None]                     # events we consume
        n_ev = ev.sum(dim=1, dtype=I32)                # [H]
        order = make_order(t, tie, impl=order_impl)

        matched = ev & (slot >= 0)
        nosock = ev & (slot < 0)
        S = net.sk_type.shape[1]
        arr_per_sock = _per_socket(matched, slot, S)   # [H,S]

        # ---- app: consume every matched delivery, stage replies ------
        d = BulkDeliveries(
            mask=matched, time=t, tie=tie, order=order, slot=slot,
            src_ip=src_ip, src_port=src_port, length=length, payref=payref,
        )
        sim2, sends = app_bulk.run(cfg, sim, d)
        net = sim2.net

        smask = sends.mask & elig[:, None]
        sport = _gather_hs_bulk(net.sk_bound_port, sends.slot)
        send_per_sock = _per_socket(smask, sends.slot, S)
        n_send = smask.sum(dim=1, dtype=I32)

        # ---- NIC egress: reliability draw, latency, outbox entries ---
        if app_bulk.resolves_dst:
            dsth = sends.dst_host
        else:
            dsth = torch.where(sends.dst_host >= 0, sends.dst_host,
                               host_of_ip(net, sends.dst_ip))
        known = smask & (dsth >= 0)
        V = net.latency_ns.shape[0]
        if V == 1:
            lat = net.latency_ns[0, 0]
        else:
            vsrc = net.vertex_of_host[lane.long()][:, None].long()
            vdst = net.vertex_of_host[dsth.clamp(0, GH - 1).long()].long()
            lat = net.latency_ns[vsrc, vdst]
        if lossless:
            drop = None
            emit_ok = known
        else:
            rel = (net.reliability[0, 0] if V == 1
                   else net.reliability[vsrc, vdst])
            u2 = rng.uniform_at(net.rng_keys, sends.nic_draw_ctr)
            drop = known & nonboot & (sends.length > 0) & (u2 > rel)
            emit_ok = known & ~drop

        # ---- audit parity: last_drop_status of the LAST drop in event
        # order (a no-socket arrival or a reliability-dropped reply)
        nosock_status = (
            q.words[:, :, pf.W_STATUS]
            | pf.PDS_ROUTER_ENQUEUED | pf.PDS_ROUTER_DEQUEUED
            | pf.PDS_RCV_INTERFACE_RECEIVED | pf.PDS_RCV_SOCKET_DROPPED)
        reply_drop_status = (pf.PDS_SND_CREATED | pf.PDS_SND_SOCKET_BUFFERED
                             | pf.PDS_SND_INTERFACE_SENT | pf.PDS_INET_DROPPED)
        drop_any = nosock if drop is None else nosock | drop
        drop_status = torch.where(nosock, nosock_status, reply_drop_status)
        n_drop = drop_any.sum(dim=1, dtype=I32)
        drop_rank = rank_in_order(order, drop_any)
        last_col = drop_any & (drop_rank == (n_drop[:, None] - 1))
        picked_drop = torch.where(last_col, drop_status, 0).sum(dim=1,
                                                               dtype=I32)
        new_last_drop = torch.where(elig & (n_drop > 0), picked_drop,
                                    net.last_drop_status)
        swl = torch.where(smask, (sends.length + pf.HDR_UDP).to(I64), 0)

        # ---- token buckets: closed-form final values ------------------
        qq = torch.where(
            ev, torch.div(t, TB_REFILL_INTERVAL, rounding_mode="floor"), 0)
        q_last = torch.maximum(qq.amax(dim=1), net.tb_quantum)
        q_last = torch.where(n_ev > 0, q_last, net.tb_quantum)
        qv = torch.where(ev, qq, q_last[:, None])  # inactive: no clamp bite
        w_recv = torch.where(nonboot, wl, 0)
        w_send = torch.where(nonboot & smask, swl, 0)
        suff_recv = suffix_sum(order, w_recv)
        suff_send = suffix_sum(order, w_send)
        cap_r = net.tb_recv_refill + pf.MTU
        cap_s = net.tb_send_refill + pf.MTU
        big = (2**63 - 1) // 2
        dq_total = q_last - net.tb_quantum

        def bucket_final(s0, cap, refill, w, suffw):
            straight = s0 + dq_total * refill - w.sum(dim=1)
            clamp = torch.where(
                ev,
                cap[:, None] - w + (q_last[:, None] - qv) * refill[:, None]
                - suffw,
                big,
            )
            return torch.minimum(straight, clamp.amin(dim=1))

        new_recv_tok = bucket_final(net.tb_recv_tokens, cap_r,
                                    net.tb_recv_refill, w_recv, suff_recv)
        new_send_tok = bucket_final(net.tb_send_tokens, cap_s,
                                    net.tb_send_refill, w_send, suff_send)

        # ---- outbox entries at the event's time-order column ----------
        # Ranks are unique among emit_ok, so no column collides: a
        # scatter into M + 1 columns (the last one takes every
        # non-emitted slot and is cut off) places every reply. The
        # reference's cube form uses a one-hot [H,K,M] reduce instead;
        # both give the same outbox.
        ord_col = rank_in_order(order, ev)             # rank < K <= M
        send_rank = rank_in_order(order, emit_ok)
        seq = q.next_seq[:, None] + send_rank
        M = sim.outbox.capacity
        rows = torch.arange(H, device=dev)[:, None]
        col = torch.where(emit_ok, ord_col, M).long()

        def place(val, fill, dtype):
            base = torch.full((H, M + 1), fill, dtype=dtype, device=dev)
            base[rows, col] = torch.as_tensor(val, device=dev).to(
                dtype).expand(H, K)
            return base[:, :M]

        got = torch.zeros((H, M + 1), dtype=torch.bool, device=dev)
        got[rows, col] = True
        got_col = got[:, :M]
        out = sim.outbox
        o_dst = place(dsth, -1, I32)
        o_time = place(t + lat, simtime.INVALID, I64)
        o_src = place(lane[:, None], 0, I32)
        o_seq = place(seq, 0, I32)
        o_kind = torch.where(got_col, EventKind.PACKET, 0).to(I32)
        # reply packet words (udp_enqueue_send layout) with the audit
        # bits the serial path accumulates by wire time
        NW = q.words.shape[2]
        wds = torch.zeros((H, K, NW), dtype=I32, device=dev)
        wds[:, :, pf.W_PROTO] = pf.PROTO_UDP
        wds[:, :, pf.W_LEN] = sends.length
        wds[:, :, pf.W_PORTS] = pf.pack_ports(sport, sends.dst_port)
        wds[:, :, pf.W_PAYREF] = sends.payref
        wds[:, :, pf.W_DSTIP] = u32_to_i32(sends.dst_ip)
        wds[:, :, pf.W_STATUS] = (
            pf.PDS_SND_CREATED | pf.PDS_SND_SOCKET_BUFFERED
            | pf.PDS_SND_INTERFACE_SENT | pf.PDS_INET_SENT)
        o_words = torch.zeros((H, M + 1, NW), dtype=I32, device=dev)
        o_words[rows, col] = wds
        o_words = o_words[:, :M]
        keep = ~got_col
        out = out.replace(
            dst=torch.where(keep, out.dst, o_dst),
            time=torch.where(keep, out.time, o_time),
            kind=torch.where(keep, out.kind, o_kind),
            src=torch.where(keep, out.src, o_src),
            seq=torch.where(keep, out.seq, o_seq),
            words=torch.where(keep[:, :, None], out.words, o_words),
            count=torch.where(elig, got_col.sum(dim=1, dtype=I32),
                              out.count),
        )

        # ---- state deltas (bit-identical to the serial chain) ---------
        BI = net.in_src_ip.shape[2]
        BO = net.out_words.shape[2]
        R = net.rq_src.shape[1]
        any_arr = arr_per_sock > 0

        def rowsum(m, v=None):
            x = m if v is None else torch.where(m, v, 0)
            return x.sum(dim=1, dtype=I64)

        net = net.replace(
            tb_recv_tokens=torch.where(elig, new_recv_tok, net.tb_recv_tokens),
            tb_send_tokens=torch.where(elig, new_send_tok, net.tb_send_tokens),
            tb_quantum=torch.where(elig, q_last, net.tb_quantum),
            # every arrival cycles through the router ring: head moves
            # by the arrival count, count/bytes return to zero
            rq_head=torch.where(elig, (net.rq_head + n_ev) % R, net.rq_head),
            # input rings: k push/pop pairs advance head by k; READABLE
            # ends cleared, one in-gen edge per arrival
            in_head=torch.where(any_arr, (net.in_head + arr_per_sock) % BI,
                                net.in_head),
            sk_in_gen=net.sk_in_gen + arr_per_sock,
            sk_flags=torch.where(any_arr,
                                 net.sk_flags & ~SocketFlags.READABLE,
                                 net.sk_flags),
            # output rings: enqueue+drain pairs advance head and bump
            # the per-host packet priority counter
            out_head=torch.where(send_per_sock > 0,
                                 (net.out_head + send_per_sock) % BO,
                                 net.out_head),
            priority_ctr=net.priority_ctr + n_send.to(I64),
            ctr_rx_packets=net.ctr_rx_packets + rowsum(matched),
            ctr_rx_bytes=net.ctr_rx_bytes + rowsum(matched, wl),
            ctr_rx_data_bytes=net.ctr_rx_data_bytes + rowsum(matched, length),
            ctr_tx_data_bytes=net.ctr_tx_data_bytes
            + rowsum(smask, sends.length),
            last_drop_status=new_last_drop,
            ctr_drop_nosocket=net.ctr_drop_nosocket + rowsum(nosock)
            + rowsum(smask & (dsth < 0)),
            ctr_tx_packets=net.ctr_tx_packets + rowsum(smask),
            ctr_tx_bytes=net.ctr_tx_bytes + rowsum(smask, swl),
            ctr_drop_reliability=(net.ctr_drop_reliability if drop is None
                                  else net.ctr_drop_reliability
                                  + rowsum(drop)),
            ctr_events_exec=net.ctr_events_exec + n_ev.to(I64),
        )

        # consume the window's events
        q = q.replace(
            time=torch.where(ev, simtime.INVALID, q.time),
            next_seq=q.next_seq + emit_ok.sum(dim=1, dtype=I32),
        )
        sim2 = sim2.replace(events=q, outbox=out, net=net)
        return sim2, n_ev.sum(dtype=I64)

    return bulk_fn
