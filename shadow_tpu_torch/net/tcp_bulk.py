"""TCP bulk window pass (PyTorch port of shadow_tpu/net/tcp_bulk.py):
consume a host's whole window of steady-state TCP traffic without
running the full micro-step pipeline per event.

Each iteration pops one event per host from a candidate queue and
applies only the reduced steady-state semantics of the reference's
pass (its module docstring lists them: in-order and out-of-order data,
pure ACKs with RTT/RTO and congestion growth, flush bursts chained
through TCP_FLUSH continuations, segment wiring with the exact
reliability draws and outbox sequence numbers, delayed-ACK and RTX
timer fires, the loss regime with SACK, fast retransmit and recovery,
and the NIC output-ring path of token-limited senders). A host that
meets anything outside the model stops there: its rows revert to the
iteration-start state (prefix commit), and the serial window fixpoint
continues from exactly that state. Every eligible host's candidate
state is merged at the end, so the final state is bit-identical to the
serial path.

The reference's lax.while_loop is a Python loop, and each lax.cond is
an `if` on a host read. Every section is a masked batch update, so a
skipped section with an all-false mask is the identity, and a section
may be gated on any superset of its mask. Host reads per iteration
(each one `cudaStreamSynchronize`):

1. after the pop: the number of popped events and their kind bitmask
   (loop test, and the DACK-fire and RTX-fire gates);
2. [first-sample buffer sizing, dup-ACK, ACK of our FIN] together;
3. [reassembly merge/park, peer FIN] (the latter alone when lossless);
4. delayed-ACK scheduling;
5. [flush continuation, RTO arm (a superset, taken before the chain
   push), secondary close] together;
6. the wire stage's gates together: [retransmit, pure ACK, secondary
   FIN, ring lanes, drain (a superset)], plus the longest fast flush
   burst, so that burst packets no lane sends are not wired;
7. one per NIC drain pass after the first (a pass with no active lane
   ends the drain, as the serial NIC's does);
8. the prefix-commit revert.

Reads 2-4 are skipped outright when no packet was popped (their masks
are subsets of the popped packets). The window's eligibility test is
one more read per call. The reliability draws of the wire stage and of
the drain are computed once per iteration for every counter they can
use (uniform_at is a pure function of the counter).

Leaves are told apart by object identity in the revert, as in the
reference: every update builds a new tensor and leaves untouched
fields as the same object, so nothing in the body writes in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from shadow_tpu_torch.compile.specialize import loss_trimmed
from shadow_tpu_torch.core import rng, simtime
from shadow_tpu_torch.core.events import (
    EventKind, Popped, _onehot, _tie_key, kind_mask, push_rows, u32_to_i32)
from shadow_tpu_torch.net import packetfmt as pf
from shadow_tpu_torch.net import tcp_cong as cong
from shadow_tpu_torch.net.nic import ip_from_word, next_refill_time
from shadow_tpu_torch.net.rings import (
    gather_hs, ring_push_at, set_hs, set_ring)
from shadow_tpu_torch.net.sockets import lookup_socket, set_writable
from shadow_tpu_torch.net.state import (
    NetConfig, QDisc, RouterQ, SocketFlags, host_of_ip, ip_of_hosts)
from shadow_tpu_torch.net.tcp import (
    DACK_QUICK_LIMIT, DACK_QUICK_NS, DACK_SLOW_NS, FLUSH_SEGMENTS,
    MAX_BACKOFF, MSS, RECV_BUFFER_MIN, RESTART_CWND, RTO_MAX_MS, RTO_MIN_MS,
    SEND_BUFFER_MIN, SNDMEM_SKB, TCP_RMEM_MAX, TCP_WMEM_MAX, TIMEWAIT_NS,
    TcpSt, _free_socket, _ms, _slot_words, sack_advert, sack_clip_len,
    stamp_at_wire, wire_ack_departed)

I32 = torch.int32
I64 = torch.int64
M32 = 0xFFFFFFFF
BOOL = torch.bool


class TcpAppBulk:
    """App contract for the TCP bulk pass (the reference's, unchanged).

    The bulk pass calls `on_data` once per delivered in-order segment
    and expects the steady-state relay/server pattern: consume
    everything available synchronously, optionally submit bytes on a
    forward socket at the same instant. Anything richer must be
    excluded by precheck — those hosts take the serial path."""

    def precheck(self, cfg: NetConfig, sim):
        """[H] bool — hosts whose app is in the steady consume/forward
        state this pass models."""
        raise NotImplementedError

    def on_data(self, cfg: NetConfig, app, mask, slot, nread, now):
        """One in-order delivery on (lane, slot) at `now` of `nread`
        bytes (everything available). Returns (app', ok[H],
        fwd_mask[H], fwd_slot[H], fwd_bytes[H]): ok False where the app
        would not read this socket fully now (the host stops); fwd_*
        request a tcp_send on fwd_slot at the same instant."""
        raise NotImplementedError

    def on_eof(self, cfg: NetConfig, app, mask, slot, now):
        """Peer FIN consumed on (lane, slot) at `now`. Returns (app',
        ok[H], c1_mask, c1_slot, c2_mask, c2_slot): up to two sockets
        the app closes at this instant, in call order. Default: any
        EOF is out of model."""
        H = mask.shape[0]
        z = torch.zeros((H,), dtype=BOOL, device=mask.device)
        zi = torch.zeros((H,), dtype=I32, device=mask.device)
        return app, ~mask, z, zi, z, zi


def _flag(bad, why, cond, bit):
    """Raise the abort flag and record which model boundary was hit
    (the reference's bit assignment)."""
    return bad | cond, why | torch.where(cond, bit, 0)


def _pop_masked(q, wend, allow):
    """pop_earliest with a per-host allow mask."""
    t = q.time
    tmin = t.amin(dim=1, keepdim=True)
    tie = torch.where(t == tmin, _tie_key(q.src, q.seq), simtime.INVALID)
    idx = tie.argmin(dim=1)
    rows = torch.arange(q.num_hosts, device=t.device)
    ptime = t[rows, idx]
    valid = allow & (ptime < wend)
    sel = _onehot(valid, idx, q.capacity)
    q2 = q.replace(time=torch.where(sel, simtime.INVALID, q.time))
    return q2, Popped(valid=valid, time=ptime, kind=q.kind[rows, idx],
                      src=q.src[rows, idx], seq=q.seq[rows, idx],
                      words=q.words[rows, idx])


def _push_local(q, mask, time, kind, words, lane, seq):
    """push_rows with an explicit seq (the pass carries the per-source
    counter itself)."""
    return push_rows(q, mask, time,
                     torch.full(mask.shape, kind, dtype=I32,
                                device=mask.device),
                     lane, seq, words)


def _hmask(m, ndim):
    return m.reshape(m.shape + (1,) * (ndim - 1))


def _select_written(prev, new, stopped, H):
    """`new` with every leaf the iteration wrote (object identity
    differs from `prev`) whose leading dimension is H reverted to
    `prev` on the stopped lanes."""
    if prev is new:
        return new
    if dataclasses.is_dataclass(new):
        kw = {}
        for f in dataclasses.fields(new):
            b = getattr(new, f.name)
            c = _select_written(getattr(prev, f.name), b, stopped, H)
            if c is not b:
                kw[f.name] = c
        return dataclasses.replace(new, **kw) if kw else new
    if isinstance(new, torch.Tensor) and new.ndim >= 1 \
            and new.shape[0] == H:
        return torch.where(_hmask(stopped, new.ndim), prev, new)
    return new


def _merge(orig, cand, commit, H):
    """Committed lanes take the candidate's rows; scalars and tables
    whose leading dimension is not H keep the original."""
    if orig is cand:
        return orig
    if dataclasses.is_dataclass(orig):
        kw = {}
        for f in dataclasses.fields(orig):
            a = getattr(orig, f.name)
            c = _merge(a, getattr(cand, f.name), commit, H)
            if c is not a:
                kw[f.name] = c
        return dataclasses.replace(orig, **kw) if kw else orig
    if isinstance(orig, torch.Tensor) and orig.ndim >= 1 \
            and orig.shape[0] == H:
        return torch.where(_hmask(commit, orig.ndim), cand, orig)
    return orig


def _scatter_col(arr, colc, value):
    """arr[h, colc[h]] = value[h] for every row, out of place."""
    if arr.ndim == 3:
        idx = colc[:, None, None].expand(-1, 1, arr.shape[2])
        return arr.scatter(1, idx, value[:, None, :].to(arr.dtype))
    return arr.scatter(1, colc[:, None], value[:, None].to(arr.dtype))


def _outbox_put(out, rows, colc, okb, dst, time, lane, seq, words):
    """One outbox entry per okb lane at column colc (clipped), the
    other lanes rewrite their own value (the reference's .at[].set of a
    where on the old value)."""
    def put(arr, v):
        old = arr[rows, colc]
        m = okb[:, None] if arr.ndim == 3 else okb
        return _scatter_col(arr, colc, torch.where(m, v, old))
    return out.replace(
        dst=put(out.dst, dst.to(I32)),
        time=put(out.time, time),
        kind=put(out.kind, torch.full_like(out.kind[:, 0],
                                           EventKind.PACKET)),
        src=put(out.src, lane.to(I32)),
        seq=put(out.seq, seq.to(I32)),
        words=put(out.words, words),
    )


def _col(u, k):
    """Column k of the precomputed draws, None when the loss trim left
    them out."""
    return None if u is None else u[:, k]


def _read(counters, *preds):
    """One host read of several predicates' any() (one sync)."""
    counters["reads"] += 1
    return [bool(x) for x in torch.stack([p.any() for p in preds]).tolist()]


def make_tcp_bulk_fn(cfg: NetConfig, app_bulk: TcpAppBulk,
                     debug: bool = False,
                     lossless: bool = False,
                     caps=None) -> Callable | None:
    """Build the TCP bulk window pass ``bulk_fn(sim, wend) -> (sim, n)``,
    or None when the config cannot support it (the reference's static
    preconditions). debug=True makes bulk_fn return a third value, the
    dict {elig, bad, why, commit, iters}. lossless=True is the
    reference's narrow pass: every loss artifact stops the lane instead
    of being modeled (bit-identical for any workload). `caps`
    (compile/specialize.py, None = full program) with a dropped loss
    capability skips the wire reliability draws (see rel_dead below).

    `bulk_fn.counters` accumulates host-side tallies across calls:
    calls, passes (calls with an eligible host), iterations and host
    reads."""
    if not cfg.tcp:
        return None
    if cfg.qdisc != QDisc.FIFO or cfg.router_qdisc != RouterQ.CODEL:
        return None
    if cfg.pcap or cfg.track_paths:
        return None
    if cfg.cpu_threshold_ns >= 0:
        return None
    if cfg.nic_drain != FLUSH_SEGMENTS:
        # the fused wire path models one flush burst + one full drain
        return None
    if cfg.out_ring <= FLUSH_SEGMENTS:
        # one burst must fit the ring with room to spare
        return None

    R = cfg.router_ring
    BO = cfg.out_ring
    # Capability trim (compile/specialize.py): a dropped loss capability
    # removes the per-wire reliability draws. Distinct from `lossless`
    # above: that knob narrows the TCP *artifact* model (SACK, recovery
    # and RTO stop lanes); this one skips the wire drop draw itself.
    # uniform_at is a pure counter query and the draw bookkeeping
    # (`drawn`, the counter offsets) is kept, so every surviving draw
    # site sees the reference's counters.
    rel_dead = loss_trimmed(caps)
    alg = cfg.tcp_cong
    counters = {"calls": 0, "passes": 0, "iterations": 0, "reads": 0}

    def _sack_stamps(tcp, at_slot):
        """The SACK advertisement for a departing packet — identically
        zero in the lossless model."""
        if lossless:
            z = torch.zeros(at_slot.shape, dtype=I32, device=at_slot.device)
            return ((z, z), (z, z), (z, z))
        return sack_advert(tcp, at_slot)

    def bulk_fn(sim, wend):
        counters["calls"] += 1
        net0 = sim.net
        q0 = sim.events
        H, K = q0.time.shape
        dev = q0.time.device
        S = net0.sk_type.shape[1]
        GH = net0.host_ip.shape[0]
        lane = net0.lane_id
        lane64 = lane.to(I64)
        rows = torch.arange(H, device=dev)
        wend64 = int(wend)

        # ---- host-level static eligibility ---------------------------
        inwin0 = q0.time < wend64
        nonboot = (~inwin0 | (q0.time >= cfg.bootstrap_end)).all(dim=1)
        out_backlog = net0.out_count.sum(dim=1) > 0
        send_consistent = ~out_backlog | net0.nic_send_pending
        quiesced = (
            (net0.rq_count == 0)
            & ~net0.nic_recv_pending
            & ~net0.nic_send_now
            & send_consistent
            & (net0.in_count.sum(dim=1) == 0)
            & ~net0.proc_stopped)
        codel_ok = ~net0.codel_dropping & (net0.codel_interval_expire == 0)
        app_ok = app_bulk.precheck(cfg, sim)
        has_work = inwin0.any(dim=1)
        if lossless:
            # the narrow pass neither models nor stamps parked
            # reassembly/scoreboard state: hosts carrying any are
            # ineligible outright
            no_parked = ~((sim.tcp.oo_r > sim.tcp.oo_l).any(dim=2).any(dim=1)
                          | (sim.tcp.sack_r > sim.tcp.sack_l).any(dim=2)
                          .any(dim=1))
            app_ok = app_ok & no_parked
        elig = nonboot & quiesced & codel_ok & app_ok & has_work
        # precheck failures land in the top why bits for the debug view
        why0 = (torch.where(~nonboot, 1 << 57, 0)
                | torch.where(~quiesced, 1 << 58, 0)
                | torch.where(~codel_ok, 1 << 59, 0)
                | torch.where(~app_ok, 1 << 60, 0)
                | torch.where(~has_work, 1 << 61, 0))

        # a window with no eligible host skips the whole pass
        (any_elig,) = _read(counters, elig)
        if not any_elig:
            z = torch.zeros((), dtype=I64, device=dev)
            if debug:
                return sim, z, {"elig": elig, "bad": ~elig, "why": why0,
                                "commit": torch.zeros_like(elig),
                                "iters": 0}
            return sim, z
        counters["passes"] += 1

        # ---- per-socket per-window constants -------------------------
        peer_h = host_of_ip(net0, net0.sk_peer_ip)              # [H,S]
        peer_hc = peer_h.clamp(0, GH - 1).to(I64)
        vsrc = net0.vertex_of_host[lane64].to(I64)[:, None]      # [H,1]
        vdst = net0.vertex_of_host[peer_hc].to(I64)              # [H,S]
        lat_s = net0.latency_ns[vsrc, vdst]
        lat_rev_s = net0.latency_ns[vdst, vsrc]
        rel_s = net0.reliability[vsrc, vdst]
        peer_up_s = net0.bw_up_kibps[peer_hc]
        peer_down_s = net0.bw_down_kibps[peer_hc]
        vsrc_h = net0.vertex_of_host[lane64].to(I64)

        sim_start = sim
        bad = ~elig
        why = why0
        seq_ctr = q0.next_seq
        it = 0
        while it < 4 * K + 8:
            sim_prev, seq_prev, bad_prev = sim, seq_ctr, bad
            net, tcp, app = sim.net, sim.tcp, sim.app
            q, p = _pop_masked(sim.events, wend64, ~bad & elig)
            counters["reads"] += 1
            n_pop, kbits = torch.stack(
                [p.valid.sum(dtype=I64), kind_mask(p.kind, p.valid)]).tolist()
            if n_pop == 0:
                break
            it += 1
            any_pkt = bool(kbits >> EventKind.PACKET & 1)
            any_dk = bool(kbits >> EventKind.TCP_DACK_TIMER & 1)
            any_rtx = bool(kbits >> EventKind.TCP_RTX_TIMER & 1)
            W = q.words.shape[-1]
            v = p.valid
            t = p.time
            words = p.words
            is_pkt = v & (p.kind == EventKind.PACKET)
            is_dk = v & (p.kind == EventKind.TCP_DACK_TIMER)
            is_fl = v & (p.kind == EventKind.TCP_FLUSH)
            is_rtx = v & (p.kind == EventKind.TCP_RTX_TIMER)
            is_ns = v & (p.kind == EventKind.NIC_SEND)
            bad, why = _flag(bad, why,
                             v & ~(is_pkt | is_dk | is_fl | is_rtx | is_ns),
                             1)

            # ===== packet classification =============================
            proto = pf.proto_of(words)
            flags = pf.tcp_flags_of(words)
            bad, why = _flag(bad, why, is_pkt & (proto != pf.PROTO_TCP), 2)
            finp = is_pkt & (flags == (pf.TCPF_FIN | pf.TCPF_ACK))
            bad, why = _flag(bad, why,
                             is_pkt & (flags != pf.TCPF_ACK) & ~finp, 4)
            # a FIN carrying data is out of model
            bad, why = _flag(bad, why, finp & (words[:, pf.W_LEN] != 0),
                             1 << 44)

            src_port, dst_port = pf.ports_of(words)
            dst_ip = ip_from_word(words[:, pf.W_DSTIP])
            src_ip = ip_of_hosts(cfg, net, p.src)
            slot = lookup_socket(
                net, is_pkt, torch.full((H,), pf.PROTO_TCP, dtype=I32,
                                        device=dev),
                dst_ip, dst_port, src_ip, src_port)
            bad, why = _flag(bad, why, is_pkt & (slot < 0), 16)
            slot = torch.where(slot >= 0, slot, 0)
            st = gather_hs(tcp.st, slot)
            # teardown states are in model; handshake, TIME_WAIT
            # stragglers and recycled slots are not
            bad, why = _flag(bad, why, is_pkt & ~(
                (st == TcpSt.ESTABLISHED) | (st == TcpSt.FIN_WAIT_1)
                | (st == TcpSt.FIN_WAIT_2) | (st == TcpSt.CLOSING)
                | (st == TcpSt.CLOSE_WAIT) | (st == TcpSt.LAST_ACK)), 32)
            pkt = is_pkt & ~bad
            finp = finp & ~bad

            seqno = words[:, pf.W_SEQ]
            ackno = words[:, pf.W_ACK]
            length = words[:, pf.W_LEN]
            peer_win = words[:, pf.W_WIN]
            tsval = words[:, pf.W_TSVAL]
            tsecho = words[:, pf.W_TSECHO]
            is_data = pkt & (length > 0) & ~finp
            is_ack = pkt & (length == 0) & ~finp
            # data only reaches sockets in the serial has_data states
            bad, why = _flag(bad, why, is_data & ~(
                (st == TcpSt.ESTABLISHED) | (st == TcpSt.FIN_WAIT_1)
                | (st == TcpSt.FIN_WAIT_2)), 1 << 45)
            is_data = is_data & ~bad

            rcv_nxt = gather_hs(tcp.rcv_nxt, slot)
            bad, why = _flag(bad, why, finp & (seqno != rcv_nxt), 1 << 46)
            sc = slot.clamp(0, S - 1).to(I64)
            # data or a re-FIN after the peer's FIN stays serial
            bad, why = _flag(bad, why, (is_data | finp)
                             & gather_hs(tcp.fin_rcvd, slot), 256)
            pkt = pkt & ~bad
            is_data = is_data & ~bad
            is_ack = is_ack & ~bad

            # ===== router ring cycle + rx token charge ================
            wl_in = pf.wire_length(proto, length).to(I64)
            net = net.replace(
                rq_head=torch.where(pkt, (net.rq_head + 1) % R, net.rq_head))
            tq = torch.div(t, simtime.ONE_MILLISECOND, rounding_mode="floor")
            dq = (tq - net.tb_quantum).clamp(min=0)
            # a popped NIC_SEND refills at entry like the serial handler
            refresh = (pkt | is_ns) & (dq > 0)
            recv_tok = torch.minimum(net.tb_recv_refill + pf.MTU,
                                     net.tb_recv_tokens
                                     + dq * net.tb_recv_refill)
            send_tok0 = torch.minimum(net.tb_send_refill + pf.MTU,
                                      net.tb_send_tokens
                                      + dq * net.tb_send_refill)
            net = net.replace(
                tb_recv_tokens=torch.where(refresh, recv_tok,
                                           net.tb_recv_tokens),
                tb_send_tokens=torch.where(refresh, send_tok0,
                                           net.tb_send_tokens),
                tb_quantum=torch.where(refresh, tq, net.tb_quantum),
            )
            bad, why = _flag(bad, why, pkt & (net.tb_recv_tokens < pf.MTU),
                             2048)
            net = net.replace(tb_recv_tokens=(
                net.tb_recv_tokens - torch.where(pkt, wl_in, 0)).clamp(min=0))
            net = net.replace(
                ctr_rx_packets=net.ctr_rx_packets + pkt.to(I64),
                ctr_rx_bytes=net.ctr_rx_bytes + torch.where(pkt, wl_in, 0),
                ctr_rx_data_bytes=net.ctr_rx_data_bytes
                + torch.where(pkt, length, 0).to(I64),
            )

            # ===== reduced tcp_packet_in ==============================
            tsr = gather_hs(tcp.ts_recent, slot)
            tcp = tcp.replace(ts_recent=set_hs(
                tcp.ts_recent, pkt & (seqno <= rcv_nxt) & (tsval >= tsr),
                slot, tsval))

            # snd_wnd + SACK scoreboard replacement; under lossless an
            # arriving SACK block stops the lane
            wnd_prev = gather_hs(tcp.snd_wnd, slot)
            tcp = tcp.replace(snd_wnd=set_hs(tcp.snd_wnd, pkt, slot,
                                             peer_win))
            if lossless:
                sack_any = ((words[:, pf.W_SACKL] != 0)
                            | (words[:, pf.W_SACKR] != 0)
                            | (words[:, pf.W_SACKL2] != 0)
                            | (words[:, pf.W_SACKR2] != 0)
                            | (words[:, pf.W_SACKL3] != 0)
                            | (words[:, pf.W_SACKR3] != 0))
                bad, why = _flag(bad, why, is_pkt & sack_any, 1 << 32)
                pkt = pkt & ~bad
                is_data = is_data & ~bad
                is_ack = is_ack & ~bad
            else:
                sack_l3 = torch.stack([words[:, pf.W_SACKL],
                                       words[:, pf.W_SACKL2],
                                       words[:, pf.W_SACKL3]], dim=1)
                sack_r3 = torch.stack([words[:, pf.W_SACKR],
                                       words[:, pf.W_SACKR2],
                                       words[:, pf.W_SACKR3]], dim=1)
                sel_sk = _onehot(pkt, slot, S)[..., None]
                tcp = tcp.replace(
                    sack_l=torch.where(sel_sk, sack_l3[:, None, :],
                                       tcp.sack_l),
                    sack_r=torch.where(sel_sk, sack_r3[:, None, :],
                                       tcp.sack_r),
                )

            una = gather_hs(tcp.snd_una, slot)
            nxt = gather_hs(tcp.snd_nxt, slot)
            smax = gather_hs(tcp.snd_max, slot)
            new_ack = pkt & (ackno > una) & (ackno <= smax)
            bad, why = _flag(bad, why, pkt & (ackno > smax), 4096)
            # healing ACK past a rewound snd_nxt jumps forward
            if lossless:
                bad, why = _flag(bad, why, new_ack & (ackno > nxt), 8192)
                new_ack = new_ack & ~bad
            else:
                heal = new_ack & (ackno > nxt)
                tcp = tcp.replace(snd_nxt=set_hs(tcp.snd_nxt, heal, slot,
                                                 ackno))
                nxt = torch.where(heal, ackno, nxt)
            dup_ack = pkt & (ackno == una) & (una < nxt) & (length == 0) \
                & (peer_win == wnd_prev) & ~finp
            # a data segment whose ack also advances our send side is
            # out of model
            bad, why = _flag(bad, why, pkt & (length > 0) & (ackno > una),
                             1 << 43)
            new_ack = new_ack & ~bad

            # RTT / RTO (ref: tcp.c:991-1026)
            rtt = (_ms(t) - tsecho).clamp(min=1)
            srtt = gather_hs(tcp.srtt_ms, slot)
            sample = new_ack & (tsecho > 0)
            first = sample & (srtt < 0)
            rttvar = gather_hs(tcp.rttvar_ms, slot)
            srtt_n = torch.where(first, rtt, srtt + (rtt - srtt) // 8)
            rttvar_n = torch.where(first, rtt // 2,
                                   (3 * rttvar + (srtt - rtt).abs()) // 4)
            rto_n = (srtt_n + (4 * rttvar_n).clamp(min=1)).clamp(
                RTO_MIN_MS, RTO_MAX_MS)
            tcp = tcp.replace(
                srtt_ms=set_hs(tcp.srtt_ms, sample, slot, srtt_n),
                rttvar_ms=set_hs(tcp.rttvar_ms, sample, slot, rttvar_n),
                rto_ms=set_hs(tcp.rto_ms, sample, slot, rto_n),
                backoff=set_hs(tcp.backoff, new_ack, slot, 0),
            )

            # congestion hooks — the serial engine's code path
            in_rec = gather_hs(tcp.in_recovery, slot)
            if lossless:
                bad, why = _flag(bad, why, pkt & in_rec, 1024)
                bad, why = _flag(bad, why,
                                 pkt & (gather_hs(tcp.dup_acks, slot) > 0),
                                 1 << 33)
                bad, why = _flag(bad, why, dup_ack, 16384)
                pkt = pkt & ~bad
                is_data = is_data & ~bad
                is_ack = is_ack & ~bad
                new_ack = new_ack & ~bad
            recover = gather_hs(tcp.recover, slot)
            cwnd = gather_hs(tcp.cwnd, slot)
            ssth = gather_hs(tcp.ssthresh, slot)
            ca = gather_hs(tcp.ca_acc, slot)
            n_acked = torch.where(new_ack, (ackno - una + MSS - 1) // MSS, 0)
            if lossless:
                full_rec = torch.zeros((H,), dtype=BOOL, device=dev)
                partial = full_rec
                normal = new_ack
            else:
                full_rec = new_ack & in_rec & (ackno >= recover)
                partial = new_ack & in_rec & (ackno < recover)
                normal = new_ack & ~in_rec
            ss = normal & (cwnd < ssth)
            grown = cwnd + n_acked
            spill = ss & (grown >= ssth)
            cwnd1 = torch.where(ss, torch.minimum(grown, ssth), cwnd)
            # leaving fast recovery deflates to ssthresh
            cwnd1 = torch.where(full_rec, ssth, cwnd1)
            ca_in = torch.where(spill, grown - ssth,
                                torch.where(full_rec | (normal & ~ss),
                                            n_acked, 0))
            in_ca = (normal & ~ss) | spill | full_rec
            ca_base = torch.where(spill | full_rec, 0, ca)
            cwnd1, ca1, epoch1 = cong.ca_update(
                alg, in_ca, cwnd1, torch.where(in_ca, ca_base, ca), ca_in,
                gather_hs(tcp.cub_wmax, slot),
                gather_hs(tcp.cub_epoch_ms, slot), _ms(t))
            tcp = tcp.replace(
                cwnd=set_hs(tcp.cwnd, new_ack, slot, cwnd1),
                ca_acc=set_hs(tcp.ca_acc, new_ack, slot, ca1),
                cub_epoch_ms=set_hs(tcp.cub_epoch_ms, in_ca, slot, epoch1),
                in_recovery=set_hs(tcp.in_recovery, full_rec, slot, False),
                dup_acks=set_hs(tcp.dup_acks, new_ack, slot, 0),
                snd_una=set_hs(tcp.snd_una, new_ack, slot, ackno),
            )

            # initial buffer sizing on the first RTT sample (ref:
            # tcp.c:1007-1009 + _tcp_tuneInitialBufferSizes)
            at_init = first & ~gather_hs(tcp.at_init_done, slot)
            # (the gate predicates of this stretch are read together:
            # nothing between here and the FIN-ACK section changes pkt
            # or fin_pending)
            fin_ever_any = pkt & gather_hs(tcp.fin_pending, slot)
            if any_pkt:
                g_init, g_dup, g_fin_ever = _read(
                    counters, at_init, dup_ack, fin_ever_any)
            else:
                g_init = g_dup = g_fin_ever = False
            if g_init:
                peer_ip_sl = gather_hs(net.sk_peer_ip, slot)
                self_ip = net.host_ip[lane64]
                is_loop = (peer_ip_sl == self_ip) | ((peer_ip_sl >> 24) == 127)
                rtt_topo_ms = torch.div(
                    gather_hs(lat_s, slot) + gather_hs(lat_rev_s, slot),
                    simtime.ONE_MILLISECOND,
                    rounding_mode="floor").clamp(min=1)
                my_up = net.bw_up_kibps[lane64]
                my_down = net.bw_down_kibps[lane64]
                bdp_snd = rtt_topo_ms * torch.minimum(
                    my_up, gather_hs(peer_down_s, slot)) * 1280 // 1000
                bdp_rcv = rtt_topo_ms * torch.minimum(
                    my_down, gather_hs(peer_up_s, slot)) * 1280 // 1000
                init_snd = torch.where(
                    is_loop, TCP_WMEM_MAX,
                    bdp_snd.clamp(SEND_BUFFER_MIN, TCP_WMEM_MAX)).to(I32)
                init_rcv = torch.where(
                    is_loop, TCP_RMEM_MAX,
                    bdp_rcv.clamp(RECV_BUFFER_MIN, TCP_RMEM_MAX)).to(I32)
                net = net.replace(
                    sk_sndbuf=set_hs(net.sk_sndbuf, at_init & net.autotune_snd,
                                     slot, init_snd),
                    sk_rcvbuf=set_hs(net.sk_rcvbuf, at_init & net.autotune_rcv,
                                     slot, init_rcv))
                tcp = tcp.replace(at_init_done=set_hs(
                    tcp.at_init_done, at_init, slot, True))

            my_up = net.bw_up_kibps[lane64]
            # send-buffer autotune growth (ref: tcp.c:566-592)
            srtt_now = torch.where(sample, srtt_n, srtt).clamp(min=0).to(I64)
            max_wmem = (my_up * 1024 * srtt_now // 1000).clamp(
                TCP_WMEM_MAX, 10 * TCP_WMEM_MAX)
            want_snd = torch.minimum(SNDMEM_SKB * 2 * cwnd1.to(I64),
                                     max_wmem).to(I32)
            cur_snd = gather_hs(net.sk_sndbuf, slot)
            net = net.replace(sk_sndbuf=set_hs(
                net.sk_sndbuf,
                new_ack & net.autotune_snd & (want_snd > cur_snd),
                slot, want_snd))
            # ACK progress reopened stream room -> WRITABLE
            wroom = new_ack & (gather_hs(net.sk_sndbuf, slot)
                               - (gather_hs(tcp.snd_end, slot) - ackno) > 0)
            net = set_writable(net, wroom, slot, True)

            # dup-ack counting / fast retransmit entry (ref:
            # tcp.py:1110-1129); the retransmission is wired first in
            # the wire stage below
            enter_fr = torch.zeros((H,), dtype=BOOL, device=dev)
            if not lossless and g_dup:
                da = gather_hs(tcp.dup_acks, slot) + 1
                tcp = tcp.replace(dup_acks=set_hs(tcp.dup_acks, dup_ack,
                                                  slot, da))
                enter_fr = dup_ack & (da == 3) & ~in_rec
                ssth_fr = cong.ssthresh_on_loss(alg, cwnd)
                tcp = tcp.replace(
                    ssthresh=set_hs(tcp.ssthresh, enter_fr, slot, ssth_fr),
                    cwnd=set_hs(tcp.cwnd, enter_fr, slot,
                                cong.cwnd_on_recovery_entry(alg, ssth_fr)))
                wmax1, ep1 = cong.on_loss_event(
                    alg, enter_fr, cwnd, gather_hs(tcp.cub_wmax, slot),
                    gather_hs(tcp.cub_epoch_ms, slot))
                tcp = tcp.replace(
                    cub_wmax=set_hs(tcp.cub_wmax, enter_fr, slot, wmax1),
                    cub_epoch_ms=set_hs(tcp.cub_epoch_ms, enter_fr, slot,
                                        ep1),
                    in_recovery=set_hs(tcp.in_recovery, enter_fr, slot,
                                       True),
                    recover=set_hs(tcp.recover, enter_fr, slot, nxt),
                    fr_entries=tcp.fr_entries + enter_fr.to(I64))
                if alg != cong.AIMD:
                    # window inflation while in recovery (in_rec is the
                    # pre-entry value, as in the serial path)
                    inflate = dup_ack & in_rec
                    tcp = tcp.replace(cwnd=set_hs(
                        tcp.cwnd, inflate, slot,
                        gather_hs(tcp.cwnd, slot) + 1))
            # the segment at snd_una re-sends on recovery entry and on
            # every partial ACK (ref: tcp.py:1132)
            retx_ack = (enter_fr | partial) & ~bad

            # RTO deadline after progress
            still_out = new_ack & (ackno < smax)
            done_ack = new_ack & (ackno >= smax)
            rto_ns = gather_hs(tcp.rto_ms, slot).to(I64) \
                * simtime.ONE_MILLISECOND
            tcp = tcp.replace(rtx_expire=set_hs(tcp.rtx_expire, still_out,
                                                slot, t + rto_ns))
            tcp = tcp.replace(rtx_expire=set_hs(tcp.rtx_expire, done_ack,
                                                slot, simtime.INVALID))

            # ===== ACK of our FIN: teardown transitions ===============
            # LAST_ACK frees the socket through the serial _free_socket
            if g_fin_ever:
                smax_fa = gather_hs(tcp.snd_max, slot)
                fin_ever_fa = gather_hs(tcp.fin_pending, slot) & (
                    smax_fa == gather_hs(tcp.snd_end, slot) + 1)
                fin_acked = pkt & fin_ever_fa & (ackno == smax_fa)
                st_fa = gather_hs(tcp.st, slot)
                tcp = tcp.replace(st=set_hs(
                    tcp.st, fin_acked & (st_fa == TcpSt.FIN_WAIT_1), slot,
                    TcpSt.FIN_WAIT_2))
                tw1 = fin_acked & (st_fa == TcpSt.CLOSING)
                tcp = tcp.replace(st=set_hs(tcp.st, tw1, slot,
                                            TcpSt.TIME_WAIT))
                closed_now = fin_acked & (st_fa == TcpSt.LAST_ACK)
                sim_fs = _free_socket(cfg, sim.replace(net=net, tcp=tcp),
                                      closed_now, slot)
                net, tcp = sim_fs.net, sim_fs.tcp
                free_tw = (q.time == simtime.INVALID).any(dim=1)
                bad, why = _flag(bad, why, tw1 & ~free_tw, 1 << 47)
                tw1e = tw1 & ~bad
                q = _push_local(q, tw1e, t + TIMEWAIT_NS,
                                EventKind.TCP_CLOSE_TIMER,
                                _slot_words(slot), lane, seq_ctr)
                seq_ctr = seq_ctr + tw1e.to(I32)

            # ===== data receive (ref: tcp.py:1174-1247) ===============
            seg_end = seqno + length
            if lossless:
                bad, why = _flag(bad, why, is_data & (seqno != rcv_nxt), 64)
                is_data = is_data & ~bad
                pkt = pkt & ~bad
                freeb = gather_hs(net.sk_rcvbuf, slot) \
                    - gather_hs(tcp.app_rbytes, slot)
                bad, why = _flag(bad, why, is_data & (length > freeb), 65536)
                is_data = is_data & ~bad
                old_d = torch.zeros((H,), dtype=BOOL, device=dev)
                fresh = is_data
                fits = is_data
                inorder = is_data
                adv = torch.where(inorder, length, 0)
                rcv1 = rcv_nxt + adv
                rb0 = gather_hs(tcp.app_rbytes, slot)
                rbytes = rb0 + adv
                oo_pred = None
            else:
                old_d = is_data & (seg_end <= rcv_nxt)
                fresh = is_data & ~old_d
                oo_bytes = (tcp.oo_r[rows, sc] - tcp.oo_l[rows, sc]).sum(
                    dim=1, dtype=I32)
                freeb = gather_hs(net.sk_rcvbuf, slot) \
                    - gather_hs(tcp.app_rbytes, slot) - oo_bytes
                fits = fresh & (length <= freeb)
                tcp = tcp.replace(drop_rwin=tcp.drop_rwin
                                  + (fresh & ~fits).to(I64))
                inorder = fits & (seqno <= rcv_nxt)
                adv = torch.where(inorder, seg_end - rcv_nxt, 0)
                rcv1 = rcv_nxt + adv
                rb0 = gather_hs(tcp.app_rbytes, slot)
                rbytes = rb0 + adv
                oo_pred = (fits & (seqno > rcv_nxt)) | ((oo_bytes > 0)
                                                        & inorder)

            # peer FIN: in-order only, so it consumes immediately (its
            # mask is final here: no flag is raised before it is used)
            fin_now = finp & ~bad
            if not any_pkt:
                g_oo = g_fin = False
            elif lossless:
                (g_fin,) = _read(counters, fin_now)
                g_oo = False
            else:
                g_oo, g_fin = _read(counters, oo_pred, fin_now)

            ooseg = torch.zeros((H,), dtype=BOOL, device=dev)
            if g_oo:
                # merge any reassembly range now contiguous (unrolled
                # bounded scan, ref: tcp.py:1198-1212)
                NR = tcp.oo_l.shape[2]
                for _i in range(NR):
                    ool = tcp.oo_l[rows, sc]
                    oor = tcp.oo_r[rows, sc]
                    hit = (ool <= rcv1[:, None]) & (oor > ool)
                    take = (hit & inorder[:, None]).any(dim=1)
                    pick = hit.to(torch.uint8).argmax(dim=1)
                    new_r = oor[rows, pick]
                    gain = torch.where(take & (new_r > rcv1), new_r - rcv1, 0)
                    rcv1 = rcv1 + gain
                    rbytes = rbytes + gain
                    tcp = tcp.replace(
                        oo_l=set_ring(tcp.oo_l, take & inorder, slot, pick, 0),
                        oo_r=set_ring(tcp.oo_r, take & inorder, slot, pick, 0),
                    )
                # out-of-order: park [seq, seg_end) in a range
                ooseg = fits & (seqno > rcv_nxt)
                ool = tcp.oo_l[rows, sc]
                oor = tcp.oo_r[rows, sc]
                overlap = (seqno[:, None] <= oor) \
                    & (seg_end[:, None] >= ool) & (oor > ool)
                mergeable = overlap.any(dim=1)
                mpick = overlap.to(torch.uint8).argmax(dim=1)
                empty_rng = oor <= ool
                has_empty = empty_rng.any(dim=1)
                epick = empty_rng.to(torch.uint8).argmax(dim=1)
                do_merge = ooseg & mergeable
                do_new = ooseg & ~mergeable & has_empty
                dropped_oo = ooseg & ~mergeable & ~has_empty
                tcp = tcp.replace(drop_oo_full=tcp.drop_oo_full
                                  + dropped_oo.to(I64))
                pick = torch.where(do_merge, mpick, epick)
                nl = torch.where(do_merge,
                                 torch.minimum(ool[rows, pick], seqno), seqno)
                nr = torch.where(do_merge,
                                 torch.maximum(oor[rows, pick], seg_end),
                                 seg_end)
                tcp = tcp.replace(
                    oo_l=set_ring(tcp.oo_l, do_merge | do_new, slot, pick,
                                  nl),
                    oo_r=set_ring(tcp.oo_r, do_merge | do_new, slot, pick,
                                  nr),
                )
            tcp = tcp.replace(
                rcv_nxt=set_hs(tcp.rcv_nxt, inorder, slot, rcv1),
                app_rbytes=set_hs(tcp.app_rbytes, inorder, slot, rbytes),
            )
            readable = inorder & (gather_hs(tcp.app_rbytes, slot) > 0)
            fl_r = gather_hs(net.sk_flags, slot)
            net = net.replace(
                sk_flags=set_hs(net.sk_flags, readable, slot,
                                fl_r | SocketFlags.READABLE),
                sk_in_gen=set_hs(net.sk_in_gen, readable, slot,
                                 gather_hs(net.sk_in_gen, slot) + 1),
            )
            # loss-signalling ACKs go out immediately with the SACK
            # advertisement (ref: tcp.py:1289-1297)
            imm_ack = (old_d | ooseg | (fresh & ~fits)) & ~bad

            # ===== peer FIN (ref: tcp.c FIN processing) ===============
            # rcv_nxt+1, state transition, EOF readability edge;
            # FIN_WAIT_2 arms the TIME_WAIT reaper
            if g_fin:
                st_fp = gather_hs(tcp.st, slot)
                tcp = tcp.replace(
                    fin_rcvd=set_hs(tcp.fin_rcvd, fin_now, slot, True),
                    fin_rseq=set_hs(tcp.fin_rseq, fin_now, slot, seqno),
                )
                tcp = tcp.replace(rcv_nxt=set_hs(
                    tcp.rcv_nxt, fin_now, slot,
                    gather_hs(tcp.rcv_nxt, slot) + 1))
                to_cw = fin_now & (st_fp == TcpSt.ESTABLISHED)
                to_closing = fin_now & (st_fp == TcpSt.FIN_WAIT_1)
                to_tw = fin_now & (st_fp == TcpSt.FIN_WAIT_2)
                bad, why = _flag(bad, why,
                                 fin_now & ~(to_cw | to_closing | to_tw),
                                 1 << 48)
                tcp = tcp.replace(st=set_hs(tcp.st, to_cw, slot,
                                            TcpSt.CLOSE_WAIT))
                tcp = tcp.replace(st=set_hs(tcp.st, to_closing, slot,
                                            TcpSt.CLOSING))
                tcp = tcp.replace(st=set_hs(tcp.st, to_tw, slot,
                                            TcpSt.TIME_WAIT))
                tw2 = to_tw & ~bad
                free_tw2 = (q.time == simtime.INVALID).any(dim=1)
                bad, why = _flag(bad, why, tw2 & ~free_tw2, 1 << 49)
                tw2 = tw2 & ~bad
                q = _push_local(q, tw2, t + TIMEWAIT_NS,
                                EventKind.TCP_CLOSE_TIMER,
                                _slot_words(slot), lane, seq_ctr)
                seq_ctr = seq_ctr + tw2.to(I32)
                fl_f = gather_hs(net.sk_flags, slot)
                net = net.replace(
                    sk_flags=set_hs(net.sk_flags, fin_now, slot,
                                    fl_f | SocketFlags.READABLE),
                    sk_in_gen=set_hs(net.sk_in_gen, fin_now, slot,
                                     gather_hs(net.sk_in_gen, slot) + 1),
                )

            # delayed-ACK scheduling (ref: tcp.c:2066-2091); a consumed
            # FIN coalesces its ACK like in-order data
            ackable = inorder | (fin_now & ~bad)
            cnt = gather_hs(tcp.dack_counter, slot) + 1
            tcp = tcp.replace(dack_counter=set_hs(tcp.dack_counter, ackable,
                                                  slot, cnt))
            sched = ackable & ~gather_hs(tcp.dack_scheduled, slot)
            nq = gather_hs(tcp.quick_acks, slot)
            quick = nq < DACK_QUICK_LIMIT
            ddelay = torch.where(quick, DACK_QUICK_NS, DACK_SLOW_NS)
            tcp = tcp.replace(
                quick_acks=set_hs(tcp.quick_acks, sched & quick, slot,
                                  nq + 1),
                dack_scheduled=set_hs(tcp.dack_scheduled, sched, slot, True))
            if any_pkt and _read(counters, sched)[0]:
                dkw = _slot_words(slot,
                                  gather_hs(tcp.dack_gen, slot))
                free_before = (q.time == simtime.INVALID).any(dim=1)
                bad, why = _flag(bad, why, sched & ~free_before, 131072)
                q = _push_local(q, sched & ~bad, t + ddelay,
                                EventKind.TCP_DACK_TIMER, dkw, lane, seq_ctr)
                seq_ctr = seq_ctr + (sched & ~bad).to(I32)

            # ===== app consume + forward ==============================
            # tcp_recv semantics: read everything available
            avail = gather_hs(tcp.app_rbytes, slot)
            win_before = gather_hs(net.sk_rcvbuf, slot) - avail
            app, app_okm, fwd_mask, fwd_slot, fwd_bytes = app_bulk.on_data(
                cfg, app, inorder, slot, avail, t)
            bad, why = _flag(bad, why, inorder & ~app_okm, 262144)
            inorder = inorder & ~bad
            fwd_mask = fwd_mask & inorder
            tcp = tcp.replace(app_rbytes=set_hs(tcp.app_rbytes, inorder,
                                                slot, 0))
            # Linux-DRS receive autotune (ref: tcp.c:535-564)
            at_on = inorder & net.autotune_rcv
            copied = gather_hs(tcp.at_copied, slot) + avail
            space = torch.maximum(2 * copied, gather_hs(tcp.at_space, slot))
            cur_r = gather_hs(net.sk_rcvbuf, slot)
            srtt2 = gather_hs(tcp.srtt_ms, slot)
            my_down = net.bw_down_kibps[lane64]
            max_rmem = (my_down * 1024 * srtt2.clamp(min=0).to(I64)
                        // 1000).clamp(TCP_RMEM_MAX, 10 * TCP_RMEM_MAX)
            growing = at_on & (space > cur_r)
            tcp = tcp.replace(at_space=set_hs(tcp.at_space, growing, slot,
                                              space))
            new_size = torch.minimum(space.to(I64), max_rmem).to(I32)
            net = net.replace(sk_rcvbuf=set_hs(
                net.sk_rcvbuf, growing & (new_size > cur_r), slot, new_size))
            tcp = tcp.replace(at_copied=set_hs(tcp.at_copied, at_on, slot,
                                               copied))
            last = gather_hs(tcp.at_last, slot)
            tcp = tcp.replace(at_last=set_hs(tcp.at_last,
                                             at_on & (last == 0), slot, t))
            rtt_ns2 = srtt2.clamp(min=0).to(I64) * simtime.ONE_MILLISECOND
            reset = at_on & (last > 0) & (srtt2 > 0) & (t - last > rtt_ns2)
            tcp = tcp.replace(
                at_last=set_hs(tcp.at_last, reset, slot, t),
                at_copied=set_hs(tcp.at_copied, reset, slot, 0))
            # drained -> clear READABLE (no EOF in the eligible regime)
            fl_d = gather_hs(net.sk_flags, slot)
            net = net.replace(sk_flags=set_hs(
                net.sk_flags, inorder, slot, fl_d & ~SocketFlags.READABLE))
            # receiver silly-window update ACK => out of model
            win_after = gather_hs(net.sk_rcvbuf, slot)
            bad, why = _flag(bad, why, inorder & (win_before < 2 * MSS)
                             & (win_after - win_before >= MSS), 524288)

            # ===== app EOF: the teardown cascade ======================
            # up to two closes in call order (tcp_close semantics, ref:
            # tcp.c:604-699); the FIN rides via the flush below
            zb = torch.zeros((H,), dtype=BOOL, device=dev)
            zi32 = torch.zeros((H,), dtype=I32, device=dev)
            c1_mask, c1_slot, c2_mask, c2_slot = zb, zi32, zb, zi32
            if g_fin:
                app, eof_ok, c1_mask, c1_slot, c2_mask, c2_slot = \
                    app_bulk.on_eof(cfg, app, fin_now & ~bad, slot, t)
                bad, why = _flag(bad, why, fin_now & ~eof_ok, 1 << 50)
                c1_mask = c1_mask & fin_now & ~bad
                c2_mask = c2_mask & fin_now & ~bad
                c1_slot = c1_slot.to(I32)
                c2_slot = c2_slot.to(I32)

                def close_transitions(tcp, bad, why, cm, cs, bit):
                    cst = gather_hs(tcp.st, cs)
                    to_fw1 = cm & ((cst == TcpSt.ESTABLISHED)
                                   | (cst == TcpSt.SYN_RCVD))
                    to_la = cm & (cst == TcpSt.CLOSE_WAIT)
                    # other close paths are out of model
                    bad, why = _flag(bad, why, cm & ~(to_fw1 | to_la), bit)
                    tcp = tcp.replace(st=set_hs(tcp.st, to_fw1 & ~bad, cs,
                                                TcpSt.FIN_WAIT_1))
                    tcp = tcp.replace(st=set_hs(tcp.st, to_la & ~bad, cs,
                                                TcpSt.LAST_ACK))
                    tcp = tcp.replace(fin_pending=set_hs(
                        tcp.fin_pending, cm & ~bad, cs, True))
                    return tcp, bad, why

                tcp, bad, why = close_transitions(tcp, bad, why, c1_mask,
                                                  c1_slot, 1 << 51)
                tcp, bad, why = close_transitions(tcp, bad, why, c2_mask,
                                                  c2_slot, 1 << 52)
                c1_mask = c1_mask & ~bad
                c2_mask = c2_mask & ~bad

            # tcp_send semantics on the forward socket (full accept or
            # stop; ref: tcp_sendUserData, tcp.c:2126-2190)
            fsl = torch.where(fwd_mask, fwd_slot, 0)
            fst = gather_hs(tcp.st, fsl)
            can_send = fwd_mask & (
                (fst == TcpSt.ESTABLISHED) | (fst == TcpSt.CLOSE_WAIT)
                | (fst == TcpSt.SYN_SENT) | (fst == TcpSt.SYN_RCVD))
            bad, why = _flag(bad, why, fwd_mask & ~can_send, 1048576)
            f_una = gather_hs(tcp.snd_una, fsl)
            f_end = gather_hs(tcp.snd_end, fsl)
            f_sndbuf = gather_hs(net.sk_sndbuf, fsl)
            room = (f_sndbuf - (f_end - f_una)).clamp(min=0)
            bad, why = _flag(bad, why, can_send & (room < fwd_bytes), 2097152)
            bad, why = _flag(bad, why, can_send & (room - fwd_bytes <= 0),
                             4194304)
            can_send = can_send & ~bad
            tcp = tcp.replace(snd_end=set_hs(tcp.snd_end, can_send, fsl,
                                             f_end + fwd_bytes))

            # ===== flush of admissible segments =======================
            # data arrivals flush the forward socket; ACKs the arrival
            # socket; popped TCP_FLUSH continuations their own slot
            flslot = torch.where(is_fl, words[:, 0], 0)
            tcp = tcp.replace(flush_pending=set_hs(tcp.flush_pending, is_fl,
                                                   flslot, False))
            reopened = is_ack & (wnd_prev == 0) & (peer_win > 0)
            fl_mask = can_send | new_ack | reopened | is_fl | c1_mask
            fslot = torch.where(can_send, fsl,
                                torch.where(is_fl, flslot,
                                            torch.where(c1_mask, c1_slot,
                                                        slot)))
            g_una = gather_hs(tcp.snd_una, fslot)
            g_nxt = gather_hs(tcp.snd_nxt, fslot)
            g_end = gather_hs(tcp.snd_end, fslot)
            g_st = gather_hs(tcp.st, fslot)
            g_cwnd = gather_hs(tcp.cwnd, fslot)
            g_wnd = torch.minimum(g_cwnd * MSS, gather_hs(tcp.snd_wnd, fslot))
            can_data = fl_mask & (
                (g_st == TcpSt.ESTABLISHED) | (g_st == TcpSt.CLOSE_WAIT)
                | (g_st == TcpSt.FIN_WAIT_1) | (g_st == TcpSt.LAST_ACK))
            A = torch.minimum(g_end - g_nxt, g_una + g_wnd - g_nxt).clamp(
                min=0)
            A = torch.where(can_data, A, 0)
            # one flush call packetizes at most FLUSH_SEGMENTS segments;
            # the remainder chains a same-time TCP_FLUSH continuation
            A_now = A.clamp(max=FLUSH_SEGMENTS * MSS)
            n_seg = (A_now + MSS - 1) // MSS
            rest = A - A_now
            fl_mask = fl_mask & ~bad
            n_seg = torch.where(fl_mask, n_seg, 0)
            A_now = torch.where(fl_mask, A_now, 0)
            # the FIN rides once all data is packetized
            fin1 = fl_mask & gather_hs(tcp.fin_pending, fslot) \
                & (g_nxt + A_now == g_end) & (rest == 0)
            nxt_after = g_nxt + A_now + fin1.to(I32)
            tcp = tcp.replace(
                snd_nxt=set_hs(tcp.snd_nxt, fl_mask, fslot, nxt_after),
                snd_max=set_hs(tcp.snd_max, fl_mask, fslot,
                               torch.maximum(gather_hs(tcp.snd_max, fslot),
                                             nxt_after)))
            # the serial chain decision needs ring + sndbuf room at this
            # point of the micro-step (ref: tcp_flush room2); when the
            # unclipped retransmit length decides it, the lane stops
            seg2 = torch.minimum((g_end - nxt_after).clamp(max=MSS),
                                 g_una + g_wnd - nxt_after)
            ob_cnt0 = gather_hs(net.out_count, fslot)
            ob_byt0 = gather_hs(net.out_bytes, fslot)
            sb0 = gather_hs(net.sk_sndbuf, fslot)
            cnt_extra = retx_ack.to(I32) + n_seg + fin1.to(I32)
            room_no_rt = (ob_cnt0 + cnt_extra < BO) \
                & (ob_byt0 + A_now + seg2 <= sb0)
            room_max_rt = (ob_cnt0 + cnt_extra < BO) \
                & (ob_byt0 + A_now + torch.where(retx_ack, MSS, 0)
                   + seg2 <= sb0)
            bad, why = _flag(bad, why, fl_mask & (rest > 0)
                             & (room_no_rt != room_max_rt), 1 << 39)
            chain = fl_mask & (rest > 0) & room_max_rt & ~bad \
                & ~gather_hs(tcp.flush_pending, fslot)

            # the RTO arm's mask (`need` below) only loses lanes to the
            # chain push's flag, and snd_una/snd_nxt/rtx_expire do not
            # change in between: this superset gates it, read together
            # with the chain and the secondary close
            h_una = gather_hs(tcp.snd_una, fslot)
            h_nxt = gather_hs(tcp.snd_nxt, fslot)
            need_hint = fl_mask & ~bad & (h_una < h_nxt) & (
                gather_hs(tcp.rtx_expire, fslot) == simtime.INVALID)
            g_chain, g_need, g_c2 = _read(counters, chain, need_hint,
                                          c2_mask)
            if g_chain:
                tcp = tcp.replace(flush_pending=set_hs(
                    tcp.flush_pending, chain, fslot, True))
                free_c = (q.time == simtime.INVALID).any(dim=1)
                bad, why = _flag(bad, why, chain & ~free_c, 1 << 42)
                ch = chain & ~bad
                q = _push_local(q, ch, t, EventKind.TCP_FLUSH,
                                _slot_words(fslot), lane, seq_ctr)
                seq_ctr = seq_ctr + ch.to(I32)

            # RTO arm after flush (ref: tcp_flush tail + _arm_rtx); the
            # persist condition would arm a probe timer (out of model)
            h_una = gather_hs(tcp.snd_una, fslot)
            h_nxt = gather_hs(tcp.snd_nxt, fslot)
            bad, why = _flag(bad, why, fl_mask & (h_una == h_nxt)
                             & (gather_hs(tcp.snd_end, fslot) > h_nxt)
                             & (gather_hs(tcp.snd_wnd, fslot) == 0),
                             33554432)
            fl_mask = fl_mask & ~bad
            outstanding = fl_mask & (h_una < h_nxt)
            need = outstanding & (
                gather_hs(tcp.rtx_expire, fslot) == simtime.INVALID)

            def _rto_deadline(tcp, at):
                shift = gather_hs(tcp.backoff, at).clamp(
                    max=MAX_BACKOFF).to(I64)
                rto = (gather_hs(tcp.rto_ms, at).to(I64) << shift) \
                    * simtime.ONE_MILLISECOND
                return t + rto.clamp(max=RTO_MAX_MS
                                     * simtime.ONE_MILLISECOND)

            if g_need:
                deadline = _rto_deadline(tcp, fslot)
                tcp = tcp.replace(rtx_expire=set_hs(tcp.rtx_expire, need,
                                                    fslot, deadline))
                in_flight = gather_hs(tcp.rtx_event, fslot)
                earlier = need & in_flight & (
                    deadline < gather_hs(tcp.rtx_fire, fslot))
                need_event = (need & ~in_flight) | earlier
                gen = gather_hs(tcp.rtx_gen, fslot) + 1
                tcp = tcp.replace(
                    rtx_gen=set_hs(tcp.rtx_gen, need_event, fslot, gen),
                    rtx_event=set_hs(tcp.rtx_event, need_event, fslot, True),
                    rtx_fire=set_hs(tcp.rtx_fire, need_event, fslot,
                                    deadline))
                free_b = (q.time == simtime.INVALID).any(dim=1)
                bad, why = _flag(bad, why, need_event & ~free_b, 134217728)
                q = _push_local(q, need_event & ~bad, deadline,
                                EventKind.TCP_RTX_TIMER,
                                _slot_words(fslot, gen), lane,
                                seq_ctr)
                seq_ctr = seq_ctr + (need_event & ~bad).to(I32)

            # ===== secondary close (relay dual-close, tcp_close #2) ===
            # up_conn has no stream data: its flush is the FIN + RTO arm
            g2_nxt = gather_hs(tcp.snd_nxt, c2_slot)
            fin2 = zb
            if g_c2:
                g2_end = gather_hs(tcp.snd_end, c2_slot)
                bad, why = _flag(bad, why, c2_mask & (g2_end != g2_nxt),
                                 1 << 53)
                fin2 = c2_mask & ~bad & gather_hs(tcp.fin_pending, c2_slot)
                tcp = tcp.replace(
                    snd_nxt=set_hs(tcp.snd_nxt, fin2, c2_slot, g2_nxt + 1),
                    snd_max=set_hs(tcp.snd_max, fin2, c2_slot,
                                   torch.maximum(
                                       gather_hs(tcp.snd_max, c2_slot),
                                       g2_nxt + 1)))
                need2 = fin2 & (gather_hs(tcp.rtx_expire, c2_slot)
                                == simtime.INVALID)
                dl2 = _rto_deadline(tcp, c2_slot)
                tcp = tcp.replace(rtx_expire=set_hs(tcp.rtx_expire, need2,
                                                    c2_slot, dl2))
                inflt2 = gather_hs(tcp.rtx_event, c2_slot)
                earl2 = need2 & inflt2 & (
                    dl2 < gather_hs(tcp.rtx_fire, c2_slot))
                nev2 = (need2 & ~inflt2) | earl2
                gen2 = gather_hs(tcp.rtx_gen, c2_slot) + 1
                tcp = tcp.replace(
                    rtx_gen=set_hs(tcp.rtx_gen, nev2, c2_slot, gen2),
                    rtx_event=set_hs(tcp.rtx_event, nev2, c2_slot, True),
                    rtx_fire=set_hs(tcp.rtx_fire, nev2, c2_slot, dl2))
                free_2 = (q.time == simtime.INVALID).any(dim=1)
                bad, why = _flag(bad, why, nev2 & ~free_2, 1 << 55)
                nev2 = nev2 & ~bad
                q = _push_local(q, nev2, dl2, EventKind.TCP_RTX_TIMER,
                                _slot_words(c2_slot, gen2), lane,
                                seq_ctr)
                seq_ctr = seq_ctr + nev2.to(I32)

            # ===== DACK fire ==========================================
            dgen = words[:, 1]
            dslot = torch.where(is_dk, words[:, 0], 0)
            fire = zb
            if any_dk:
                live_dk = is_dk & (dgen == gather_hs(tcp.dack_gen, dslot))
                tcp = tcp.replace(dack_scheduled=set_hs(
                    tcp.dack_scheduled, live_dk, dslot, False))
                fire = live_dk & (gather_hs(tcp.dack_counter, dslot) > 0)
                tcp = tcp.replace(dack_counter=set_hs(
                    tcp.dack_counter, fire, dslot, 0))

            # ===== RTX timer fire (ref: handle_tcp_rtx) ===============
            # stale generations die; a disarmed deadline clears the
            # in-flight flag; a deadline that moved later re-emits the
            # covering event; a due deadline runs the timeout machinery
            # (ref: tcp.py:1349-1401). Only the persist probe stays out
            # of model.
            rslot = torch.where(is_rtx, words[:, 0], 0)
            retx_rto = zb
            if any_rtx:
                rgen = words[:, 1]
                live_rtx = is_rtx & (rgen == gather_hs(tcp.rtx_gen, rslot))
                rdl = gather_hs(tcp.rtx_expire, rslot)
                r_disarm = live_rtx & (rdl == simtime.INVALID)
                r_pending = live_rtx & ~r_disarm & (t < rdl)
                r_due = live_rtx & ~r_disarm & ~r_pending
                tcp = tcp.replace(rtx_event=set_hs(tcp.rtx_event, r_disarm,
                                                   rslot, False))
                r_emit = r_pending & ~bad
                free_x = (q.time == simtime.INVALID).any(dim=1)
                bad, why = _flag(bad, why, r_emit & ~free_x, 1 << 41)
                r_emit = r_emit & ~bad
                q = _push_local(q, r_emit, rdl, EventKind.TCP_RTX_TIMER,
                                _slot_words(rslot, rgen), lane,
                                seq_ctr)
                seq_ctr = seq_ctr + r_emit.to(I32)
                tcp = tcp.replace(rtx_fire=set_hs(tcp.rtx_fire, r_emit,
                                                  rslot, rdl))
                if lossless:
                    # a due deadline is a real RTO: out of model
                    bad, why = _flag(bad, why, r_due, 1 << 34)
                else:
                    r_una = gather_hs(tcp.snd_una, rslot)
                    r_nxt = gather_hs(tcp.snd_nxt, rslot)
                    r_live = r_due & (r_una < r_nxt)
                    r_probe = r_due & (r_una == r_nxt) \
                        & (gather_hs(tcp.snd_end, rslot) > r_nxt) \
                        & (gather_hs(tcp.snd_wnd, rslot) == 0)
                    bad, why = _flag(bad, why, r_probe, 1 << 40)
                    r_live = r_live & ~bad
                    r_cwnd = gather_hs(tcp.cwnd, rslot)
                    tcp = tcp.replace(
                        ssthresh=set_hs(tcp.ssthresh, r_live, rslot,
                                        cong.ssthresh_on_loss(alg, r_cwnd)),
                        cwnd=set_hs(tcp.cwnd, r_live, rslot, RESTART_CWND))
                    wmax_t, ep_t = cong.on_loss_event(
                        alg, r_live, r_cwnd, gather_hs(tcp.cub_wmax, rslot),
                        gather_hs(tcp.cub_epoch_ms, rslot))
                    tcp = tcp.replace(
                        cub_wmax=set_hs(tcp.cub_wmax, r_live, rslot, wmax_t),
                        cub_epoch_ms=set_hs(tcp.cub_epoch_ms, r_live, rslot,
                                            ep_t),
                        ca_acc=set_hs(tcp.ca_acc, r_live, rslot, 0),
                        in_recovery=set_hs(tcp.in_recovery, r_live, rslot,
                                           False),
                        dup_acks=set_hs(tcp.dup_acks, r_live, rslot, 0),
                        backoff=set_hs(tcp.backoff, r_live, rslot,
                                       (gather_hs(tcp.backoff, rslot) + 1)
                                       .clamp(max=MAX_BACKOFF)))
                    tcp = tcp.replace(
                        rtx_event=set_hs(tcp.rtx_event, r_due, rslot, False),
                        rtx_expire=set_hs(tcp.rtx_expire, r_due, rslot,
                                          simtime.INVALID))
                    # re-arm with the bumped backoff; the retransmit
                    # segment itself wires below in serial order
                    rdl_new = _rto_deadline(tcp, rslot)
                    tcp = tcp.replace(rtx_expire=set_hs(
                        tcp.rtx_expire, r_live, rslot, rdl_new))
                    gen_r = gather_hs(tcp.rtx_gen, rslot) + 1
                    tcp = tcp.replace(
                        rtx_gen=set_hs(tcp.rtx_gen, r_live, rslot, gen_r),
                        rtx_event=set_hs(tcp.rtx_event, r_live, rslot, True),
                        rtx_fire=set_hs(tcp.rtx_fire, r_live, rslot,
                                        rdl_new))
                    free_r = (q.time == simtime.INVALID).any(dim=1)
                    bad, why = _flag(bad, why, r_live & ~free_r, 8)
                    r_live = r_live & ~bad
                    q = _push_local(q, r_live, rdl_new,
                                    EventKind.TCP_RTX_TIMER,
                                    _slot_words(rslot, gen_r),
                                    lane, seq_ctr)
                    seq_ctr = seq_ctr + r_live.to(I32)
                    retx_rto = r_live

            # ===== wire: out-ring cycle + stamps + outbox =============
            # Per-lane burst in serial emission order: [retransmit] ->
            # [n_seg flush data (+ FIN tail)] -> [pure ACK], all on one
            # wslot; a relay dual-close adds one secondary FIN on
            # c2_slot, wired last.
            if lossless:
                retx_sent = zb
                rt_len = zi32
                rt_una = zi32
                rt_flags = torch.full((H,), pf.TCPF_ACK, dtype=I32,
                                      device=dev)
            else:
                retx_do = (retx_ack | retx_rto) & ~bad
                rtslot = torch.where(retx_rto, rslot, slot)
                # handshake retransmits are out of model
                rt_st = gather_hs(tcp.st, rtslot)
                bad, why = _flag(bad, why,
                                 retx_do & (rt_st < TcpSt.ESTABLISHED), 512)
                retx_do = retx_do & ~bad
                # regenerate the snd_una segment (ref: _retransmit_one)
                rt_una = gather_hs(tcp.snd_una, rtslot)
                rt_end = gather_hs(tcp.snd_end, rtslot)
                rt_nxt = gather_hs(tcp.snd_nxt, rtslot)
                rt_fin_ever = gather_hs(tcp.fin_pending, rtslot) & (
                    gather_hs(tcp.snd_max, rtslot) == rt_end + 1)
                retx_fin = retx_do & rt_fin_ever & (rt_una == rt_end)
                retx_data = retx_do & ~retx_fin & (rt_una < rt_end)
                rtsc = rtslot.clamp(0, S - 1).to(I64)
                rt_len = sack_clip_len(
                    rt_una, (rt_end - rt_una).clamp(max=MSS),
                    tcp.sack_l[rows, rtsc], tcp.sack_r[rows, rtsc])
                rt_len = torch.where(retx_data, rt_len, 0).to(I32)
                retx_sent = retx_fin | retx_data
                rt_flags = torch.where(retx_fin, pf.TCPF_FIN | pf.TCPF_ACK,
                                       pf.TCPF_ACK).to(I32)
                tcp = tcp.replace(retx_segs=tcp.retx_segs
                                  + retx_sent.to(I64))
                # go-back-N: an RTO rewinds snd_nxt to just past the
                # resent segment
                resent_end = torch.where(retx_data, rt_una + rt_len,
                                         rt_una + 1)
                rewind = retx_rto & retx_sent & (resent_end < rt_nxt)
                tcp = tcp.replace(snd_nxt=set_hs(tcp.snd_nxt, rewind,
                                                 rtslot, resent_end))

            pure_ack = (fire | imm_ack) & ~bad
            wslot = torch.where(fire, dslot,
                                torch.where(retx_rto, rslot,
                                            torch.where(imm_ack, slot,
                                                        fslot)))
            n_pkt = retx_sent.to(I32) + n_seg + fin1.to(I32) \
                + pure_ack.to(I32)
            sending = (retx_sent | pure_ack | (n_seg > 0) | fin1) & ~bad
            fin2 = fin2 & ~bad
            n_pkt = torch.where(sending, n_pkt, 0)

            # refill the send bucket at t (drain-entry refill)
            dq2 = (tq - net.tb_quantum).clamp(min=0)
            refresh2 = (sending | fin2) & (dq2 > 0)
            send_tok = torch.minimum(net.tb_send_refill + pf.MTU,
                                     net.tb_send_tokens
                                     + dq2 * net.tb_send_refill)
            recv_tok2 = torch.minimum(net.tb_recv_refill + pf.MTU,
                                      net.tb_recv_tokens
                                      + dq2 * net.tb_recv_refill)
            net = net.replace(
                tb_send_tokens=torch.where(refresh2, send_tok,
                                           net.tb_send_tokens),
                tb_recv_tokens=torch.where(refresh2, recv_tok2,
                                           net.tb_recv_tokens),
                tb_quantum=torch.where(refresh2, tq, net.tb_quantum))

            # ---- lane mode: fused fast path vs NIC ring path -----
            # The fused path models enqueue + same-instant full drain:
            # valid only when the ring is empty, every burst packet
            # clears the token check and the burst fits one drain.
            # Otherwise the lane takes the ring path (handle_nic_send
            # parity, nic.py:444-490).
            flush_len = []
            for j in range(FLUSH_SEGMENTS + 1):
                pj_ = sending & (j < n_seg + fin1.to(I32))
                is_fin_j_ = fin1 & (j == n_seg)
                flush_len.append((pj_, torch.where(
                    is_fin_j_, 0,
                    (A_now - j * MSS).clamp(0, MSS)).to(I32)))
            afford = torch.ones((H,), dtype=BOOL, device=dev)
            cum_wl = torch.zeros((H,), dtype=I64, device=dev)
            tcp_proto = torch.full((H,), pf.PROTO_TCP, dtype=I32, device=dev)
            for m_k, len_k in ([(retx_sent & sending, rt_len)] + flush_len
                               + [(pure_ack & sending, zi32), (fin2, zi32)]):
                short_k = m_k & (net.tb_send_tokens - cum_wl < pf.MTU)
                afford = afford & ~short_k
                cum_wl = cum_wl + torch.where(
                    m_k, pf.wire_length(tcp_proto, len_k).to(I64), 0)
            backlog0 = net.out_count.sum(dim=1) > 0
            overbound = (n_pkt + fin2.to(I32)) > cfg.nic_drain
            ring_lane = (sending | fin2) & (backlog0 | ~afford | overbound)
            fast = ~ring_lane
            fast_s = sending & fast
            drain_m = is_ns & ~bad

            # stamps shared by every packet of the burst
            stamp_ack = gather_hs(tcp.rcv_nxt, wslot)
            stamp_win = (gather_hs(net.sk_rcvbuf, wslot)
                         - gather_hs(tcp.app_rbytes, wslot)).clamp(min=0)
            stamp_tse = gather_hs(tcp.ts_recent, wslot)
            w_sport = gather_hs(net.sk_bound_port, wslot)
            w_dport = gather_hs(net.sk_peer_port, wslot)
            w_dip = gather_hs(net.sk_peer_ip, wslot)
            w_dsth = gather_hs(peer_h, wslot)
            bad, why = _flag(bad, why, sending & (w_dsth < 0), 268435456)
            # loopback connections route via PACKET_LOCAL in the serial
            # NIC — not modeled here
            bad, why = _flag(bad, why, sending & (w_dsth == lane), 1 << 38)
            sending = sending & ~bad
            fast_s = fast_s & ~bad
            ring_lane = ring_lane & ~bad
            drain_m = drain_m & ~bad
            n_pkt = torch.where(sending, n_pkt, 0)
            w_lat = gather_hs(lat_s, wslot)
            w_rel = gather_hs(rel_s, wslot)
            # the wired ACK cancels any pending delayed ACK on its
            # socket; ring-path packets cancel at their actual drain
            tcp = tcp.replace(dack_counter=set_hs(tcp.dack_counter, fast_s,
                                                  wslot, 0))

            fin2f = fin2 & fast
            burst = torch.where(fast_s, n_seg + fin1.to(I32), 0)
            counters["reads"] += 1
            g_rt, g_pure, g_fin2f, g_ring, g_drain, n_burst = torch.stack([
                (retx_sent & fast_s).any(), (pure_ack & fast_s).any(),
                fin2f.any(), ring_lane.any(), (drain_m | ring_lane).any(),
                burst.amax()]).tolist()

            out = sim.outbox
            M = out.capacity
            drops = zi32
            last_drop = net.last_drop_status
            tx_wl = torch.zeros((H,), dtype=I64, device=dev)
            ring_head0 = gather_hs(net.out_head, wslot)
            rngc = net.rng_ctr
            emitted = zi32
            ob_count = out.count
            ob_over = zb
            rt_n = retx_sent.to(I32)
            u_fast = None
            if not rel_dead and (g_rt or g_pure or g_fin2f or n_burst):
                # the fast path's reliability draws, one per counter it
                # can use: retransmit 0, burst rt_n + j, pure ACK
                # rt_n + n_seg + fin1, secondary FIN n_pkt
                ctrs = torch.stack(
                    [zi32] + [rt_n + j for j in range(FLUSH_SEGMENTS + 1)]
                    + [rt_n + n_seg + fin1.to(I32), n_pkt], dim=1)
                u_fast = rng.uniform_at(net.rng_keys,
                                        (rngc[:, None] + ctrs) & M32)

            def wire_one(state, pj, lenj, seqj, flagsj, stamps, u, extraj=0):
                """Wire one packet per masked lane: token policing,
                enqueue-time words + wire stamps (stamp_at_wire
                parity), the reliability draw `u` at the running
                counter, the outbox append."""
                (out, bad, why, last_drop, drops, tx_wl, emitted,
                 ob_over) = state
                (s_ack, s_win, s_tse, s_sport, s_dport, s_dip, s_dsth,
                 s_lat, s_rel, s_sk) = stamps
                wlj = pf.wire_length(tcp_proto, lenj).to(I64)
                # token policing before each wire (serial `can` check)
                bad, why = _flag(bad, why,
                                 pj & (net.tb_send_tokens - tx_wl < pf.MTU),
                                 536870912)
                pj = pj & ~bad
                wire_w = torch.zeros((H, W), dtype=I32, device=dev)
                wire_w[:, pf.W_PROTO] = pf.PROTO_TCP | (flagsj << 8)
                wire_w[:, pf.W_LEN] = lenj
                wire_w[:, pf.W_PORTS] = pf.pack_ports(s_sport, s_dport)
                wire_w[:, pf.W_SEQ] = seqj
                wire_w[:, pf.W_PAYREF] = pf.PAYREF_NONE
                wire_w[:, pf.W_DSTIP] = u32_to_i32(s_dip & M32)
                wire_w[:, pf.W_ACK] = s_ack
                wire_w[:, pf.W_WIN] = s_win
                wire_w[:, pf.W_TSVAL] = _ms(t)
                wire_w[:, pf.W_TSECHO] = s_tse
                (sk1l, sk1r), (sk2l, sk2r), (sk3l, sk3r) = s_sk
                for col, val in ((pf.W_SACKL, sk1l), (pf.W_SACKR, sk1r),
                                 (pf.W_SACKL2, sk2l), (pf.W_SACKR2, sk2r),
                                 (pf.W_SACKL3, sk3l), (pf.W_SACKR3, sk3r)):
                    wire_w[:, col] = val
                wire_w[:, pf.W_STATUS] = (
                    pf.PDS_SND_CREATED | pf.PDS_SND_TCP_ENQUEUE_THROTTLED
                    | pf.PDS_SND_SOCKET_BUFFERED | pf.PDS_SND_INTERFACE_SENT
                    | extraj)
                if u is None:
                    # the loss trim: no draw, nothing dropped
                    sendj = pj
                else:
                    dropj = pj & (lenj > 0) & (u > s_rel)
                    sendj = pj & ~dropj
                    last_drop = torch.where(
                        dropj, wire_w[:, pf.W_STATUS] | pf.PDS_INET_DROPPED,
                        last_drop)
                    drops = drops + dropj.to(I32)
                wire_sent = wire_w.clone()
                wire_sent[:, pf.W_STATUS] |= pf.PDS_INET_SENT
                tx_wl = tx_wl + torch.where(pj, wlj, 0)
                col = ob_count + emitted
                okb = sendj & (col < M)
                ob_over = ob_over | (sendj & ~(col < M))
                colc = col.clamp(0, M - 1).to(I64)
                out = _outbox_put(out, rows, colc, okb, s_dsth, t + s_lat,
                                  lane, seq_ctr + emitted, wire_sent)
                emitted = emitted + sendj.to(I32)
                return (out, bad, why, last_drop, drops, tx_wl, emitted,
                        ob_over)

            stamps1 = (stamp_ack, stamp_win, stamp_tse, w_sport, w_dport,
                       w_dip, w_dsth, w_lat, w_rel, _sack_stamps(tcp, wslot))
            state = (out, bad, why, last_drop, drops, tx_wl, emitted,
                     ob_over)
            retx_status = torch.where(
                retx_sent,
                pf.PDS_SND_TCP_ENQUEUE_RETRANSMIT
                | pf.PDS_SND_TCP_DEQUEUE_RETRANSMIT
                | pf.PDS_SND_TCP_RETRANSMITTED, 0).to(I32)
            # 1) the retransmitted snd_una segment (serial order:
            #    _retransmit_one precedes the flush)
            if g_rt:
                state = wire_one(state, retx_sent & fast_s, rt_len, rt_una,
                                 rt_flags, stamps1, _col(u_fast, 0),
                                 retx_status)
            # 2) the flush burst: n_seg data segments + the FIN tail
            #    (packets past the longest burst are wired by no lane)
            for j in range(min(int(n_burst), FLUSH_SEGMENTS + 1)):
                pj = fast_s & (j < n_seg + fin1.to(I32))
                is_fin_j = fin1 & (j == n_seg)
                lenj = torch.where(is_fin_j, 0,
                                   (A_now - j * MSS).clamp(0, MSS)).to(I32)
                seqj = torch.where(is_fin_j, g_nxt + A_now, g_nxt + j * MSS)
                flagsj = torch.where(is_fin_j, pf.TCPF_FIN | pf.TCPF_ACK,
                                     pf.TCPF_ACK).to(I32)
                state = wire_one(state, pj, lenj, seqj, flagsj, stamps1,
                                 _col(u_fast, 1 + j))
            # 3) the pure ACK: a fired delayed ACK, or the immediate
            #    loss-signalling ACK
            if g_pure:
                state = wire_one(state, pure_ack & fast_s, zi32,
                                 gather_hs(tcp.snd_nxt, wslot),
                                 torch.full((H,), pf.TCPF_ACK, dtype=I32,
                                            device=dev),
                                 stamps1, _col(u_fast, FLUSH_SEGMENTS + 2))
            # secondary FIN (dual close) after the whole primary burst —
            # fast lanes only; ring lanes enqueue it below
            if g_fin2f:
                stamps2 = (gather_hs(tcp.rcv_nxt, c2_slot),
                           (gather_hs(net.sk_rcvbuf, c2_slot)
                            - gather_hs(tcp.app_rbytes, c2_slot)).clamp(
                                min=0),
                           gather_hs(tcp.ts_recent, c2_slot),
                           gather_hs(net.sk_bound_port, c2_slot),
                           gather_hs(net.sk_peer_port, c2_slot),
                           gather_hs(net.sk_peer_ip, c2_slot),
                           gather_hs(peer_h, c2_slot),
                           gather_hs(lat_s, c2_slot),
                           gather_hs(rel_s, c2_slot),
                           _sack_stamps(tcp, c2_slot))
                (out, bad, why, last_drop, drops, tx_wl, emitted,
                 ob_over) = state
                bad, why = _flag(bad, why,
                                 fin2f & (gather_hs(peer_h, c2_slot) < 0),
                                 1 << 62)
                fin2f = fin2f & ~bad
                state = (out, bad, why, last_drop, drops, tx_wl, emitted,
                         ob_over)
                state = wire_one(state, fin2f, zi32, g2_nxt,
                                 torch.full((H,), pf.TCPF_FIN | pf.TCPF_ACK,
                                            dtype=I32, device=dev),
                                 stamps2, _col(u_fast, FLUSH_SEGMENTS + 3))
                bad = state[1]
                fin2f = fin2f & ~bad
                tcp = tcp.replace(dack_counter=set_hs(
                    tcp.dack_counter, fin2f, c2_slot, 0))
            (out, bad, why, last_drop, drops, tx_wl, emitted,
             ob_over) = state

            # ===== NIC ring path: enqueue + token drain ===============
            # Ring-mode lanes put the burst on the real socket output
            # ring (sk_enqueue_out parity) and then drain through the
            # token bucket like handle_nic_send (nic.py:444-604).
            enq = zi32
            if g_ring:
                c2_sport = gather_hs(net.sk_bound_port, c2_slot)
                c2_dport = gather_hs(net.sk_peer_port, c2_slot)
                c2_dip = gather_hs(net.sk_peer_ip, c2_slot)
                c2_dsth = gather_hs(peer_h, c2_slot)
                fin2r = fin2 & ring_lane
                bad, why = _flag(bad, why, fin2r & (c2_dsth < 0), 1 << 62)
                bad, why = _flag(bad, why, fin2r & (c2_dsth == lane), 1 << 38)
                ack_f = torch.full((H,), pf.TCPF_ACK, dtype=I32, device=dev)
                fin_f = torch.full((H,), pf.TCPF_FIN | pf.TCPF_ACK,
                                   dtype=I32, device=dev)
                comps = [(retx_sent & ring_lane, rt_len, rt_una, rt_flags,
                          wslot, w_sport, w_dport, w_dip, retx_status)]
                for j, (pj_, len_j) in enumerate(flush_len):
                    is_fin_j = fin1 & (j == n_seg)
                    comps.append((pj_ & ring_lane, len_j,
                                  torch.where(is_fin_j, g_nxt + A_now,
                                              g_nxt + j * MSS),
                                  torch.where(is_fin_j, fin_f, ack_f),
                                  wslot, w_sport, w_dport, w_dip, 0))
                comps.append((pure_ack & ring_lane, zi32,
                              gather_hs(tcp.snd_nxt, wslot), ack_f,
                              wslot, w_sport, w_dport, w_dip, 0))
                comps.append((fin2 & ring_lane, zi32, g2_nxt, fin_f,
                              c2_slot, c2_sport, c2_dport, c2_dip, 0))
                for (m_k, len_k, seq_k, flags_k, slot_k, sport_k, dport_k,
                     dip_k, extra_k) in comps:
                    ek = m_k & ~bad
                    # sk_enqueue_out admission; a failed serial enqueue
                    # stalls the segment — out of model
                    sp_ok = (gather_hs(net.out_bytes, slot_k) + len_k
                             <= gather_hs(net.sk_sndbuf, slot_k))
                    bad, why = _flag(bad, why, ek & ~sp_ok, 1 << 36)
                    ek = ek & ~bad
                    okp, pos = ring_push_at(net.out_head, net.out_count, BO,
                                            ek, slot_k)
                    bad, why = _flag(bad, why, ek & ~okp, 1 << 37)
                    ek = ek & okp & ~bad
                    rw_ = torch.zeros((H, W), dtype=I32, device=dev)
                    rw_[:, pf.W_PROTO] = pf.PROTO_TCP | (flags_k << 8)
                    rw_[:, pf.W_LEN] = len_k
                    rw_[:, pf.W_PORTS] = pf.pack_ports(sport_k, dport_k)
                    rw_[:, pf.W_SEQ] = seq_k
                    rw_[:, pf.W_PAYREF] = pf.PAYREF_NONE
                    rw_[:, pf.W_DSTIP] = u32_to_i32(dip_k & M32)
                    rw_[:, pf.W_STATUS] = (pf.PDS_SND_CREATED
                                           | pf.PDS_SND_TCP_ENQUEUE_THROTTLED
                                           | pf.PDS_SND_SOCKET_BUFFERED
                                           | extra_k)
                    net = net.replace(
                        out_words=set_ring(net.out_words, ek, slot_k, pos,
                                           rw_),
                        out_priority=set_ring(net.out_priority, ek, slot_k,
                                              pos, net.priority_ctr
                                              + enq.to(I64)),
                        out_count=set_hs(net.out_count, ek, slot_k,
                                         gather_hs(net.out_count, slot_k)
                                         + 1),
                        out_bytes=set_hs(net.out_bytes, ek, slot_k,
                                         gather_hs(net.out_bytes, slot_k)
                                         + len_k),
                    )
                    enq = enq + ek.to(I32)

            drain_m2 = (drain_m | (ring_lane & (enq > 0))) & ~bad
            # a popped NIC_SEND clears its pending flag at entry
            net = net.replace(nic_send_pending=net.nic_send_pending & ~is_ns)
            d_active = zi32
            d_data = torch.zeros((H,), dtype=I64, device=dev)
            d_retxb = d_data
            d_nosock = zi32
            drawn = zi32
            if g_drain:
                big64 = torch.iinfo(net.out_priority.dtype).max
                # the drain's draws sit at rngc + drawn, drawn < pass
                if not rel_dead:
                    dctr = torch.arange(cfg.nic_drain, dtype=I64,
                                        device=dev)
                    u_drain = rng.uniform_at(net.rng_keys,
                                             (rngc[:, None] + dctr) & M32)
                for k in range(cfg.nic_drain):
                    can = (net.tb_send_tokens - tx_wl) >= pf.MTU
                    nonempty = net.out_count > 0
                    hp_all = (net.out_head % BO).to(I64)
                    head_pri = torch.gather(net.out_priority, 2,
                                            hp_all[..., None])[..., 0]
                    key = torch.where(nonempty, head_pri, big64)
                    sel = key.argmin(dim=1)
                    found = nonempty.any(dim=1)
                    active = drain_m2 & can & found & ~bad
                    if k > 0:
                        # an idle pass leaves every later pass idle too
                        counters["reads"] += 1
                        if not bool(active.any()):
                            break
                    hp = (net.out_head[rows, sel] % BO).to(I64)
                    wds = net.out_words[rows, sel, hp]
                    lenk = wds[:, pf.W_LEN]
                    net = net.replace(
                        out_head=set_hs(net.out_head, active, sel,
                                        (net.out_head[rows, sel] + 1) % BO),
                        out_count=set_hs(net.out_count, active, sel,
                                         net.out_count[rows, sel] - 1),
                        out_bytes=set_hs(net.out_bytes, active, sel,
                                         net.out_bytes[rows, sel] - lenk),
                    )
                    # the serial wire-time stampers (stamp_at_wire
                    # parity); the departing ACK cancels the delayed ACK
                    wds = stamp_at_wire(net, tcp, active, sel, wds, t)
                    wds[:, pf.W_STATUS] = torch.where(
                        active,
                        wds[:, pf.W_STATUS] | pf.PDS_SND_INTERFACE_SENT,
                        wds[:, pf.W_STATUS])
                    tcp = wire_ack_departed(tcp, active, sel)
                    wlk = pf.wire_length(pf.proto_of(wds), lenk).to(I64)
                    dipk = ip_from_word(wds[:, pf.W_DSTIP])
                    dsth = host_of_ip(net, dipk)
                    bad, why = _flag(bad, why, active & (dsth == lane),
                                     1 << 38)
                    active = active & ~bad
                    known = active & (dsth >= 0)
                    d_nosock = d_nosock + (active & ~known).to(I32)
                    if rel_dead:
                        sendk = known
                    else:
                        u = torch.gather(u_drain, 1,
                                         drawn.to(I64)[:, None])[:, 0]
                    drawn = drawn + active.to(I32)
                    vdst_k = net.vertex_of_host[
                        dsth.clamp(0, GH - 1).to(I64)].to(I64)
                    latk = net.latency_ns[vsrc_h, vdst_k]
                    if not rel_dead:
                        relk = net.reliability[vsrc_h, vdst_k]
                        dropk = known & (lenk > 0) & (u > relk)
                        sendk = known & ~dropk
                        last_drop = torch.where(
                            dropk,
                            wds[:, pf.W_STATUS] | pf.PDS_INET_DROPPED,
                            last_drop)
                        drops = drops + dropk.to(I32)
                    wire_sent = wds.clone()
                    wire_sent[:, pf.W_STATUS] |= pf.PDS_INET_SENT
                    tx_wl = tx_wl + torch.where(active, wlk, 0)
                    col = ob_count + emitted
                    okb = sendk & (col < M)
                    ob_over = ob_over | (sendk & ~(col < M))
                    colc = col.clamp(0, M - 1).to(I64)
                    out = _outbox_put(out, rows, colc, okb, dsth, t + latk,
                                      lane, seq_ctr + emitted, wire_sent)
                    emitted = emitted + sendk.to(I32)
                    is_rexk = (wds[:, pf.W_STATUS]
                               & pf.PDS_SND_TCP_RETRANSMITTED) != 0
                    d_active = d_active + active.to(I32)
                    d_data = d_data + torch.where(active, lenk, 0).to(I64)
                    d_retxb = d_retxb + torch.where(active & is_rexk, wlk, 0)

            bad, why = _flag(bad, why, ob_over, 1073741824)
            fast_w = (fast_s | fin2f) & ~bad
            ring_w_lanes = (ring_lane | drain_m2) & ~bad
            wired_any = fast_w | ring_w_lanes
            out = out.replace(count=torch.where(wired_any,
                                                ob_count + emitted,
                                                out.count))
            seq_ctr = seq_ctr + torch.where(wired_any, emitted, 0)
            n_tot_f = torch.where(fast_w, n_pkt + fin2f.to(I32), 0)
            net = net.replace(
                out_head=set_hs(net.out_head, fast_s & ~bad, wslot,
                                (ring_head0 + n_pkt) % BO),
                priority_ctr=net.priority_ctr + n_tot_f.to(I64)
                + torch.where(ring_lane & ~bad, enq, 0).to(I64),
                rng_ctr=(rngc + torch.where(fast_w, n_tot_f, 0).to(I64)
                         + torch.where(ring_w_lanes, drawn, 0).to(I64))
                & M32,
                tb_send_tokens=(net.tb_send_tokens
                                - torch.where(wired_any, tx_wl, 0)).clamp(
                                    min=0),
                ctr_tx_packets=net.ctr_tx_packets + n_tot_f.to(I64)
                + torch.where(ring_w_lanes, d_active, 0).to(I64),
                ctr_tx_bytes=net.ctr_tx_bytes
                + torch.where(wired_any, tx_wl, 0),
                ctr_tx_data_bytes=net.ctr_tx_data_bytes
                + torch.where(fast_s & ~bad, A_now + rt_len, 0).to(I64)
                + torch.where(ring_w_lanes, d_data, 0),
                ctr_tx_retx_bytes=net.ctr_tx_retx_bytes
                + torch.where(fast_w & retx_sent,
                              pf.wire_length(tcp_proto, rt_len).to(I64), 0)
                + torch.where(ring_w_lanes, d_retxb, 0),
                ctr_drop_nosocket=net.ctr_drop_nosocket
                + torch.where(ring_w_lanes, d_nosock, 0).to(I64),
                ctr_drop_reliability=net.ctr_drop_reliability
                + drops.to(I64),
                last_drop_status=last_drop,
                ctr_events_exec=net.ctr_events_exec + v.to(I64),
            )
            net = net.replace(out_head=set_hs(
                net.out_head, fin2f & ~bad, c2_slot,
                (gather_hs(net.out_head, c2_slot) + 1) % BO))

            # chain / wait continuation (handle_nic_send tail), emitted
            # after the drained packets
            if g_drain:
                more = (net.out_count > 0).any(dim=1)
                can_next = net.tb_send_tokens >= pf.MTU
                base = drain_m2 & ~bad & ~net.nic_send_pending
                ch_now = base & more & can_next
                ch_wait = base & more & ~can_next
                free_n = (q.time == simtime.INVALID).any(dim=1)
                bad, why = _flag(bad, why, (ch_now | ch_wait) & ~free_n,
                                 1 << 35)
                ch_now = ch_now & ~bad
                ch_wait = ch_wait & ~bad
                zw = torch.zeros((H, W), dtype=I32, device=dev)
                q = _push_local(q, ch_now, t, EventKind.NIC_SEND, zw, lane,
                                seq_ctr)
                seq_ctr = seq_ctr + ch_now.to(I32)
                q = _push_local(q, ch_wait, next_refill_time(t),
                                EventKind.NIC_SEND, zw, lane, seq_ctr)
                seq_ctr = seq_ctr + ch_wait.to(I32)
                net = net.replace(nic_send_pending=net.nic_send_pending
                                  | ch_now | ch_wait)

            sim = sim.replace(events=q, outbox=out, net=net, tcp=tcp,
                              app=app)

            # ---- prefix-commit revert -----------------------------
            # lanes that hit an out-of-model boundary this iteration roll
            # the leaves it wrote back to the iteration-start snapshot:
            # the offending event stays queued for the serial fixpoint
            stopped_now = bad & ~bad_prev
            if _read(counters, stopped_now)[0]:
                sim = _select_written(sim_prev, sim, stopped_now, H)
                seq_ctr = _select_written(seq_prev, seq_ctr, stopped_now, H)

        counters["iterations"] += it
        sim_c = sim
        # prefix commit: every eligible lane merges its candidate state;
        # the debug `commit` mask reports lanes whose whole window stayed
        # in model (leftovers = guard trip, counted bad)
        bad, why = _flag(bad, why,
                         (sim_c.events.time < wend64).any(dim=1), 2147483648)
        commit = elig
        q_m = _merge(sim_start.events, sim_c.events, commit, H)
        q_m = q_m.replace(next_seq=torch.where(commit, seq_ctr,
                                               sim_start.events.next_seq))
        n = torch.where(commit, sim_c.net.ctr_events_exec
                        - sim_start.net.ctr_events_exec, 0).sum(dtype=I64)
        sim = sim_start.replace(
            events=q_m,
            outbox=_merge(sim_start.outbox, sim_c.outbox, commit, H),
            net=_merge(sim_start.net, sim_c.net, commit, H),
            tcp=_merge(sim_start.tcp, sim_c.tcp, commit, H),
            app=_merge(sim_start.app, sim_c.app, commit, H))
        if debug:
            return sim, n, {"elig": elig, "bad": bad, "why": why,
                            "commit": elig & ~bad, "iters": it}
        return sim, n

    bulk_fn.counters = counters
    return bulk_fn
