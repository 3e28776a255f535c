"""PHOLD — the classic PDES stress benchmark (PyTorch port of
shadow_tpu/apps/phold.py; ref: src/test/phold/test_phold.c:36-52).

Every host seeds `load` UDP messages; each received message triggers
one send to a peer drawn uniformly over the other hosts of its replica
from the host's threefry counter stream, so `H * load` messages
circulate forever and the event rate measures raw scheduler
throughput. PholdBulk (BULK) opts the app into the bulk window pass
(net/bulk.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from shadow_tpu_torch.core import rng
from shadow_tpu_torch.core.events import (
    EventKind, _Replace, census_mask, emit, emit_words)
from shadow_tpu_torch.net import nic, udp
from shadow_tpu_torch.net.rings import gather_hs
from shadow_tpu_torch.net.sockets import sk_bind, sk_create
from shadow_tpu_torch.net.state import NetConfig, SocketType, ip_of_hosts

I32 = torch.int32
I64 = torch.int64

KIND_INJECT = EventKind.USER + 0   # self-chained initial-load injector
MSG_SIZE = 64


@dataclass
class PholdApp(_Replace):
    sock: torch.Tensor       # [H] i64 socket slot
    port: torch.Tensor       # [H] i32
    remaining: torch.Tensor  # [H] i32 initial-load messages still to inject
    sent: torch.Tensor       # [H] i64
    rcvd: torch.Tensor       # [H] i64
    # peers draw from [peer_base, peer_base + peer_span): R independent
    # replicas of a config in one run, no cross-replica traffic
    peer_base: torch.Tensor  # [H] i32
    peer_span: torch.Tensor  # [H] i32


def _replica_peer(app, net, u):
    """Uniform peer within the lane's replica, excluding self. The
    product stays float32 and is truncated toward zero, as in the
    reference (one ulp changes the peer)."""
    span, local, base = (app.peer_span, net.lane_id - app.peer_base,
                         app.peer_base)
    if u.ndim == 2:
        span, local, base = span[:, None], local[:, None], base[:, None]
    p = torch.minimum((u * (span - 1)).to(I32), span - 2)
    p = torch.where(p >= local, p + 1, p)      # skip self, stay in-span
    return base + p


def setup(sim, *, load: int, port: int = 9000,
          replica_size: int | None = None,
          active_hosts: int | None = None):
    """All hosts run PHOLD: bind a UDP socket, seed `load` messages.
    `replica_size` partitions the hosts into independent replicas;
    `active_hosts` makes only the first N hosts of each replica inject
    load and draw peers."""
    H = sim.net.host_ip.shape[0]
    dev = sim.net.host_ip.device
    if H < 2:
        raise ValueError("PHOLD needs at least 2 hosts")
    rs = H if replica_size is None else replica_size
    if rs < 2 or H % rs != 0:
        raise ValueError(f"replica_size={rs} must divide H={H}, be >= 2")
    active = rs if active_hosts is None else active_hosts
    if active < 2 or active > rs:
        raise ValueError(
            f"active_hosts={active} must be in [2, replica_size={rs}]")
    every = torch.ones((H,), dtype=torch.bool, device=dev)
    net, sock = sk_create(sim.net, every, SocketType.UDP)
    net, _ = sk_bind(net, every, sock, 0, port)
    lane = torch.arange(H, dtype=I32, device=dev)
    app = PholdApp(
        sock=sock,
        peer_base=(lane // rs) * rs,
        peer_span=torch.full((H,), active, dtype=I32, device=dev),
        port=torch.full((H,), port, dtype=I32, device=dev),
        remaining=torch.where(lane % rs < active, load, 0).to(I32),
        sent=torch.zeros((H,), dtype=I64, device=dev),
        rcvd=torch.zeros((H,), dtype=I64, device=dev),
    )
    return sim.replace(net=net, app=app)


def _send_one(cfg, sim, buf, mask, now):
    """Send one message per masked lane to a uniformly random peer
    (excluding self), drawn from the host's PRNG stream."""
    app = sim.app
    net = sim.net
    u, ctr = rng.uniform(net.rng_keys, net.rng_ctr)
    net = net.replace(rng_ctr=torch.where(mask, ctr, net.rng_ctr))
    peer = _replica_peer(app, net, u)
    dst_ip = ip_of_hosts(cfg, net, peer)
    net, ok = udp.udp_enqueue_send(net, mask, app.sock, dst_ip, app.port,
                                   MSG_SIZE, -1)
    app = app.replace(sent=app.sent + ok.to(I64))
    sim = sim.replace(net=net, app=app)
    return nic.notify_wants_send(sim, buf, ok, now)


class PholdBulk:
    """Bulk window pass hooks (net.bulk.AppBulk contract): consume
    every delivered message, reply to one uniformly random peer per
    message, reproducing the serial handler's draw stream exactly —
    per consumed event j (in time order): draw 2j is the peer choice
    (_send_one), draw 2j+1 the NIC reliability Bernoulli
    (handle_nic_send, same micro-step). Counters wrap mod 2**32 as the
    reference's uint32 adds do."""

    max_send_len = MSG_SIZE
    resolves_dst = True   # peers are picked by index; dst_host always set

    def precheck(self, cfg, sim):
        # injection still running is excluded by the engine's kind
        # eligibility; this guards the app-state side of it
        return sim.app.remaining == 0

    def run(self, cfg, sim, d):
        from shadow_tpu_torch.net import bulk as bulkmod

        app = sim.app
        net = sim.net
        H, K = d.mask.shape

        rc = bulkmod.rank_in_order(d.order, d.mask)    # consumed rank
        app_ctr = (net.rng_ctr[:, None] + 2 * rc.to(I64)) & rng.M32
        u = rng.uniform_at(net.rng_keys, app_ctr)
        peer = _replica_peer(app, net, u)
        dst_ip = ip_of_hosts(cfg, net, peer)

        m = d.mask.sum(dim=1, dtype=I64)
        sim = sim.replace(
            net=net.replace(rng_ctr=(net.rng_ctr + 2 * m) & rng.M32),
            app=app.replace(rcvd=app.rcvd + m, sent=app.sent + m),
        )
        sends = bulkmod.BulkSends(
            mask=d.mask,
            slot=app.sock[:, None].expand(H, K),
            dst_ip=dst_ip,
            dst_host=peer,
            dst_port=app.port[:, None].expand(H, K),
            length=torch.full((H, K), MSG_SIZE, dtype=I32,
                              device=d.mask.device),
            payref=torch.full((H, K), -1, dtype=I32, device=d.mask.device),
            nic_draw_ctr=(app_ctr + 1) & rng.M32,
        )
        return sim, sends


BULK = PholdBulk()


_INJECT_KINDS = census_mask((EventKind.PROC_START, KIND_INJECT))
_RECV_KINDS = census_mask((EventKind.PACKET, EventKind.NIC_RECV,
                           EventKind.PACKET_LOCAL))


def handler(cfg: NetConfig, sim, popped, buf, kinds=None):
    """`kinds` (the engine's bitmask of the kinds popped this
    micro-step; None = unknown) skips a half whose kinds are absent —
    its masks would be all false, so it would change nothing."""
    app = sim.app
    now = popped.time
    H = app.sock.shape[0]

    # initial load: one message per micro-step, chained by a same-time
    # self event until `load` have been injected
    if kinds is None or kinds & _INJECT_KINDS:
        inject = popped.valid & (
            (popped.kind == EventKind.PROC_START)
            | (popped.kind == KIND_INJECT)) & (app.remaining > 0)
        sim, buf = _send_one(cfg, sim, buf, inject, now)
        app = sim.app.replace(remaining=sim.app.remaining - inject.to(I32))
        sim = sim.replace(app=app)
        more = inject & (app.remaining > 0)
        buf = emit(buf, more, sim.net.lane_id, now, KIND_INJECT,
                   emit_words(0, num_hosts=H, device=now.device))

    if not (kinds is None or kinds & _RECV_KINDS):
        return sim, buf
    # every received message triggers one send to a new random peer
    app = sim.app
    may_have = popped.valid & (
        (popped.kind == EventKind.PACKET)
        | (popped.kind == EventKind.NIC_RECV)
        | (popped.kind == EventKind.PACKET_LOCAL))
    readable = gather_hs(sim.net.in_count, app.sock) > 0
    net, got, _, _, _, _ = udp.udp_recv(sim.net, may_have & readable, app.sock)
    sim = sim.replace(net=net,
                      app=sim.app.replace(rcvd=sim.app.rcvd + got.to(I64)))
    return _send_one(cfg, sim, buf, got, now)


# Complete set of event kinds this handler can emit (its UDP sends go
# through the netstack's own NIC_SEND/PACKET machinery, which is always
# live). The capability analysis (compile/specialize.py) reads this
# declaration to prove the timer handler family dead: PHOLD never arms
# a host timer, so TIMER events cannot exist and the family is left out.
handler.specialize_kinds = frozenset({int(KIND_INJECT)})
