"""tgen-style open-system traffic workload (PyTorch port of
shadow_tpu/apps/tgen.py; ref: the tgen traffic generator shadow ships
for tor experiments — declarative stream / pause / markov phase models
driving real sockets).

`compile_trace` turns `<traffic>` elements (config/xmlconfig.py
TrafficSpec) into an INJECTION TRACE — sorted records the host feeder
(inject/feeder.py) streams into the device staging buffer. Each
injected event fires `handler` on its host, which sends one UDP
datagram of the phase's size to the spec's dst. The arrivals are
open-system: the schedule comes from outside the simulation, not from
the closed-loop event population. The compiler is host code, a copy of
the reference's; the handler is the device part.

Determinism: a markov phase samples its on/off chain from
`random.Random(seed)` at COMPILE time — the sampled trace is part of
the run's input, so dispatch chunking cannot perturb it.

The reference's `tgen_main` (the dual-mode virtual-process twin) waits
for the virtual processes (ROADMAP.md Queue 1 item 10b).
"""

from __future__ import annotations

import random
from dataclasses import dataclass

import torch

from shadow_tpu_torch.core.events import EventKind, _Replace, census_mask
from shadow_tpu_torch.net import nic, udp
from shadow_tpu_torch.net.rings import gather_hs
from shadow_tpu_torch.net.sockets import sk_bind, sk_create
from shadow_tpu_torch.net.state import NetConfig, SocketType, ip_of_hosts

I64 = torch.int64

# USER+0 is phold's injector, +1/+2 gossip's — tgen claims a slot far
# from the accreted low offsets
KIND_TGEN = EventKind.USER + 8

# injected-event payload word layout (inject/trace.py `payload`)
W_DST, W_PORT, W_SIZE = 0, 1, 2


# --------------------------------------------------------- compiler

def phase_times(phases, start_ns: int = 0):
    """Walk a phase list, yielding (t_ns, size) per send slot in time
    order: the one schedule authority compile_trace maps to injected
    device events."""
    t = int(start_ns)
    for ph in phases:
        if ph.kind == "stream":
            period = max(1, int(round(1e9 / ph.rate)))
            if ph.count is not None:
                n = int(ph.count)
            elif ph.duration_ns is not None:
                n = max(0, int(ph.duration_ns) // period)
            else:
                raise ValueError(
                    "stream phase needs count or duration")
            for _ in range(n):
                yield t, ph.size
                t += period
        elif ph.kind == "pause":
            t += int(ph.duration_ns)
        elif ph.kind == "markov":
            period = max(1, int(round(1e9 / ph.rate)))
            n = max(0, int(ph.duration_ns) // period)
            rnd = random.Random(ph.seed)
            on = True
            for _ in range(n):
                if on:
                    yield t, ph.size
                    if rnd.random() < ph.p_off:
                        on = False
                elif rnd.random() < ph.p_on:
                    on = True
                t += period
        else:
            raise ValueError(f"unknown traffic phase kind {ph.kind!r}")


def compile_trace(traffics, name_to_index: dict, *,
                  end_time: int | None = None) -> list:
    """TrafficSpecs -> injection-trace records (inject/trace.py
    shape), merged over specs and sorted by t_ns. Ties keep config
    order (stable sort), so the trace — and therefore every injected
    seq — is a pure function of the config."""
    events = []
    for spec in traffics:
        for name in (spec.host, spec.dst or spec.host):
            if name not in name_to_index:
                raise ValueError(
                    f"<traffic {spec.id!r}> references unknown host "
                    f"{name!r}")
        src = name_to_index[spec.host]
        dst = name_to_index[spec.dst or spec.host]
        for t, size in phase_times(spec.phases, spec.start_ns):
            if end_time is not None and t >= end_time:
                break
            events.append({"t_ns": int(t), "host": int(src),
                           "kind": int(KIND_TGEN),
                           "payload": [int(dst), int(spec.port),
                                       int(size)]})
    events.sort(key=lambda e: e["t_ns"])
    return events


def lanes_for(n_events: int) -> int:
    """Default staging width for a compiled trace: enough lanes to
    stage the whole thing when small (whole-run paths need fill_all),
    capped so a long trace streams instead of ballooning the planes."""
    if n_events <= 0:
        return 16
    return min(1024, max(16, 1 << (n_events - 1).bit_length()))


# ------------------------------------------------------ device app

@dataclass
class TgenApp(_Replace):
    sock: torch.Tensor        # [H] i64 socket slot
    sent: torch.Tensor        # [H] i64 datagrams queued
    bytes_sent: torch.Tensor  # [H] i64
    rcvd: torch.Tensor        # [H] i64 datagrams drained
    refused: torch.Tensor     # [H] i64 sends refused by a full sndbuf


def setup(sim, *, port: int = 9100):
    """Every host binds one UDP socket: sources send from it when an
    injected KIND_TGEN event fires, sinks drain arrivals into rcvd."""
    H = sim.net.host_ip.shape[0]
    dev = sim.net.host_ip.device
    every = torch.ones((H,), dtype=torch.bool, device=dev)
    net, sock = sk_create(sim.net, every, SocketType.UDP)
    net, _ = sk_bind(net, every, sock, 0, port)

    def z():
        return torch.zeros((H,), dtype=I64, device=dev)
    app = TgenApp(sock=sock, sent=z(), bytes_sent=z(), rcvd=z(),
                  refused=z())
    return sim.replace(net=net, app=app)


_SEND_KINDS = census_mask((KIND_TGEN,))
_RECV_KINDS = census_mask((EventKind.PACKET, EventKind.NIC_RECV,
                           EventKind.PACKET_LOCAL))


def handler(cfg: NetConfig, sim, popped, buf, kinds=None):
    """`kinds` (the engine's bitmask of the kinds popped this
    micro-step; None = unknown) skips a half whose kinds are absent —
    its masks would be all false, so it would change nothing."""
    now = popped.time

    # an injected slot: one datagram to the compiled dst
    if kinds is None or kinds & _SEND_KINDS:
        app = sim.app
        fire = popped.valid & (popped.kind == KIND_TGEN)
        size = popped.words[:, W_SIZE]
        dst_ip = ip_of_hosts(cfg, sim.net, popped.words[:, W_DST])
        net, ok = udp.udp_enqueue_send(
            sim.net, fire, app.sock, dst_ip, popped.words[:, W_PORT],
            size, -1)
        app = app.replace(
            sent=app.sent + ok.to(I64),
            bytes_sent=app.bytes_sent + torch.where(ok, size, 0).to(I64),
            refused=app.refused + (fire & ~ok).to(I64))
        sim = sim.replace(net=net, app=app)
        sim, buf = nic.notify_wants_send(sim, buf, ok, now)

    # the sink side is pure drain — open-system arrivals terminate
    # here instead of cascading (contrast phold's reply-forever loop)
    if not (kinds is None or kinds & _RECV_KINDS):
        return sim, buf
    may_have = popped.valid & (
        (popped.kind == EventKind.PACKET)
        | (popped.kind == EventKind.NIC_RECV)
        | (popped.kind == EventKind.PACKET_LOCAL))
    readable = gather_hs(sim.net.in_count, sim.app.sock) > 0
    net, got, _, _, _, _ = udp.udp_recv(
        sim.net, may_have & readable, sim.app.sock)
    return sim.replace(
        net=net,
        app=sim.app.replace(rcvd=sim.app.rcvd + got.to(I64))), buf
