"""Composes the per-micro-step handler pipeline for the engine
(PyTorch port of shadow_tpu/net/step.py).

Every handler sees all H popped events and acts only on lanes whose
kind matches; each is a masked batch update, so an all-false mask is
the identity. Receive side first, then app handlers, then the send
drain LAST so packets enqueued in this micro-step hit the wire without
a same-time event round-trip.

Gates: the reference wraps each handler family in lax.cond. Here the
engine reads the popped kinds once per micro-step (one host sync that
also decides whether the micro-step runs at all) and passes them as
the ``kinds`` bitmask; the receive, timer and TCP timer families are
skipped with a plain ``if`` when their kinds are absent. The receive
family holds the TCP receive machine (nic.deliver_packet ->
tcp.tcp_packet_in), the largest handler, so timer-only micro-steps do
not pay for it. The app handlers and the send drain run whenever the
micro-step runs — value-identical, because a handler whose mask is all
false changes nothing.
"""

from __future__ import annotations

import inspect
from typing import Callable, Sequence

import torch

from shadow_tpu_torch.compile.specialize import timers_trimmed
from shadow_tpu_torch.core.events import EventKind, census_mask, push_rows
from shadow_tpu_torch.net import nic, tcp, timers
from shadow_tpu_torch.net.state import NetConfig

AppHandler = Callable  # (cfg, sim, popped, buf) -> (sim, buf)

_PRE_APP = (
    (nic.handle_nic_recv, (EventKind.PACKET, EventKind.NIC_RECV,
                           EventKind.PACKET_LOCAL)),
    (timers.handle_timer, (EventKind.TIMER,)),
    (tcp.handle_tcp_rtx, (EventKind.TCP_RTX_TIMER,)),
    (tcp.handle_tcp_dack, (EventKind.TCP_DACK_TIMER,)),
    (tcp.handle_tcp_flush, (EventKind.TCP_FLUSH,)),
    (tcp.handle_tcp_close, (EventKind.TCP_CLOSE_TIMER,)),
)
_TCP_HANDLERS = (tcp.handle_tcp_rtx, tcp.handle_tcp_dack,
                 tcp.handle_tcp_flush, tcp.handle_tcp_close)


def _cpu_gate(cfg: NetConfig, sim, popped, buf):
    """Virtual-CPU admission check (ref: event_execute, event.c:71-89 +
    cpu.c:56-110): a host whose accumulated processing delay exceeds
    the threshold does not execute this event — it is re-queued at
    now + delay with its identity kept (src, seq and words: the
    reference re-schedules the same task). Executed events charge the
    host's per-event cost against its CPU availability time. Returns
    (sim, popped with the blocked lanes masked off, buf)."""
    net = sim.net
    # cpu_updateTime: availability never lags the present
    avail = torch.maximum(net.cpu_avail, popped.time)
    delay = avail - popped.time
    blocked = popped.valid & (delay > cfg.cpu_threshold_ns)
    sim = sim.replace(events=push_rows(
        sim.events, blocked, avail, popped.kind, popped.src, popped.seq,
        popped.words))
    executed = popped.valid & ~blocked
    net = net.replace(
        cpu_avail=torch.where(executed, avail + net.cpu_cost,
                              torch.where(popped.valid, avail,
                                          net.cpu_avail)),
        ctr_cpu_blocked=net.ctr_cpu_blocked + blocked.to(torch.int64),
        ctr_cpu_delay_ns=net.ctr_cpu_delay_ns
        + torch.where(blocked, delay, 0),
    )
    return sim.replace(net=net), popped._replace(valid=executed), buf


def _handle_proc_stop(cfg: NetConfig, sim, popped, buf):
    """PROC_STOP enforcement (ref: process.c:1286-1324): latch the
    host's stopped flag; app handlers are masked off from then on."""
    stop = popped.valid & (popped.kind == EventKind.PROC_STOP)
    net = sim.net
    return sim.replace(net=net.replace(
        proc_stopped=net.proc_stopped | stop)), buf


def make_step_fn(cfg: NetConfig, app_handlers: Sequence[AppHandler] = (),
                 caps=None):
    """Build the engine step_fn: netstack receive/timer handlers, then
    app handlers, then the send drain. The TCP timer handlers are
    included only when cfg.tcp. A non-negative cfg.cpu_threshold_ns
    puts the virtual-CPU admission gate ahead of everything
    (core/engine.py takes its re-queued pops out of events_processed). ``step(sim, popped, buf, kinds=None)``:
    ``kinds`` is the host-side bitmask of the kinds popped this
    micro-step (events.census_mask layout); None runs every family.

    `caps` (compile/specialize.py Capabilities, None = full program)
    leaves provably-dead work out of the step function: a dropped
    timers capability removes the timer handler family (whatever
    `kinds` says), and the send drain skips the loss draw (see
    nic._drain_one). Bit-identical wherever the capabilities hold; the
    per-window guard latch (engine.step_window) turns a violation into
    a fatal health fault."""
    cpu_on = cfg.cpu_threshold_ns >= 0
    pre = tuple((h, census_mask(k)) for h, k in _PRE_APP
                if cfg.tcp or h not in _TCP_HANDLERS)
    if timers_trimmed(caps):
        # no handler can arm a host timer (specialize.derive): leaving
        # the family out is the identity, and the guard latch trips
        # fatally if a TIMER appears anyway
        pre = tuple((h, m) for h, m in pre if h is not timers.handle_timer)
    # app handlers that take the kinds bitmask use it to skip their
    # own families (same identity argument)
    takes_kinds = tuple(
        "kinds" in inspect.signature(h).parameters for h in app_handlers)

    def step(sim, popped, buf, kinds=None):
        if cpu_on:
            sim, popped, buf = _cpu_gate(cfg, sim, popped, buf)
        sim, buf = _handle_proc_stop(cfg, sim, popped, buf)
        for h, m in pre:
            if kinds is None or kinds & m:
                sim, buf = h(cfg, sim, popped, buf)
        # a stopped host's app no longer sees events
        app_popped = popped._replace(
            valid=popped.valid & ~sim.net.proc_stopped)
        for h, tk in zip(app_handlers, takes_kinds):
            if tk:
                sim, buf = h(cfg, sim, app_popped, buf, kinds=kinds)
            else:
                sim, buf = h(cfg, sim, app_popped, buf)
        sim, buf = nic.handle_nic_send(cfg, sim, popped, buf, caps=caps)
        # per-host executed-event accounting (host.c:314-317);
        # popped.valid is post-gate, so a deferred event counts once
        sim = sim.replace(net=sim.net.replace(
            ctr_events_exec=sim.net.ctr_events_exec
            + popped.valid.to(torch.int64)))
        return sim, buf

    step.cpu_gate = cpu_on
    return step
