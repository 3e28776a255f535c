"""Composes the per-micro-step handler pipeline for the engine
(PyTorch port of shadow_tpu/net/step.py, UDP path).

Every handler sees all H popped events and acts only on lanes whose
kind matches; each is a masked batch update, so an all-false mask is
the identity. Receive side first, then app handlers, then the send
drain LAST so packets enqueued in this micro-step hit the wire without
a same-time event round-trip.

Gates: the reference wraps each handler family in lax.cond. Here the
engine reads the popped kinds once per micro-step (one host sync that
also decides whether the micro-step runs at all) and passes them as
the ``kinds`` bitmask; the receive and timer families are skipped with
a plain ``if`` when their kinds are absent. The app handlers and the
send drain run whenever the micro-step runs — value-identical, because
a handler whose mask is all false changes nothing.
"""

from __future__ import annotations

import inspect
from typing import Callable, Sequence

import torch

from shadow_tpu_torch.core.events import EventKind, census_mask
from shadow_tpu_torch.net import nic, timers
from shadow_tpu_torch.net.state import NetConfig

AppHandler = Callable  # (cfg, sim, popped, buf) -> (sim, buf)

_PRE_APP = (
    (nic.handle_nic_recv, (EventKind.PACKET, EventKind.NIC_RECV,
                           EventKind.PACKET_LOCAL)),
    (timers.handle_timer, (EventKind.TIMER,)),
)


def _handle_proc_stop(cfg: NetConfig, sim, popped, buf):
    """PROC_STOP enforcement (ref: process.c:1286-1324): latch the
    host's stopped flag; app handlers are masked off from then on."""
    stop = popped.valid & (popped.kind == EventKind.PROC_STOP)
    net = sim.net
    return sim.replace(net=net.replace(
        proc_stopped=net.proc_stopped | stop)), buf


def make_step_fn(cfg: NetConfig, app_handlers: Sequence[AppHandler] = ()):
    """Build the engine step_fn: netstack receive/timer handlers, then
    app handlers, then the send drain. ``step(sim, popped, buf,
    kinds=None)``: ``kinds`` is the host-side bitmask of the kinds
    popped this micro-step (events.census_mask layout); None runs every
    family."""
    if cfg.tcp:
        raise NotImplementedError(
            "shadow_tpu_torch: the TCP handlers are not ported yet")
    if cfg.cpu_threshold_ns >= 0:
        raise NotImplementedError(
            "shadow_tpu_torch: the virtual-CPU gate is not ported yet")
    pre = tuple((h, census_mask(k)) for h, k in _PRE_APP)
    # app handlers that take the kinds bitmask use it to skip their
    # own families (same identity argument)
    takes_kinds = tuple(
        "kinds" in inspect.signature(h).parameters for h in app_handlers)

    def step(sim, popped, buf, kinds=None):
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
        sim, buf = nic.handle_nic_send(cfg, sim, popped, buf)
        # per-host executed-event accounting (host.c:314-317)
        sim = sim.replace(net=sim.net.replace(
            ctr_events_exec=sim.net.ctr_events_exec
            + popped.valid.to(torch.int64)))
        return sim, buf

    return step
