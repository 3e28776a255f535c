"""Minimal PHOLD-style ring model (PyTorch port of
shadow_tpu/apps/ring.py), the smallest end-to-end program: each event
at host h schedules one event at (h+1)%H after a fixed cross-host
latency (ref: src/test/phold/test_phold.c:36-52 is the full
weighted-random version; see shadow_tpu_torch.apps.phold). Run it with
``core.engine.run(ring.make(H, device=...), ring.step,
end_time=..., min_jump=ring.LATENCY)``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from shadow_tpu_torch.core import simtime
from shadow_tpu_torch.core.events import (
    EventKind,
    EventQueue,
    Outbox,
    _Replace,
    emit,
    emit_words,
    push_rows,
)
from shadow_tpu_torch.device import resolve_device

LATENCY = 10 * simtime.ONE_MILLISECOND
HOP_KIND = EventKind.USER


@dataclass
class RingSim(_Replace):
    events: EventQueue
    outbox: Outbox
    hops: torch.Tensor  # [H] i32 — events handled per host


def step(sim: RingSim, popped, buf, kinds=None):
    """The engine's step_fn (`kinds`, the popped-kinds bitmask the
    engine passes, is not needed: one kind)."""
    H = sim.events.num_hosts
    dev = sim.hops.device
    lane = torch.arange(H, dtype=torch.int32, device=dev)
    is_hop = popped.valid & (popped.kind == HOP_KIND)
    buf = emit(buf, is_hop, (lane + 1) % H, popped.time + LATENCY,
               HOP_KIND, emit_words(0, num_hosts=H, device=dev))
    return sim.replace(hops=sim.hops + is_hop.to(torch.int32)), buf


def make(num_hosts: int, capacity: int = 16, outbox_capacity: int = 16,
         device=None) -> RingSim:
    """The boot RingSim on `device` (None -> "cuda"; raises when CUDA
    is missing): host 0 starts the ring at t=0."""
    dev = resolve_device(device)
    H = num_hosts
    q = EventQueue.create(H, capacity, device=dev)
    mask = torch.arange(H, device=dev) == 0
    q = push_rows(
        q, mask,
        torch.zeros((H,), dtype=simtime.DTYPE, device=dev),
        torch.full((H,), HOP_KIND, dtype=torch.int32, device=dev),
        torch.zeros((H,), dtype=torch.int32, device=dev),
        torch.zeros((H,), dtype=torch.int32, device=dev),
        emit_words(0, num_hosts=H, device=dev),
    )
    return RingSim(
        events=q,
        outbox=Outbox.create(H, outbox_capacity, device=dev),
        hops=torch.zeros((H,), dtype=torch.int32, device=dev),
    )
