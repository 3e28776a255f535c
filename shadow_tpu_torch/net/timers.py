"""timerfd-style timers (PyTorch port of shadow_tpu/net/timers.py;
ref: descriptor/timer.c).

Each host owns T timer slots with absolute next-expiry + interval. A
TIMER event carries (slot, generation); stale events from earlier
settings are ignored on fire, and periodic timers reschedule
themselves. Arming timers (the reference's timer_set) comes with the
first application that uses them.
"""

from __future__ import annotations

import torch

from shadow_tpu_torch.core import simtime
from shadow_tpu_torch.core.events import EventKind, emit
from shadow_tpu_torch.net.rings import gather_hs, set_hs
from shadow_tpu_torch.net.state import NetConfig

I32 = torch.int32
I64 = torch.int64

# timer event words
TW_SLOT = 0
TW_GEN = 1


def handle_timer(cfg: NetConfig, sim, popped, buf):
    """kind=TIMER: count the expiration if the generation is current;
    reschedule periodic timers."""
    net = sim.net
    mask = popped.valid & (popped.kind == EventKind.TIMER)
    slot = popped.words[:, TW_SLOT]
    gen = popped.words[:, TW_GEN]
    live = mask & (gather_hs(net.tm_gen, slot) == gen)

    exp = gather_hs(net.tm_expirations, slot)
    net = net.replace(
        tm_expirations=set_hs(net.tm_expirations, live, slot, exp + 1))
    interval = gather_hs(net.tm_interval, slot)
    periodic = live & (interval > 0)
    nxt = popped.time + interval
    net = net.replace(
        tm_expire=set_hs(net.tm_expire, live, slot,
                         torch.where(periodic, nxt, simtime.INVALID)))
    buf = emit(buf, periodic, net.lane_id, nxt, EventKind.TIMER, popped.words)
    return sim.replace(net=net), buf
