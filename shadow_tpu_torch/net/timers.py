"""timerfd-style timers (PyTorch port of shadow_tpu/net/timers.py;
ref: descriptor/timer.c).

Each host owns T timer slots with absolute next-expiry + interval. A
TIMER event carries (slot, generation); stale events from earlier
settings are ignored on fire, and periodic timers reschedule
themselves. Virtual processes arm, disarm and read them through the
timerfd syscalls (process/vproc.py).
"""

from __future__ import annotations

import torch

from shadow_tpu_torch.core import simtime
from shadow_tpu_torch.core.events import NWORDS, EventKind, as_tensor, emit
from shadow_tpu_torch.net.rings import gather_hs, set_hs
from shadow_tpu_torch.net.state import NetConfig

I32 = torch.int32
I64 = torch.int64

# timer event words
TW_SLOT = 0
TW_GEN = 1


def timer_set(sim, buf, mask, slot, expire_time, interval=0):
    """Arm timer `slot` per masked lane to fire at expire_time (abs),
    then every `interval` ns if nonzero. Returns (sim, buf)."""
    net = sim.net
    H = net.tm_expire.shape[0]
    dev = mask.device
    gen = gather_hs(net.tm_gen, slot) + 1
    expire = as_tensor(expire_time, simtime.DTYPE, dev)
    net = net.replace(
        tm_expire=set_hs(net.tm_expire, mask, slot, expire),
        tm_interval=set_hs(net.tm_interval, mask, slot,
                           as_tensor(interval, simtime.DTYPE, dev)),
        tm_gen=set_hs(net.tm_gen, mask, slot, gen),
    )
    words = torch.zeros((H, NWORDS), dtype=I32, device=dev)
    words[:, TW_SLOT] = as_tensor(slot, I32, dev)
    words[:, TW_GEN] = gen.to(I32)
    buf = emit(buf, mask, net.lane_id, expire.expand(H), EventKind.TIMER,
               words)
    return sim.replace(net=net), buf


def timer_disarm(sim, mask, slot):
    """Disarm: bump generation so in-flight events become stale."""
    net = sim.net
    gen = gather_hs(net.tm_gen, slot) + 1
    net = net.replace(
        tm_expire=set_hs(net.tm_expire, mask, slot, simtime.INVALID),
        tm_gen=set_hs(net.tm_gen, mask, slot, gen),
    )
    return sim.replace(net=net)


def timer_read(sim, mask, slot):
    """timerfd read(): returns expirations since last read and clears
    the count. Returns (sim, count[H])."""
    net = sim.net
    n = torch.where(mask, gather_hs(net.tm_expirations, slot), 0)
    net = net.replace(
        tm_expirations=set_hs(net.tm_expirations, mask, slot,
                              torch.zeros_like(n)))
    return sim.replace(net=net), n


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
