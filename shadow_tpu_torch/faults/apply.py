"""Window-boundary fault application (PyTorch port of
shadow_tpu/faults/apply.py: make_table_fn, make_fault_fn, seed_wakeups,
install, fault_fn_for).

Design rule (the reference's): every fault effect is a pure function of
(compiled plan, wend). Each window boundary replays all records with
``t_ns < wend`` over the pristine boot tables; a host is down while its
crash records so far outnumber its restart records. No cursor and no
fault state in the Sim, so a checkpoint needs nothing extra: a restored
sim's tables are overwritten from the replay at the very next boundary.

The replay runs on the host. `wend` is a host int and the plan is
constant, so the [V,V] tables and the ``down[h]`` vector depend only on
how many records precede wend — records are time-sorted, so that count
is one ``searchsorted``. Each count's tables are computed once in numpy
with the reference's float32 arithmetic (``1 - v/PPM`` as its CPU
program rounds it, _loss_reliability; later records win, ties in plan
order) and uploaded once; a window whose count did not change costs no
launch. The crash reset is a host ``if`` on that
vector (no device read), then one ``torch.where`` per restored leaf.

Crash semantics: while a host is down, every boundary (idempotently)
flushes its event row — sparing PROC_START and FAULT_WAKEUP so the
seeded restart survives — and restores its per-host netstack, app and
TCP rows to their boot values. RNG state and the ``ctr_*``/``cap_*``
counters are not rolled back (_CRASH_KEEP).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from shadow_tpu_torch.core import simtime
from shadow_tpu_torch.core.events import EventKind
from shadow_tpu_torch.faults.plan import (
    FaultKind,
    FaultPlan,
    HOST_KINDS,
    PPM,
    compile_plan,
    validate_records,
)
from shadow_tpu_torch.net.state import REPLICATED_FIELDS, NetState

# NetState per-host fields that survive a crash. Everything else is
# restored to its boot value while the host is down.
_CRASH_KEEP = frozenset(REPLICATED_FIELDS) | {
    "lane_id", "rng_keys", "rng_ctr", "rq_overflow", "rq_overflow_h",
    "last_drop_status",
}

_REL_KINDS = (FaultKind.LINK_DOWN, FaultKind.LINK_UP, FaultKind.LOSS,
              FaultKind.PARTITION, FaultKind.HEAL)


# float32 1/PPM, as XLA folds the reference's `v / PPM`
_RECIP_PPM = float(np.float32(1.0) / np.float32(PPM))


def _loss_reliability(v) -> np.float32:
    """The reference's ``1.0 - v.astype(F32) / PPM`` as its CPU program
    evaluates it: XLA turns the division by the constant into a product
    with the float32 reciprocal, and LLVM fuses the subtraction with
    that product (one rounding, an fma). Checked against the reference
    for every v in [0, PPM]; a plain float32 division differs in the
    last bit for 416,664 of them. The product is exact in float64; the
    subtraction's error is carried and decides the one case double
    rounding could get wrong (a float64 result on a float32 midpoint)."""
    p = float(np.float32(v)) * _RECIP_PPM
    y = 1.0 - p
    err = (1.0 - y) - p
    f = np.float32(y)
    if float(f) != y:
        g = np.nextafter(f, np.float32(np.inf if y > float(f) else -np.inf))
        if (float(f) + float(g)) / 2 == y and err != 0:
            f = max(f, g) if err > 0 else min(f, g)
    return f


def _crash_keep(name: str) -> bool:
    return (name in _CRASH_KEEP or name.startswith("ctr_")
            or name.startswith("cap_"))


def _down_mask(leaf, down):
    """Broadcast down [H] bool against a [H, ...] leaf."""
    return down.reshape(down.shape + (1,) * (leaf.ndim - 1))


class _Replay:
    """The plan's record prefix that precedes a window end, and the
    tables and down vector it gives (numpy, computed once per prefix
    length)."""

    def __init__(self, plan: FaultPlan, base_lat, base_rel, num_hosts):
        self.plan = plan
        self.lat0 = np.asarray(base_lat, np.int64)
        self.rel0 = np.asarray(base_rel, np.float32)
        self.num_hosts = int(num_hosts)
        self._tables = [(self.lat0, self.rel0)]
        self._down = {}

    def count(self, wend) -> int:
        """How many records have t_ns < wend."""
        return int(np.searchsorted(self.plan.t_ns, int(wend), side="left"))

    def tables(self, n: int):
        """(lat [V,V] i64, rel [V,V] f32) with records [0, n) applied."""
        while len(self._tables) <= n:
            i = len(self._tables) - 1
            lat, rel = (x.copy() for x in self._tables[-1])
            self._apply(i, lat, rel)
            self._tables.append((lat, rel))
        return self._tables[n]

    def _apply(self, i, lat, rel):
        p = self.plan
        k, a, b, v = int(p.kind[i]), int(p.a[i]), int(p.b[i]), p.value[i]
        if k == FaultKind.LATENCY:
            for r, c in ((a, b), (b, a)):
                lat[r, c] = self.lat0[r, c] + v
        elif k in (FaultKind.PARTITION, FaultKind.HEAL):
            src = self.rel0 if k == FaultKind.HEAL else np.zeros_like(rel)
            rel[a, :] = src[a, :]
            rel[:, a] = src[:, a]
        elif k in _REL_KINDS:
            for r, c in ((a, b), (b, a)):
                if k == FaultKind.LINK_DOWN:
                    rel[r, c] = 0.0
                elif k == FaultKind.LINK_UP:
                    rel[r, c] = self.rel0[r, c]
                else:
                    rel[r, c] = _loss_reliability(v)

    def down(self, n: int) -> np.ndarray:
        """[GH] bool: more crash than restart records in [0, n)."""
        if n not in self._down:
            p, H = self.plan, self.num_hosts
            kind, a = p.kind[:n], p.a[:n].astype(np.int64)
            crashes = np.bincount(a[kind == FaultKind.CRASH], minlength=H)
            restarts = np.bincount(a[kind == FaultKind.RESTART],
                                   minlength=H)
            self._down[n] = crashes[:H] > restarts[:H]
        return self._down[n]


def _replay_for(plan: FaultPlan, boot_sim) -> _Replay:
    base_rel = boot_sim.net.reliability.cpu().numpy()
    V = base_rel.shape[0]
    if plan.num_vertices and plan.num_vertices != V:
        raise ValueError(f"plan compiled for {plan.num_vertices} vertices, "
                         f"topology has {V}")
    return _Replay(plan, boot_sim.net.latency_ns.cpu().numpy(), base_rel,
                   boot_sim.net.host_ip.shape[0])


def make_table_fn(plan: FaultPlan, boot_sim):
    """``table_fn(t) -> (lat, rel)``: the [V,V] tables (numpy, on the
    host) with every record ``t_ns < t`` applied over the boot tables.
    The adaptive window rule (engine.make_wend_fn) calls it at
    ``wstart + 1``, so a window that starts exactly at a record time is
    sized from the post-record tables. None for an empty plan."""
    if plan is None or plan.n == 0:
        return None
    replay = _replay_for(plan, boot_sim)

    def table_fn(wend):
        return replay.tables(replay.count(wend))

    table_fn.replay = replay
    return table_fn


def make_fault_fn(plan: FaultPlan, boot_sim):
    """Compile `plan` against the *boot* sim (the bundle's pristine
    state — never a restored checkpoint, whose tables may already be
    fault-mutated) into ``fault_fn(sim, wend) -> sim``, applied by
    core.engine.step_window before each window. None for an empty plan,
    so the engine's window is untouched."""
    if plan is None or plan.n == 0:
        return None
    replay = _replay_for(plan, boot_sim)
    dev = boot_sim.events.time.device
    GH = replay.num_hosts
    k_np = plan.kind
    rel_kinds = bool(np.isin(k_np, _REL_KINDS).any())
    lat_kinds = bool((k_np == FaultKind.LATENCY).any())
    has_crash = bool(np.isin(k_np, HOST_KINDS).any())
    uploaded = {}   # record count -> device tables / down mask

    def tables_on_device(n):
        if ("tables", n) not in uploaded:
            lat, rel = replay.tables(n)
            uploaded["tables", n] = (torch.tensor(lat, device=dev),
                                     torch.tensor(rel, device=dev))
        return uploaded["tables", n]

    if has_crash:
        # Boot captures for the crash reset. The port never writes a
        # tensor in place, so the boot sim's own tensors serve. The
        # reference gathers a shard's rows through lane_id; on the
        # port's serial sim that is the identity (sharding is ROADMAP.md
        # Queue 1 item 9).
        boot_net = {
            f.name: getattr(boot_sim.net, f.name)
            for f in dataclasses.fields(NetState)
            if not _crash_keep(f.name)
            and getattr(boot_sim.net, f.name) is not None
        }
        boot_app, boot_tcp = boot_sim.app, boot_sim.tcp

        def down_on_device(n):
            """The down mask on the device, None when no host is down."""
            if ("down", n) not in uploaded:
                d = replay.down(n)
                uploaded["down", n] = (torch.as_tensor(d, device=dev)
                                       if d.any() else None)
            return uploaded["down", n]

        def reset_tree(cur, boot, down):
            if cur is None:
                return None
            upd = {}
            for f in dataclasses.fields(cur):
                c, b = getattr(cur, f.name), getattr(boot, f.name)
                if dataclasses.is_dataclass(c):
                    upd[f.name] = reset_tree(c, b, down)
                elif (isinstance(c, torch.Tensor) and c.ndim
                      and b.shape[0] == GH):
                    upd[f.name] = torch.where(_down_mask(c, down), b, c)
            return dataclasses.replace(cur, **upd)

        def crash_reset(sim, down):
            if getattr(sim, "admission", None) is not None:
                raise NotImplementedError(
                    "shadow_tpu_torch: a crash reset on a resident-lane "
                    "Sim (admission) needs core/lanes.py (ROADMAP.md "
                    "Queue 1 item 8)")
            q = sim.events
            spare = ((q.kind == EventKind.PROC_START)
                     | (q.kind == EventKind.FAULT_WAKEUP))
            keep = ~down[:, None] | spare
            q = q.replace(
                time=torch.where(keep, q.time, simtime.INVALID),
                kind=torch.where(keep, q.kind, 0),
                src=torch.where(keep, q.src, 0),
                seq=torch.where(keep, q.seq, 0),
                words=torch.where(keep[:, :, None], q.words, 0),
            )
            net_upd = {
                name: torch.where(_down_mask(cur, down), boot, cur)
                for name, boot in boot_net.items()
                for cur in (getattr(sim.net, name),)
            }
            return sim.replace(
                events=q, net=sim.net.replace(**net_upd),
                app=reset_tree(sim.app, boot_app, down),
                tcp=reset_tree(sim.tcp, boot_tcp, down))

    def fault_fn(sim, wend):
        n = replay.count(wend)
        if rel_kinds or lat_kinds:
            lat, rel = tables_on_device(n)
            net = sim.net
            if lat_kinds:
                net = net.replace(latency_ns=lat)
            if rel_kinds:
                net = net.replace(reliability=rel)
            sim = sim.replace(net=net)
        if has_crash:
            down = down_on_device(n)
            if down is not None:
                sim = crash_reset(sim, down)
        return sim

    fault_fn.replay = replay
    return fault_fn


def seed_wakeups(sim, records, vertex_of_host):
    """Push one pending event per fault record so a window boundary
    lands at (or before) every fault time. CRASH and the link and vertex
    kinds seed an inert FAULT_WAKEUP; RESTART seeds a real PROC_START
    at the restarted host, so its app re-runs its start handler (on the
    boot image the crash reset restored). Link-level records wake the
    first host attached to vertex `a` (host 0 if none is)."""
    from shadow_tpu_torch.core.events import emit_words, push_rows

    vertex_of_host = np.asarray(vertex_of_host)
    H = int(vertex_of_host.shape[0])
    dev = sim.events.time.device
    for r in records:
        if r.kind == FaultKind.RESTART:
            host, kind = int(r.a), EventKind.PROC_START
        elif r.kind == FaultKind.CRASH:
            host, kind = int(r.a), EventKind.FAULT_WAKEUP
        else:
            att = np.flatnonzero(vertex_of_host == r.a)
            host = int(att[0]) if att.size else 0
            kind = EventKind.FAULT_WAKEUP
        mask = np.zeros(H, bool)
        mask[host] = True
        m = torch.as_tensor(mask, device=dev)
        q = push_rows(
            sim.events, m,
            torch.full((H,), r.t_ns, dtype=torch.int64, device=dev),
            torch.full((H,), kind, dtype=torch.int32, device=dev),
            torch.arange(H, dtype=torch.int32, device=dev),
            sim.events.next_seq,
            emit_words(0, num_hosts=H, device=dev),
        )
        q = q.replace(next_seq=q.next_seq + m.to(torch.int32))
        sim = sim.replace(events=q)
    return sim


def install(bundle, records):
    """Attach a fault schedule to a built SimBundle: validate and
    compile the plan, seed the wakeup events into bundle.sim, and keep
    the plan on the bundle for fault_fn_for and the runners. Call it
    before the first window runs."""
    records = list(records)
    GH = int(bundle.sim.net.host_ip.shape[0])
    V = int(bundle.sim.net.reliability.shape[0])
    plan = compile_plan(records, num_hosts=GH, num_vertices=V)
    errors, _ = validate_records(records, num_hosts=GH, num_vertices=V,
                                 min_jump_ns=bundle.min_jump)
    if errors:  # compile_plan already raised; belt and braces
        raise ValueError("\n".join(errors))
    bundle.sim = seed_wakeups(bundle.sim, records,
                              bundle.sim.net.vertex_of_host.cpu().numpy())
    bundle.fault_plan = plan
    return plan


def fault_fn_for(bundle):
    """fault_fn of a bundle passed through install(), or None when it
    carries no plan. Give it the *boot* bundle: the base tables and the
    crash reset's boot image come from bundle.sim."""
    if getattr(bundle, "fault_plan", None) is None:
        return None
    return make_fault_fn(bundle.fault_plan, bundle.sim)
