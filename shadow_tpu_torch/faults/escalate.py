"""Capacity escalation: turn a fatal overflow latch into a bigger run
(PyTorch port of shadow_tpu/faults/escalate.py).

Shadow never overflows — its heaps grow (its C event queue is a
dynamic splay tree); static device shapes trade that away for speed,
so an undersized capacity is a *fatal* latch
(faults/health.py). This module closes the loop the way an elastic
trainer regrows its mesh: map the tripped latch to the capacity knob
that sizes it, double the knob (bounded by a grow budget), rebuild the
bundle at the new shapes, and TRANSPLANT the last clean pre-trip
checkpoint into the grown arrays.

Why transplanting is exact and not best-effort: the supervisor gathers
health BEFORE saving a snapshot, so every snapshot on disk predates
the first dropped event — its contents are a prefix the larger
capacity would have produced bit-for-bit (capacity only changes
behavior at the first drop). Padding that prefix with empty slots on
the grown axis therefore reproduces, byte for byte on every logical
slot, the state of a from-scratch run at the grown capacity — modulo
one *layout* (not content) freedom: the router ring's modular head
addressing, which transplant() canonicalizes to head 0.

Empty-slot encodings (must match core/events.py create() and
net/state.py make_net_state): `.time` planes are simtime.INVALID,
`.dst` planes are -1, everything else zero-fills.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from shadow_tpu_torch.core import simtime

# fatal overflow latch (faults/health.py RunHealth field) -> the
# NetConfig capacity knob that sizes the overflowed array. The knob
# names are loader override keys, so a rebuild is just
# bundle.rebuild({knob: new}).
LATCH_KNOBS = {
    "events_overflow": "event_capacity",
    "outbox_overflow": "outbox_capacity",
    "rq_overflow": "router_ring",
}


def quantize_pow2(n: int) -> int:
    """Smallest power of two >= n (shadow_tpu/compile/buckets.py's
    rule, copied): 0 stays 0 and negatives are rejected."""
    n = int(n)
    if n < 0:
        raise ValueError(f"cannot bucket a negative capacity: {n}")
    if n <= 1:
        return n
    return 1 << (n - 1).bit_length()


class GrowBudgetExceeded(RuntimeError):
    """The escalation policy ran out of doublings — the run falls back
    to the plain retry path (and then to the structured failure
    report naming the knob)."""


@dataclasses.dataclass(frozen=True)
class Escalation:
    """One healed capacity trip, recorded in checkpoint extras and the
    run manifest (`escalations` block)."""

    time_ns: int   # window start the heal resumed from
    latch: str     # RunHealth field that tripped
    knob: str      # NetConfig knob grown
    old: int
    new: int

    def as_dict(self) -> dict:
        return {"time_ns": self.time_ns, "latch": self.latch,
                "knob": self.knob, "from": self.old, "to": self.new}

    @staticmethod
    def from_dict(d: dict) -> "Escalation":
        return Escalation(time_ns=int(d["time_ns"]), latch=d["latch"],
                          knob=d["knob"], old=int(d["from"]),
                          new=int(d["to"]))


@dataclasses.dataclass(frozen=True)
class EscalationPolicy:
    """Geometric regrowth: each trip doubles the tripped knob(s).
    `max_grow` bounds the total number of doublings across the whole
    run (including a resumed chain's earlier heals) — HBM is finite
    and a workload that keeps outrunning doubling capacity needs an
    operator, not another doubling."""

    factor: int = 2
    max_grow: int = 8


def overflowed_latches(health) -> list[str]:
    """Which capacity latches tripped, in LATCH_KNOBS order (stable:
    escalation records and grown knobs are deterministic)."""
    return [k for k in LATCH_KNOBS if int(getattr(health, k)) > 0]


def plan_growth(health, capacities: dict, policy: EscalationPolicy,
                grows_used: int, *, time_ns: int,
                ) -> tuple[dict, list[Escalation]]:
    """Map tripped latches to capacity overrides. `capacities` is the
    current build's knob values (utils.checkpoint.capacities_of_sim).
    Raises GrowBudgetExceeded when the doublings would exceed
    policy.max_grow, and ValueError when no *capacity* latch tripped
    (stall/regression trips are not healable by growing anything)."""
    latches = overflowed_latches(health)
    if not latches:
        raise ValueError("no capacity latch tripped — escalation "
                         "cannot heal this failure")
    if grows_used + len(latches) > policy.max_grow:
        raise GrowBudgetExceeded(
            f"healing {latches} needs {len(latches)} more doubling(s) "
            f"but {grows_used}/{policy.max_grow} of the grow budget "
            f"is spent (--max-grow)")
    overrides: dict = {}
    events: list[Escalation] = []
    for latch in latches:
        knob = LATCH_KNOBS[latch]
        old = int(capacities[knob])
        # grow to the next power-of-two bucket at or above old*factor
        # (the reference's rule: 24 -> 48 -> 64), so both packages
        # heal into the same shapes
        new = quantize_pow2(old * policy.factor)
        overrides[knob] = new
        events.append(Escalation(time_ns=int(time_ns), latch=latch,
                                 knob=knob, old=old, new=new))
    return overrides, events


# LaneHealth trip bit (core/lanes.py TRIP_*) -> the capacity knob a
# lane-local regrow doubles when the fleet requeues the lane as a
# standalone job. Stall/regression bits map to no knob (not healable
# by growing anything — the requeue retries at the same shapes).
TRIP_BIT_KNOBS = {
    1: "event_capacity",   # TRIP_EVENTS
    2: "outbox_capacity",  # TRIP_OUTBOX
    4: "router_ring",      # TRIP_RQ
}


def plan_lane_regrow(trip_bits: int, capacities: dict,
                     factor: int = 2) -> dict:
    """Capacity overrides for requeuing a quarantined lane as its own
    job: every capacity knob named by the lane's trip bits, doubled —
    the lane-local analog of plan_growth, without the shared program's
    grow budget (the requeued job budgets its own attempts)."""
    overrides = {}
    for bit, knob in TRIP_BIT_KNOBS.items():
        if int(trip_bits) & bit:
            # next-bucket regrow, same rule as plan_growth
            overrides[knob] = quantize_pow2(
                int(capacities[knob]) * int(factor))
    return overrides


def extract_lane(leaves: dict, meta: dict, lane: int,
                 replicas: int) -> tuple[dict, dict]:
    """Checkpoint lane surgery: slice one lane's share out of a packed
    snapshot's leaves (utils.checkpoint.load_leaves format).

    Every leaf with a leading host axis is cut to the lane's
    contiguous host block; [R]-shaped lane-health planes (".lanes.")
    are cut to the lane's entry; replicated whole-sim state (telem /
    inject planes, [V,V] tables, scalars) rides along whole.

    The result is a salvage ARTIFACT: post-mortem evidence plus the
    requeue context the fleet needs (what tripped, at which time, at
    what shapes). It is NOT a bit-resumable standalone checkpoint —
    per-host identity state (rng keys, IPs, lane_id) is seeded by
    global host index, so the requeued job re-runs the scenario fresh
    at regrown capacities instead of resuming the slice."""
    R = int(replicas)
    lane = int(lane)
    if not 0 <= lane < R:
        raise ValueError(f"lane {lane} out of range for replicas={R}")
    caps = dict(meta.get("capacities") or {})
    H = caps.get("num_hosts")
    if H is None:
        hk = next((k for k in leaves if k.endswith(".rq_head")), None)
        H = leaves[hk].shape[0] if hk is not None else None
    if H is None or H % R != 0:
        raise ValueError(
            f"cannot slice lane {lane}/{R} out of num_hosts={H}")
    hs = H // R
    lo, hi = lane * hs, (lane + 1) * hs
    out = {}
    for key, arr in leaves.items():
        a = np.asarray(arr)
        if key.startswith((".telem", ".inject", ".flows")):
            # whole-sim rings (flow ring rows are samples, not hosts —
            # its capacity could collide with H, so never host-slice)
            out[key] = a
        elif key.startswith((".lanes", ".admission")):
            # [R]-shaped lane-health / lease planes: the lane's entry
            out[key] = a[lane:lane + 1] if a.ndim else a
        elif a.ndim and a.shape[0] == H:
            out[key] = a[lo:hi]
        else:
            out[key] = a
    caps["num_hosts"] = hs
    lane_meta = {
        "time_ns": int(meta.get("time_ns", 0)),
        "capacities": caps,
        "lane": lane,
        "replicas": R,
        "packed_num_hosts": int(H),
        "extra": dict(meta.get("extra") or {}),
    }
    return out, lane_meta


def _fill_for(key: str):
    """Empty-slot encoding for a padded region of leaf `key`."""
    if key.endswith(".time"):
        return simtime.INVALID
    if key.endswith(".dst"):
        return -1
    return 0


def _rotate_router_ring(leaves: dict) -> dict:
    """Canonicalize the router ring to head 0 before tail-padding.

    rq slots address as (head + i) % R; growing R re-maps every
    wrapped slot, so naive tail-padding would interleave live and
    empty entries. Rotating each row so logical slot 0 sits at
    physical 0 (and zeroing rq_head) preserves the ring's *content*
    exactly while making tail-padding correct. rq_count is modular-
    address independent and stays put."""
    keys = {k: k for k in leaves}
    src_k = next((k for k in keys if k.endswith(".rq_src")), None)
    head_k = next((k for k in keys if k.endswith(".rq_head")), None)
    if src_k is None or head_k is None:
        return leaves
    head = leaves[head_k]
    if not np.any(head):
        return leaves  # already canonical
    R = leaves[src_k].shape[1]
    idx = (head[:, None] + np.arange(R)[None, :]) % R  # [H, R]
    out = dict(leaves)
    for k in keys:
        if k.endswith((".rq_src", ".rq_enq_ts", ".rq_words")):
            arr = leaves[k]
            out[k] = np.take_along_axis(
                arr, idx.reshape(idx.shape + (1,) * (arr.ndim - 2)),
                axis=1)
    out[head_k] = np.zeros_like(head)
    return out


def transplant(leaves: dict, meta: dict, template_sim):
    """Embed a snapshot's leaves into a (possibly larger) template.

    For every template leaf (keyed by flax path, convert.sim_tensors):
    identical shape -> the checkpoint bytes, verbatim; a grown trailing
    region -> checkpoint contents at the leading corner over an
    empty-slot canvas. Anything else — shrunk axis, dtype change, rank
    change, missing leaf — refuses loudly, naming the leaf. The Sim is
    built on the template's device. Returns (sim, time_ns, extra)
    exactly like checkpoint.load()."""
    from shadow_tpu_torch import convert

    caps = meta.get("capacities") or {}
    tmap = convert.sim_tensors(template_sim)

    # the host axis never grows: events re-key by host index, so a
    # different H is a different simulation, not a bigger one
    th = next((tuple(t.shape)[0] for k, t in tmap.items()
               if k.endswith(".rq_head")), None)
    if caps.get("num_hosts") is not None and th is not None \
            and caps["num_hosts"] != th:
        raise ValueError(
            f"snapshot has num_hosts={caps['num_hosts']}, template "
            f"has {th} — the host axis cannot be transplanted")

    ring_grew = (caps.get("router_ring") is not None and th is not None
                 and any(k.endswith(".rq_src")
                         and t.shape[1] > caps["router_ring"]
                         for k, t in tmap.items()))
    if ring_grew:
        leaves = _rotate_router_ring(leaves)

    out = {}
    for key, t in tmap.items():
        if key not in leaves:
            raise ValueError(f"snapshot missing leaf {key} "
                             f"(config mismatch?)")
        arr = np.asarray(leaves[key])
        shape, dtype = tuple(t.shape), convert.numpy_dtype(key, t)
        if arr.dtype != dtype or arr.ndim != len(shape):
            raise ValueError(
                f"cannot transplant leaf {key}: snapshot is "
                f"{arr.shape}/{arr.dtype}, template is "
                f"{shape}/{dtype}")
        if arr.shape == shape:
            out[key] = arr
            continue
        if any(a > b for a, b in zip(arr.shape, shape)):
            raise ValueError(
                f"cannot transplant leaf {key}: snapshot axis "
                f"{arr.shape} exceeds template {shape} — capacities "
                f"only grow (resuming into a shrunken config loses "
                f"state)")
        canvas = np.full(shape, _fill_for(key), dtype=dtype)
        canvas[tuple(slice(0, s) for s in arr.shape)] = arr
        out[key] = canvas
    sim = convert.sim_from_numpy(out, device=template_sim.events.time.device)
    return sim, meta["time_ns"], meta.get("extra", {})
