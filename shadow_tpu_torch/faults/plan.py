"""Fault plans — deterministic dynamic-failure schedules (a copy of
shadow_tpu/faults/plan.py: the port keeps its own, numpy only).

The reference Shadow only models *static* per-path reliability
(topology.c:1442-1460 -> routing/topology.py); real long-running
workloads are defined by *dynamic* failure: links flapping, loss and
latency changing, hosts crashing and rejoining. A fault plan is a
time-sorted, fixed-shape array of records `(t_ns, kind, a, b, value)`
compiled once per run and applied at window boundaries (faults/apply.py)
by rewriting the replicated latency/reliability tables the NIC already
reads — no per-packet branching, zero cost when the plan is empty.

This module is the host-side half: record types, validation, JSON
round-trip, and compilation to the fixed numpy arrays apply.py replays
on the host at each window boundary.

Index vocabulary (the compiled form):
- link-level kinds (LINK_DOWN/LINK_UP/LOSS/LATENCY) address a pair of
  topology *vertices* (a, b) — the same [V,V] coordinates as
  NetState.latency_ns / reliability;
- PARTITION/HEAL address a single vertex `a` (its whole row+column);
- CRASH/RESTART address a *host* index `a`.
Config-level names (XML <fault> elements) are resolved to these
indices by records_from_config once the bundle placement is known.

`value` encoding is integral so one i64 column serves every kind:
LOSS carries loss probability in parts-per-million; LATENCY carries
the *added* latency in ns (0 restores the base path latency —
negative deltas are rejected: shrinking a path below the precomputed
minimum would invalidate the conservative window).
"""

from __future__ import annotations

from dataclasses import dataclass
import json

import numpy as np


class FaultKind:
    NONE = 0
    LINK_DOWN = 1   # (a,b) path reliability -> 0, both directions
    LINK_UP = 2     # (a,b) path reliability -> base, both directions
    LOSS = 3        # (a,b) loss override; value = loss ppm
    LATENCY = 4     # (a,b) latency spike; value = added ns (0 = base)
    CRASH = 5       # host a: queue flush + socket reset while down
    RESTART = 6     # host a rejoins; seeds a PROC_START at t
    PARTITION = 7   # vertex a isolated (row+col reliability -> 0)
    HEAL = 8        # vertex a's row+col reliability -> base


KIND_NAMES = {
    "linkdown": FaultKind.LINK_DOWN, "link_down": FaultKind.LINK_DOWN,
    "link-down": FaultKind.LINK_DOWN,
    "linkup": FaultKind.LINK_UP, "link_up": FaultKind.LINK_UP,
    "link-up": FaultKind.LINK_UP,
    "loss": FaultKind.LOSS,
    "latency": FaultKind.LATENCY,
    "crash": FaultKind.CRASH,
    "restart": FaultKind.RESTART,
    "partition": FaultKind.PARTITION,
    "heal": FaultKind.HEAL,
}

NAME_OF_KIND = {
    FaultKind.LINK_DOWN: "linkdown", FaultKind.LINK_UP: "linkup",
    FaultKind.LOSS: "loss", FaultKind.LATENCY: "latency",
    FaultKind.CRASH: "crash", FaultKind.RESTART: "restart",
    FaultKind.PARTITION: "partition", FaultKind.HEAL: "heal",
}

LINK_KINDS = (FaultKind.LINK_DOWN, FaultKind.LINK_UP,
              FaultKind.LOSS, FaultKind.LATENCY)
VERTEX_KINDS = (FaultKind.PARTITION, FaultKind.HEAL)
HOST_KINDS = (FaultKind.CRASH, FaultKind.RESTART)

PPM = 1_000_000


@dataclass
class FaultRecord:
    t_ns: int
    kind: int
    a: int
    b: int = -1
    value: int = 0


@dataclass
class FaultPlan:
    """Compiled, time-sorted plan: parallel numpy columns, fixed shape.
    apply.make_fault_fn replays them on the host."""

    t_ns: np.ndarray    # [N] i64
    kind: np.ndarray    # [N] i32
    a: np.ndarray       # [N] i32
    b: np.ndarray       # [N] i32
    value: np.ndarray   # [N] i64
    num_hosts: int = 0
    num_vertices: int = 0

    @property
    def n(self) -> int:
        return int(self.t_ns.shape[0])


def validate_records(records, *, num_hosts=None, num_vertices=None,
                     min_jump_ns=None):
    """Offline plan validation. Returns (errors, warnings) as lists of
    strings; compile_plan raises on any error, tools/faultplan_lint.py
    prints both. Range checks run only when the bound is known."""
    errors: list[str] = []
    warnings: list[str] = []
    last_t = None
    down: dict[int, int] = {}   # host -> index of the unmatched crash
    for i, r in enumerate(records):
        where = f"record {i} (t={r.t_ns})"
        if r.t_ns < 0:
            errors.append(f"{where}: negative time")
        if last_t is not None and r.t_ns < last_t:
            errors.append(f"{where}: times not sorted "
                          f"(previous was {last_t})")
        last_t = r.t_ns
        if r.kind not in NAME_OF_KIND:
            errors.append(f"{where}: unknown kind {r.kind}")
            continue
        if min_jump_ns and r.t_ns % min_jump_ns:
            warnings.append(
                f"{where}: not aligned to the {min_jump_ns} ns window; "
                f"the engine clamps the enclosing window to END at the "
                f"record (exact fault timing), at the cost of one "
                f"shortened window per record")
        if r.kind in LINK_KINDS:
            if r.b < 0:
                errors.append(f"{where}: {NAME_OF_KIND[r.kind]} needs "
                              f"both endpoints a and b")
            for end in (r.a, r.b):
                if num_vertices is not None and not (
                        0 <= end < num_vertices):
                    errors.append(f"{where}: vertex {end} out of range "
                                  f"[0, {num_vertices})")
        elif r.kind in VERTEX_KINDS:
            if num_vertices is not None and not (0 <= r.a < num_vertices):
                errors.append(f"{where}: vertex {r.a} out of range "
                              f"[0, {num_vertices})")
        else:  # HOST_KINDS
            if num_hosts is not None and not (0 <= r.a < num_hosts):
                errors.append(f"{where}: host {r.a} out of range "
                              f"[0, {num_hosts})")
            if r.kind == FaultKind.CRASH:
                if r.a in down:
                    errors.append(f"{where}: host {r.a} crashed again "
                                  f"at record {down[r.a]} without a "
                                  f"restart in between")
                down[r.a] = i
            else:
                if r.a not in down:
                    errors.append(f"{where}: restart of host {r.a} "
                                  f"without a preceding crash")
                down.pop(r.a, None)
        if r.kind == FaultKind.LOSS and not (0 <= r.value <= PPM):
            errors.append(f"{where}: loss value {r.value} ppm outside "
                          f"[0, {PPM}]")
        if r.kind == FaultKind.LATENCY and r.value < 0:
            errors.append(
                f"{where}: negative latency delta {r.value} ns would "
                f"shrink a path below the precomputed minimum and "
                f"break the conservative window")
    return errors, warnings


def compile_plan(records, *, num_hosts: int,
                 num_vertices: int) -> FaultPlan:
    """Validate and freeze records into the fixed-shape columns. The
    input order is kept (validation enforces time-sortedness, and a
    stable order is part of the determinism contract: records at equal
    times apply in plan order on every shard)."""
    records = list(records)
    errors, _ = validate_records(records, num_hosts=num_hosts,
                                 num_vertices=num_vertices)
    if errors:
        raise ValueError("invalid fault plan:\n  " + "\n  ".join(errors))
    return FaultPlan(
        t_ns=np.array([r.t_ns for r in records], np.int64),
        kind=np.array([r.kind for r in records], np.int32),
        a=np.array([r.a for r in records], np.int32),
        b=np.array([r.b for r in records], np.int32),
        value=np.array([r.value for r in records], np.int64),
        num_hosts=num_hosts, num_vertices=num_vertices,
    )


def _value_raw(kind: int, value) -> int:
    """JSON/XML `value` is human-scaled (loss as a probability,
    latency in seconds); the record column is integral."""
    if value is None:
        return 0
    if kind == FaultKind.LOSS:
        return int(round(float(value) * PPM))
    if kind == FaultKind.LATENCY:
        return int(round(float(value) * 1e9))
    return int(value)


def records_from_json(obj) -> list[FaultRecord]:
    """Parse the standalone JSON plan format (bench.py --faults,
    tools/faultplan_lint.py):

      {"faults": [{"time_s": 1.5, "kind": "linkdown", "a": 0, "b": 1},
                  {"t_ns": 2500000000, "kind": "loss", "a": 0, "b": 1,
                   "value": 0.05}, ...]}

    a/b are vertex indices for link kinds, host indices for
    crash/restart. `value` is a loss probability or seconds of added
    latency."""
    if isinstance(obj, (str, bytes)):
        obj = json.loads(obj)
    out = []
    for e in obj.get("faults", []):
        kname = str(e.get("kind", "")).lower()
        if kname not in KIND_NAMES:
            raise ValueError(f"unknown fault kind '{kname}' "
                             f"(known: {sorted(set(KIND_NAMES))})")
        kind = KIND_NAMES[kname]
        if "t_ns" in e:
            t = int(e["t_ns"])
        elif "time_s" in e:
            t = int(round(float(e["time_s"]) * 1e9))
        else:
            raise ValueError(f"fault entry {e} has neither t_ns nor time_s")
        out.append(FaultRecord(
            t_ns=t, kind=kind, a=int(e["a"]), b=int(e.get("b", -1)),
            value=_value_raw(kind, e.get("value"))))
    return out


def records_from_config(config, bundle) -> list[FaultRecord]:
    """Resolve the XML <fault> elements (config/xmlconfig.FaultSpec —
    endpoints are host *names*) against a built bundle: host name ->
    host index, and for link-level kinds on to the host's attachment
    vertex. Raw integers are accepted where a name does not resolve
    (vertex index for link kinds, host index for crash kinds)."""
    voh = bundle.sim.net.vertex_of_host
    vertex_of_host = np.asarray(voh.cpu() if hasattr(voh, "cpu") else voh)

    def _host(tok, where):
        if tok in bundle.name_to_index:
            return bundle.name_to_index[tok]
        try:
            return int(tok)
        except (TypeError, ValueError):
            raise ValueError(f"{where}: '{tok}' is not a known host name "
                             f"or index") from None

    def _vertex(tok, where):
        if tok in bundle.name_to_index:
            return int(vertex_of_host[bundle.name_to_index[tok]])
        try:
            return int(tok)
        except (TypeError, ValueError):
            raise ValueError(f"{where}: '{tok}' is not a known host name "
                             f"or vertex index") from None

    out = []
    for i, spec in enumerate(config.faults):
        where = f"<fault> {i} (t={spec.time_ns})"
        kname = spec.kind.lower()
        if kname not in KIND_NAMES:
            raise ValueError(f"{where}: unknown kind '{spec.kind}' "
                             f"(known: {sorted(set(KIND_NAMES))})")
        kind = KIND_NAMES[kname]
        if kind in HOST_KINDS:
            a, b = _host(spec.a, where), -1
        elif kind in VERTEX_KINDS:
            a, b = _vertex(spec.a, where), -1
        else:
            if spec.b is None:
                raise ValueError(f"{where}: {kname} needs both a and b")
            a, b = _vertex(spec.a, where), _vertex(spec.b, where)
        out.append(FaultRecord(t_ns=spec.time_ns, kind=kind, a=a, b=b,
                               value=_value_raw(kind, spec.value)))
    return out
