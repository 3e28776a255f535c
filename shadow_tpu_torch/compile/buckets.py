"""Shape-bucket planner: quantize capacity knobs, derive program keys
(PyTorch port of shadow_tpu/compile/buckets.py, the host half).

Every capacity knob that sizes a device array shapes the program: two
runs that differ only in `event_capacity=24` vs `25` allocate different
tensors and, once programs are stored or captured, are two programs,
though the second behaves as a superset of the first. Quantizing every
shape-bearing capacity UP to its power-of-two bucket collapses that
continuum onto a small lattice: runs land on shared shapes, and a
capacity escalation that regrows to the *next bucket*
(faults/escalate.py) resumes on a shape somebody already ran.

Why padding is free: capacity only changes behavior at the first
overflow (the escalation transplant's exactness argument,
faults/escalate.py). A run that never fills 24 slots runs
bit-identically with 32 — same event stream, same latches, same
conservation ledgers — so bucketing is a pure shape-sharing transform.

The **program key** is the canonical identity of one program: the
bucketed shape vector plus every constant fixed when the runner is
built (shard count, chunk K, adaptive flag, end time, min_jump, the
kind-census digest of the app/fault composition, the code version, the
machine fingerprint, the torch version). Keys have the reference's
format and inputs, with `torch.__version__` where the reference hashes
`jax.__version__` and this package's sources in `code_version`, so a
key's value differs between the packages while its relations (what
changes it, what leaves it alone) are the same.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
import platform

# NetConfig knobs quantized by bucket_config: each sizes a device
# array axis and obeys the first-overflow invariant (padding slots are
# behavior-neutral until the first drop, which is counted either way).
# 0 means "feature off" for sparse_lanes/inject_lanes and must stay 0
# — quantizing it to 1 would silently enable the feature.
BUCKET_KNOBS = (
    "event_capacity",
    "outbox_capacity",
    "router_ring",
    "in_ring",
    "out_ring",
    "sparse_lanes",
    "inject_lanes",
)

# Capacity-override keys (loader / escalation vocabulary) that
# escalation regrows bucket-to-bucket (faults/escalate.py).
CAPACITY_KEYS = ("event_capacity", "outbox_capacity", "router_ring")

KEY_PREFIX = "pk"
KEY_HEX = 16


def quantize_pow2(n: int) -> int:
    """Smallest power of two >= n. 0 stays 0 ("off" knobs must stay
    off) and negatives are rejected — a negative capacity is a bug,
    not a bucket."""
    n = int(n)
    if n < 0:
        raise ValueError(f"cannot bucket a negative capacity: {n}")
    if n <= 1:
        return n
    return 1 << (n - 1).bit_length()


def quantize_caps(caps: dict) -> dict:
    """Quantize a {knob: value} capacity-override dict (the escalation
    vocabulary). Unknown keys pass through untouched."""
    return {k: (quantize_pow2(v) if k in BUCKET_KNOBS else v)
            for k, v in caps.items()}


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """What the planner did: per-knob requested vs bucketed values.
    Rides the bench row's and the manifest's `compile` block
    (tools/telemetry_lint.py checks bucketed >= requested and bucketed
    is a power of two)."""

    requested: dict
    bucketed: dict

    @property
    def changed(self) -> dict:
        return {k: self.bucketed[k] for k, v in self.requested.items()
                if self.bucketed[k] != v}

    def as_dict(self) -> dict:
        return {k: {"requested": int(self.requested[k]),
                    "bucketed": int(self.bucketed[k])}
                for k in sorted(self.requested)}


def bucket_config(cfg):
    """Quantize every BUCKET_KNOB of a NetConfig to its power-of-two
    bucket. Returns (new_cfg, BucketPlan). Knobs left at None
    (sparse_lanes' engine default, derived emit_capacity) stay None —
    the default is already a bucket."""
    requested, bucketed, overrides = {}, {}, {}
    for knob in BUCKET_KNOBS:
        v = getattr(cfg, knob, None)
        if v is None:
            continue
        q = quantize_pow2(v)
        requested[knob] = int(v)
        bucketed[knob] = q
        if q != v:
            overrides[knob] = q
    new_cfg = dataclasses.replace(cfg, **overrides) if overrides else cfg
    return new_cfg, BucketPlan(requested=requested, bucketed=bucketed)


def shape_vector(cfg, *, telem_capacity: int | None = None,
                 lane_replicas: int | None = None,
                 inject_lanes: int | None = None) -> dict:
    """Every shape-bearing knob of a build, bucketed knobs and
    semantic axes alike — the program key's first component. The
    attach-time shapes (telemetry ring capacity, lane-isolation R,
    staged injection lanes) are not NetConfig fields, so callers that
    attached them pass the live values."""
    vec = {knob: int(getattr(cfg, knob))
           for knob in BUCKET_KNOBS if getattr(cfg, knob, None) is not None}
    vec["num_hosts"] = int(cfg.num_hosts)
    vec["sockets_per_host"] = int(cfg.sockets_per_host)
    vec["timers_per_host"] = int(cfg.timers_per_host)
    vec["emit_capacity"] = int(cfg.emit_capacity)
    vec["nic_drain"] = int(getattr(cfg, "nic_drain", 0))
    vec["tcp"] = bool(cfg.tcp)
    if telem_capacity is not None:
        vec["telem_capacity"] = int(telem_capacity)
    if lane_replicas is not None:
        vec["lane_replicas"] = int(lane_replicas)
    if inject_lanes is not None:
        vec["inject_lanes"] = int(inject_lanes)
    return vec


def shape_vector_for_sim(cfg, sim) -> dict:
    """shape_vector with the attach-time shapes read off a live Sim
    (telemetry ring / lane latches / injection staging are attached
    after the build, so the cfg alone understates the program's
    shapes)."""
    telem = getattr(sim, "telem", None)
    lanes = getattr(sim, "lanes", None)
    inject = getattr(sim, "inject", None)
    flows = getattr(sim, "flows", None)
    vec = shape_vector(
        cfg,
        telem_capacity=int(telem.capacity) if telem is not None else None,
        lane_replicas=int(lanes.replicas) if lanes is not None else None,
        inject_lanes=int(inject.lanes) if inject is not None else None)
    if flows is not None:
        vec["flow_capacity"] = int(flows.capacity)
        vec["flow_sample_period"] = int(flows.sample_period)
    if getattr(sim, "admission", None) is not None:
        # resident program (core/lanes.LaneAdmission): the lease planes
        # add leaves, so it keys apart from a lanes-only program of the
        # same shapes. Lease values are runtime data: joins and leaves
        # never change the key.
        vec["resident"] = True
    return vec


def lane_bucket(host_counts) -> int:
    """Shared power-of-two lane width for a set of heterogeneous
    tenants: every tenant's per-lane topology pads UP to this bucket
    (apps/phold.py active_hosts occupies the prefix; padding rows are
    idle forever, so padding is behavior-neutral the same way
    capacity padding is). One width for all lanes keeps the host
    partition uniform — lane of host h stays h // width."""
    counts = [int(h) for h in host_counts]
    if not counts:
        raise ValueError("lane_bucket needs at least one tenant")
    if min(counts) < 2:
        raise ValueError(
            f"every tenant needs >= 2 hosts, got {sorted(counts)}")
    return max(2, quantize_pow2(max(counts)))


def kind_census(app_handlers=(), app_bulk=None, *, fault_plan_digest=None,
                extra: dict | None = None) -> str:
    """Digest of the event-kind composition a program runs: which app
    handlers (by qualified name), which bulk pass, and the installed
    fault plan's record digest (the plan's constants are closed over
    by the fault rule, so two plans with equal shapes are still two
    programs)."""
    names = []
    for h in app_handlers or ():
        names.append(f"{getattr(h, '__module__', '?')}."
                     f"{getattr(h, '__qualname__', repr(h))}")
    bulk = None
    if app_bulk is not None:
        bulk = (f"{type(app_bulk).__module__}."
                f"{type(app_bulk).__qualname__}")
    blob = json.dumps({"handlers": names, "bulk": bulk,
                       "fault_plan": fault_plan_digest,
                       "extra": extra or {}}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


_CODE_VERSION: str | None = None


def code_version() -> str:
    """Digest of every source file of this package — its Python
    modules, its CUDA sources (csrc/*.cu) and native/'s C++ sources
    (native/src/*.cc), which are part of every program that loads them.
    Build outputs under `_build/` are not sources. Computed once per
    process."""
    global _CODE_VERSION
    if _CODE_VERSION is None:
        root = pathlib.Path(__file__).resolve().parents[1]
        h = hashlib.sha256()
        paths = [p for pat in ("*.py", "*.cu", "*.cc")
                 for p in root.rglob(pat)
                 if "_build" not in p.relative_to(root).parts]
        for p in sorted(paths):
            h.update(str(p.relative_to(root)).encode())
            try:
                h.update(p.read_bytes())
            except OSError:
                pass
        _CODE_VERSION = h.hexdigest()[:16]
    return _CODE_VERSION


def machine_fingerprint() -> str:
    """Stable digest of the host's ISA and CPU feature flags (a copy of
    shadow_tpu/utils/compcache.py machine_fingerprint): two hosts with
    equal fingerprints can share host-compiled artifacts."""
    feats = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    feats = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        feats = platform.processor()
    blob = f"{platform.machine()}|{feats}"
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def program_key(shapes: dict, *, shards: int = 1, chunk_windows: int = 1,
                adaptive: bool = False, census: str = "",
                end_time: int | None = None, min_jump: int | None = None,
                exchange_capacity: int | None = None,
                extra: dict | None = None) -> str:
    """Canonical program key: "pk" + 16 hex chars over the canonical
    JSON of (shape vector, shard count, chunk K, adaptive flag, the
    constants fixed at runner build, kind-census digest, code version,
    machine fingerprint, torch version). Runtime data (seeds, event
    payloads, table values) is not in it — that is what makes the key
    shareable across a sweep."""
    import torch

    blob = json.dumps({
        "shapes": {k: shapes[k] for k in sorted(shapes)},
        "shards": int(shards),
        "chunk_windows": int(chunk_windows),
        "adaptive": bool(adaptive),
        "end_time": None if end_time is None else int(end_time),
        "min_jump": None if min_jump is None else int(min_jump),
        "exchange_capacity": (None if exchange_capacity is None
                              else int(exchange_capacity)),
        "census": census,
        "code": code_version(),
        "machine": machine_fingerprint(),
        "torch": torch.__version__,
        "extra": extra or {},
    }, sort_keys=True)
    return KEY_PREFIX + hashlib.sha256(
        blob.encode()).hexdigest()[:KEY_HEX]


def is_program_key(key) -> bool:
    """Format check for manifests and the lint: pk + 16 lowercase hex."""
    return (isinstance(key, str) and len(key) == len(KEY_PREFIX) + KEY_HEX
            and key.startswith(KEY_PREFIX)
            and all(c in "0123456789abcdef"
                    for c in key[len(KEY_PREFIX):]))
