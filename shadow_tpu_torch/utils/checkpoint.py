"""Window-boundary checkpoint / resume (PyTorch port of
shadow_tpu/utils/checkpoint.py). The state is a tree of fixed-shape
tensors, so a snapshot is an npz of its leaves and resume is exact:
the window-advance rule restarts from the recorded next window start,
and the counter-based RNG (core/rng.py) keeps its stream in the state.

The file layout is the reference's (LAYOUT_VERSION 3): one npz leaf per
flax field path (convert.sim_to_numpy, the u32 planes as uint32) plus a
JSON ``__meta__`` with the resume time, per-leaf CRC32, the capacities
and the versions — so a snapshot of either package resumes in the
other. Determinism contract: run(0 -> T) == run(0 -> C) + save + load +
run(C -> T), bit for bit (tests/test_torch_checkpoint.py).

save() writes a temp file in the target directory, fsyncs it,
os.replace()s it into place and fsyncs the directory: readers see the
old snapshot or the new one, never a partial write.

The determinism contract holds with a fault plan installed too: fault
effects are a pure function of (plan, window end), so the plan is not
state and a snapshot carries none (faults/apply.py).

A Sim carrying an injection staging buffer (inject/staging.py)
snapshots its `.inject.*` leaves in the same layout, so a mid-trace
snapshot crosses between the packages both ways; a resume re-syncs a
fresh feeder from them (inject.Feeder.sync), replaying nothing.

save_salvage writes the supervisor's lane-surgery artifact (a packed
snapshot's lane slice, faults/escalate.py extract_lane) in the same
atomic, checksummed layout; load_leaves reads it back.

run_windows(mesh=...) runs the loop over a mesh of ranks
(parallel/shard.py); its snapshots hold the global layout, so they
resume on any shard count, in either package.

The verified-state ledger (parallel/elastic.py): a run carrying the
integrity sentinel stamps each snapshot with elastic_meta (per-shard
sha256 digests and the last window proven divergence-free), and
replan_shards re-partitions a snapshot onto another mesh width as a
digest-verified restamp — the layout is global, so no data moves.

Warm serving (compile/): run_windows(warm_start=...) resolves its
dispatch program against the persistent program store, and
prewarm_dispatch fills the store without running a window. Both build
the program through one rule (_resolve_loop, _program_key_for,
_make_dispatch_fns), so the program a prewarm persists is the one a
later run_windows loads; the resident program (fleet/admission.py)
builds its dispatch the same way.
"""

from __future__ import annotations

import glob
import json
import os
import tempfile
import zlib
from types import SimpleNamespace

import numpy as np
import torch

from shadow_tpu_torch import convert

# Bumped whenever the on-device byte layout changes meaning without
# changing shape/dtype (the reference's generations: v2 the
# protocol-independent packet words, v3 the Outbox's route_elided
# leaf); load() refuses another generation.
LAYOUT_VERSION = 3


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def capacities_of_sim(sim) -> dict:
    """The static-shape knobs a snapshot depends on, read from the
    arrays themselves; they ride __meta__ so a resume into a
    differently-sized build is diagnosed by name."""
    return {
        "num_hosts": int(sim.events.num_hosts),
        "event_capacity": int(sim.events.capacity),
        "outbox_capacity": int(sim.outbox.dst.shape[1]),
        "router_ring": int(sim.net.rq_src.shape[1]),
    }


def elastic_meta(sim, shards: int = 1) -> dict:
    """The verified-state ledger stamp a snapshot carries for elastic
    resume (parallel/elastic.py): per-shard sha256 digests over the
    leaves as sim_specs shards them (replicated leaves fold into every
    shard's digest, so digest s survives re-partitioning onto any mesh
    that still owns those rows), plus the sentinel's
    `last_verified_window` — the last window barrier proven
    divergence-free (None when no sentinel is attached: the snapshot
    is then trusted as-saved, verified == time_ns)."""
    from shadow_tpu_torch.parallel.elastic import (
        sentinel_report,
        shard_digests,
    )

    rep = sentinel_report(sim)
    return {
        "shard_digests": shard_digests(sim, shards),
        "last_verified_window": (None if rep is None
                                 else rep["verified_through_ns"]),
        "sentinel": rep,
    }


def _npz_path(path: str) -> str:
    # np.savez appends ".npz" to paths but not to file objects, and the
    # atomic write goes through a file object
    return path if path.endswith(".npz") else path + ".npz"


def save(path: str, sim, *, time_ns: int, extra: dict | None = None,
         shards: int = 1, config_digest: str | None = None,
         elastic: dict | None = None) -> str:
    """Snapshot a Sim at a window boundary; `time_ns` is the next window
    start (the resume point). Atomic: the snapshot appears at `path`
    complete or not at all. `shards` and `config_digest` are
    diagnostic metadata; `elastic` (elastic_meta) stamps the
    verified-state ledger block. Returns the path written."""
    leaves = convert.sim_to_numpy(sim)
    meta = {"time_ns": int(time_ns), "extra": extra or {},
            "layout": LAYOUT_VERSION, "keys": sorted(leaves),
            "crc32": {k: _crc(v) for k, v in leaves.items()},
            "capacities": capacities_of_sim(sim),
            "shards": int(shards),
            "config_digest": config_digest,
            "torch_version": torch.__version__}
    if elastic is not None:
        meta["elastic"] = elastic
    return _write_npz(_npz_path(path), leaves, meta, ".ckpt.")


def save_salvage(path: str, leaves: dict, meta: dict) -> str:
    """Write a raw-leaves artifact (the lane-surgery output of
    faults/escalate.py extract_lane) with save()'s atomic write and
    per-leaf CRC32; it reads back through load_leaves(). The meta rides
    verbatim plus the layout stamp and the kind "lane_salvage"."""
    meta = dict(meta)
    meta.setdefault("layout", LAYOUT_VERSION)
    meta["kind"] = "lane_salvage"
    leaves = {k: np.asarray(v) for k, v in leaves.items()}
    meta["keys"] = sorted(leaves)
    meta["crc32"] = {k: _crc(v) for k, v in leaves.items()}
    return _write_npz(_npz_path(path), leaves, meta, ".salvage.")


def _write_npz(path: str, leaves: dict, meta: dict, prefix: str) -> str:
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix=prefix, suffix=".tmp", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, __meta__=json.dumps(meta), **leaves)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # same directory -> atomic rename
        # durable rename: without the directory fsync the new entry can
        # be lost to power failure though the data blocks were fsynced
        _fsync_dir(d)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def _fsync_dir(path: str) -> None:
    """Best-effort directory fsync (filesystems that refuse O_RDONLY
    dir fsync keep the process-death-only guarantee)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _check_layout(meta: dict):
    layout = meta.get("layout", 1)
    if layout != LAYOUT_VERSION:
        raise ValueError(
            f"snapshot uses packet-word layout v{layout}, this "
            f"build reads v{LAYOUT_VERSION} — resuming would "
            f"reinterpret header words; re-run from config")


def peek_meta(path: str) -> dict:
    """A snapshot's __meta__ without the state arrays. Raises on a
    layout-generation mismatch."""
    with np.load(_npz_path(path), allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
    _check_layout(meta)
    return meta


def latest_checkpoint(prefix: str) -> str | None:
    """Newest snapshot (by recorded resume time) among files written as
    f"{prefix}.{time_ns}.npz", the spelling run_windows uses; None when
    none matches. Files whose time suffix does not parse are skipped."""
    best, best_t = None, -1
    for p in glob.glob(f"{prefix}.*.npz"):
        stem = p[len(prefix) + 1:-len(".npz")]
        try:
            t = int(stem)
        except ValueError:
            continue
        if t > best_t:
            best, best_t = p, t
    return best


def load_leaves(path: str) -> tuple[dict, dict]:
    """CRC- and layout-verified raw leaves {flax path: np.ndarray} plus
    the __meta__ dict. A CRC failure names the leaf."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        _check_layout(meta)
        crcs = meta.get("crc32", {})  # absent in older snapshots
        leaves = {}
        for key in z.files:
            if key == "__meta__":
                continue
            arr = z[key]
            if key in crcs and _crc(arr) != crcs[key]:
                raise ValueError(
                    f"snapshot leaf {key} fails its CRC32 — snapshot "
                    f"is corrupt, refuse to resume")
            leaves[key] = arr
    return leaves, meta


def _shape_mismatch_msg(key, arr, t, meta) -> str:
    msg = (f"snapshot leaf {key} is {arr.shape}/{arr.dtype}, "
           f"template expects {t.shape}/{t.dtype} (config mismatch)")
    caps = meta.get("capacities")
    if caps:
        # name the knob(s) whose recorded value explains the leaf
        diffs = [f"snapshot {k}={v}" for k, v in sorted(caps.items())
                 if isinstance(v, int) and (v in arr.shape)
                 and (v not in t.shape)]
        if diffs:
            msg += ("; " + ", ".join(diffs)
                    + " — rebuild with matching capacities or resume "
                      "with --auto-grow")
    return msg


def load(path: str, template_sim):
    """Rebuild a Sim from a snapshot, on the template's device.
    `template_sim` (built with the SAME config) gives the leaf set;
    every array is checked against the template's shape and dtype (its
    u32 planes as uint32) and against the stored CRC32. Each refusal
    names the leaf (and, for a shape mismatch, the capacity knob
    recorded at save time). Returns (sim, time_ns, extra)."""
    stored, meta = load_leaves(_npz_path(path))
    leaves = {}
    for key, t in convert.sim_tensors(template_sim).items():
        if key not in stored:
            raise ValueError(f"snapshot missing leaf {key} "
                             f"(config mismatch?)")
        arr = stored[key]
        spec = SimpleNamespace(shape=tuple(t.shape),
                               dtype=convert.numpy_dtype(key, t))
        if arr.shape != spec.shape or arr.dtype != spec.dtype:
            raise ValueError(_shape_mismatch_msg(key, arr, spec, meta))
        leaves[key] = arr
    sim = convert.sim_from_numpy(leaves,
                                 device=template_sim.events.time.device,
                                 template=template_sim)
    return sim, meta["time_ns"], meta["extra"]


def replan_shards(path: str, new_shards: int, *,
                  template_sim=None, out_path: str | None = None) -> str:
    """Re-partition a snapshot onto a `new_shards`-wide mesh. State
    arrays are saved in GLOBAL layout, so the re-partition is a
    verified metadata restamp, not a data shuffle:

    1. validate: new_shards is a power of two >= 1 that divides the
       snapshot's host count;
    2. verify: every leaf's CRC32 (load_leaves), and — when the
       snapshot carries a verified-state ledger and the caller gives
       the template to rebuild the Sim — the per-shard digests
       recomputed at the OLD width must match the stamped ones (a
       corrupt snapshot must not silently become the resume point of a
       degraded run);
    3. restamp: meta.shards = new_shards, the replan recorded in
       meta.elastic.replans (old -> new), and the per-shard digests
       recomputed at the NEW width when the template is given.

    Returns the written path (out_path, default: in place). The file
    is the reference's, byte for byte in its leaves and meta keys."""
    path = _npz_path(path)
    new_shards = int(new_shards)
    if new_shards < 1 or (new_shards & (new_shards - 1)):
        raise ValueError(
            f"replan_shards: new_shards={new_shards} must be a power "
            f"of two >= 1 (the bucket lattice and AOT program keys "
            f"are pow2)")
    leaves, meta = load_leaves(path)
    hosts = int(meta.get("capacities", {}).get("num_hosts", 0))
    if hosts and hosts % new_shards:
        raise ValueError(
            f"replan_shards: num_hosts={hosts} not divisible by "
            f"{new_shards} shards")
    old_shards = int(meta.get("shards", 1))
    el = dict(meta.get("elastic") or {})
    if template_sim is not None:
        from shadow_tpu_torch.parallel.elastic import shard_digests

        sim, _, _ = load(path, template_sim)
        stamped = el.get("shard_digests")
        if stamped:
            fresh = shard_digests(sim, old_shards)
            if fresh != list(stamped):
                bad = [s for s, (a, b) in
                       enumerate(zip(fresh, stamped)) if a != b]
                raise ValueError(
                    f"replan_shards: per-shard digest mismatch at "
                    f"shard(s) {bad} — snapshot state disagrees with "
                    f"its verified-state ledger, refuse to replan")
        el["shard_digests"] = shard_digests(sim, new_shards)
    el.setdefault("replans", []).append(
        {"from": old_shards, "to": new_shards})
    meta["shards"] = new_shards
    meta["elastic"] = el
    return _write_npz(_npz_path(out_path or path), leaves, meta,
                      ".replan.")


class _LoopPlan:
    """Resolved loop parameters shared by run_windows and
    prewarm_dispatch — one resolution rule so the program a prewarm
    persists is the program a later run_windows loads."""

    __slots__ = ("cfg", "step", "end", "min_jump", "fault_fn",
                 "caller_fault_fn", "bulk_fn", "wpd", "adaptive",
                 "chunked", "shards", "caps", "device")


def _resolve_loop(bundle, app_handlers, *, end_time, fault_fn, mesh,
                  mesh_axis, windows_per_dispatch, adaptive_jump,
                  sim=None, device=None):
    from shadow_tpu_torch.net.build import (
        _resolve_bulk_fn,
        _resolve_caps,
        _resolve_fault_fn,
        _runner_device,
    )
    from shadow_tpu_torch.net.step import make_step_fn

    if mesh is not None and device is not None \
            and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh rank's "
                         f"{mesh.device}")
    p = _LoopPlan()
    p.device = _runner_device(bundle,
                              mesh.device if mesh is not None else device)
    cfg = p.cfg = bundle.cfg
    # capability-trimmed variant (compile/specialize.py): same rule as
    # the whole-run factories — an opaque caller fault_fn disables it
    p.caps = _resolve_caps(bundle, fault_fn)
    p.step = make_step_fn(cfg, app_handlers, caps=p.caps)
    p.end = int(end_time if end_time is not None else cfg.end_time)
    p.min_jump = max(int(bundle.min_jump), 1)
    p.caller_fault_fn = fault_fn
    p.fault_fn = _resolve_fault_fn(bundle, fault_fn)
    p.bulk_fn = _resolve_bulk_fn(bundle, getattr(bundle, "app_bulk", None),
                                 caps=p.caps)
    wpd = (int(windows_per_dispatch) if windows_per_dispatch is not None
           else max(1, int(getattr(cfg, "windows_per_dispatch", 1) or 1)))
    if wpd < 1:
        raise ValueError(f"windows_per_dispatch must be >= 1, got {wpd}")
    p.wpd = wpd
    p.adaptive = (bool(adaptive_jump) if adaptive_jump is not None
                  else bool(getattr(cfg, "adaptive_jump", False)))
    # causality's advance attribution lives in the chunk body's explain
    # path, so a traced sim takes the chunk driver even at K = 1
    tracing = getattr(sim if sim is not None else bundle.sim,
                      "causality", None) is not None
    p.chunked = wpd > 1 or p.adaptive or tracing
    p.shards = 1 if mesh is None else mesh.size
    return p


def _program_key_for(bundle, plan, sim, app_handlers, *, sharded,
                     exchange_capacity):
    """Canonical program key for this loop's dispatch program
    (compile/buckets.py), or None when the caller passed an opaque
    fault_fn — its closure constants are invisible to the key, so warm
    serving would risk serving a program built with someone else's
    constants."""
    if plan.caller_fault_fn is not None:
        return None
    import hashlib

    from shadow_tpu_torch.compile import buckets
    from shadow_tpu_torch.telemetry.export import fault_plan_digest

    fp = getattr(bundle, "fault_plan", None)
    extra = {"path": ("sharded_" if sharded else "")
             + ("chunk" if plan.chunked else "window")}
    if plan.caps is not None and plan.caps.key_extra() is not None:
        # trimmed variants key apart from their full twins (see
        # net.build._whole_run_key_fn); untrimmed builds share keys
        extra["caps"] = plan.caps.key_extra()
    if plan.adaptive:
        # the adaptive wend rule bakes the host->vertex map into its
        # pair mask (net.build.adaptive_jump_spec)
        voh = bundle.sim.net.vertex_of_host.cpu().numpy()
        extra["voh"] = hashlib.sha256(voh.tobytes()).hexdigest()[:16]
    census = buckets.kind_census(
        app_handlers, getattr(bundle, "app_bulk", None),
        fault_plan_digest=fault_plan_digest(fp) if fp is not None else None)
    shapes = buckets.shape_vector_for_sim(bundle.cfg, sim)
    return buckets.program_key(
        shapes, shards=plan.shards,
        chunk_windows=plan.wpd if plan.chunked else 1,
        adaptive=plan.adaptive, census=census, end_time=plan.end,
        min_jump=bundle.min_jump, exchange_capacity=exchange_capacity,
        extra=extra)


def _make_dispatch_fns(bundle, plan, sim, app_handlers, *, mesh,
                       mesh_axis, exchange_capacity, warm,
                       store=None, compile_info=None):
    """Build the loop's dispatch program — the chunk body or the
    per-window body, serial or sharded — and route it through the
    program store when warm serving is on. Returns (chunk_fn,
    one_window, key, factory, example_args): exactly one of
    chunk_fn/one_window is non-None; factory/example_args let
    prewarm_dispatch resolve the identical program without running
    it."""
    from shadow_tpu_torch.compile import serve
    from shadow_tpu_torch.core.engine import (
        EngineStats,
        make_chunk_body,
        resolve_sparse_lanes,
        step_window,
    )
    from shadow_tpu_torch.net.build import _caps_meta, resolve_wend_fn
    from shadow_tpu_torch.parallel.elastic import make_sentinel_fn
    from shadow_tpu_torch.telemetry.flows import make_flow_fn
    from shadow_tpu_torch.telemetry.ring import make_telem_fn

    cfg, dev = bundle.cfg, plan.device
    key = None
    if warm or compile_info is not None:
        key = _program_key_for(bundle, plan, sim, app_handlers,
                               sharded=mesh is not None,
                               exchange_capacity=exchange_capacity)
    step, end, wpd = plan.step, plan.end, plan.wpd
    bulk_fn, fault_fn = plan.bulk_fn, plan.fault_fn
    sparse = resolve_sparse_lanes(cfg)
    meta = _caps_meta(plan.caps)
    if plan.chunked:
        wend_fn = resolve_wend_fn(bundle, end, plan.adaptive, fault_fn)

        def factory():
            if mesh is not None:
                from shadow_tpu_torch.parallel.shard import \
                    make_sharded_chunk

                return make_sharded_chunk(
                    mesh, mesh_axis, bundle.sim, cfg, step, end_time=end,
                    wend_fn=wend_fn, chunk_windows=wpd,
                    exchange_capacity=exchange_capacity, bulk_fn=bulk_fn,
                    fault_fn=fault_fn)
            return make_chunk_body(
                step, end_time=end, wend_fn=wend_fn, chunk_windows=wpd,
                emit_capacity=cfg.emit_capacity,
                lane_fn=lambda s: s.net.lane_id, bulk_fn=bulk_fn,
                telem_fn=make_telem_fn(), sparse_lanes=sparse,
                fault_fn=fault_fn, flow_fn=make_flow_fn(),
                sentinel_fn=make_sentinel_fn(None))
        example = (sim, EngineStats.create(device=dev), 0)
        chunk_fn = serve.maybe_warm(factory, key, enabled=warm, store=store,
                                    meta=meta, info=compile_info)
        return chunk_fn, None, key, factory, example

    def factory():
        if mesh is not None:
            from shadow_tpu_torch.parallel.shard import make_sharded_window

            return make_sharded_window(
                mesh, mesh_axis, bundle.sim, cfg, step,
                exchange_capacity=exchange_capacity, bulk_fn=bulk_fn,
                fault_fn=fault_fn)
        telem_fn, flow_fn = make_telem_fn(), make_flow_fn()

        def one_window(s, wstart, wend):
            return step_window(
                s, EngineStats.create(device=dev), step, wend,
                cfg.emit_capacity, s.net.lane_id, bulk_fn=bulk_fn,
                telem_fn=telem_fn, wstart=wstart, sparse_lanes=sparse,
                fault_fn=fault_fn, flow_fn=flow_fn,
                sentinel_fn=make_sentinel_fn(None))
        return one_window
    example = (sim, 0, plan.min_jump)
    one_window = serve.maybe_warm(factory, key, enabled=warm, store=store,
                                  meta=meta, info=compile_info)
    return None, one_window, key, factory, example


def prewarm_dispatch(bundle, app_handlers=(), *, end_time=None, sim=None,
                     mesh=None, mesh_axis: str = "hosts",
                     exchange_capacity=None, windows_per_dispatch=None,
                     adaptive_jump=None, store=None, device=None) -> dict:
    """Resolve (or confirm already stored) the exact dispatch program
    run_windows would use for this bundle, WITHOUT running a single
    window — the engine behind compile.serve.prewarm. Returns the
    compile-info block ({key, hit, compile_s|load_s})."""
    from shadow_tpu_torch.compile.store import default_store
    from shadow_tpu_torch.net.build import _caps_meta

    sim = sim if sim is not None else bundle.sim
    plan = _resolve_loop(bundle, app_handlers, end_time=end_time,
                         fault_fn=None, mesh=mesh, mesh_axis=mesh_axis,
                         windows_per_dispatch=windows_per_dispatch,
                         adaptive_jump=adaptive_jump, sim=sim,
                         device=device)
    if mesh is not None:
        from shadow_tpu_torch.parallel.shard import shard_sim

        sim_ex = shard_sim(sim, mesh)
    else:
        sim_ex = sim
    _, _, key, factory, example = _make_dispatch_fns(
        bundle, plan, sim, app_handlers, mesh=mesh, mesh_axis=mesh_axis,
        exchange_capacity=exchange_capacity, warm=False, store=store,
        compile_info={})
    st = store if store is not None else default_store()
    _, info = st.get_or_compile(key, factory, (sim_ex,) + example[1:],
                                meta=_caps_meta(plan.caps))
    return info


def run_windows(bundle, app_handlers=(), *, end_time: int | None = None,
                start_time: int = 0, sim=None,
                checkpoint_every_ns: int | None = None,
                checkpoint_path: str | None = None,
                on_window=None, on_round=None, on_chunk=None,
                stats0=None, windows_per_dispatch: int | None = None,
                adaptive_jump: bool | None = None, device=None,
                mesh=None, feeder=None, warm_start=None,
                compile_info=None, dispatch_wrap=None, fault_fn=None,
                mesh_axis: str = "hosts",
                exchange_capacity: int | None = None):
    """Host-driven window loop with optional periodic snapshots — the
    checkpointing twin of engine.run (same advance rule,
    master.c:450-480). Returns (sim, stats, checkpoints), checkpoints
    listing the saved (path, time_ns).

    `windows_per_dispatch` K (default cfg.windows_per_dispatch, 1):
    at 1 the loop runs one step_window per round; at K > 1 (or with
    `adaptive_jump`, default cfg.adaptive_jump, or on a Sim carrying
    causality, whose advance attribution lives in the chunk body's
    explain path) it runs engine.make_chunk_body chunks of K windows,
    and hooks and snapshot cadences snap to chunk boundaries. The flow
    recorder (telemetry/flows.py) rides every path. Snapshots are written as
    f"{checkpoint_path}.{time_ns}.npz" once the next window start
    reaches each multiple of `checkpoint_every_ns` past `start_time`.

    `on_window(sim, wend)` runs after every dispatch; `on_chunk(sim,
    stats, wstart, wend, next_min)` also sees the dispatch's stats and
    times and may raise to abort the loop (`on_round` is its name at
    K = 1, called only when on_chunk is not given). `stats0` seeds the
    running totals (resume chains). The bundle's bulk pass
    (``bundle.app_bulk``, when set) rides every path, and so does its
    installed fault plan unless an explicit `fault_fn` replaces it; a
    specialized bundle (compile/specialize.py) runs its trimmed
    program, and refuses an explicit `fault_fn`. The
    caller's sim is left as it was. `device` None is "cuda"
    (make_runner's rules).

    `feeder` (inject.Feeder) streams an open-system injection trace
    into the sim's staging buffer (docs/9-injection.md). On entry
    feeder.sync(sim) reconciles against the (possibly restored)
    staging state — a resume replays nothing and drops nothing — then
    every dispatch boundary prunes merged entries and stages fresh
    ones. The staging horizon bounds every window, so streamed runs
    equal fully-staged ones. A trace whose same-timestamp burst
    outgrows the lanes stalls with a RuntimeError naming the knob.

    `mesh` (parallel.shard.Mesh, this rank's) runs the same loop on
    every rank over the mesh (parallel.shard.make_sharded_window /
    make_sharded_chunk over `mesh_axis`, `exchange_capacity` per peer):
    the state stays sharded between dispatches, and the hooks, the
    snapshots and the result see the global Sim, gathered at the
    boundary when one of them needs it. Snapshots hold the global
    layout (meta `shards` records the width), so one taken on S ranks
    resumes on any other count; rank 0 alone writes them, and every
    rank waits for the write. `device` must then be None or the mesh's.

    A Sim carrying the integrity sentinel (parallel/elastic.py) runs it
    at every window barrier (the identity digest serially, the gathered
    comparison on a mesh), and each snapshot then carries the
    verified-state ledger stamp (elastic_meta at the run's width).
    `dispatch_wrap(fn) -> fn` wraps every dispatch the loop issues (the
    window or chunk callable): the supervisor's device-loss guard and
    chaos poison (parallel/elastic.py guard_dispatch,
    make_poisoned_dispatch).

    `warm_start` asks for the dispatch program from the persistent
    program store (compile/) instead of building it inline: a stored
    program for this shape loads its native libraries from the store
    (no nvcc, no g++). SHADOW_WARM_PROGRAMS=1/0 overrides the caller's
    choice; a store miss builds and persists for the next run; a store
    failure serves the live program (compile/serve.py). `compile_info`,
    when given, is filled with the manifest `compile` block ({key, warm,
    hit, load_s|lower_s/compile_s}) at the first dispatch — the
    supervisor threads it into the run manifest. An opaque caller
    `fault_fn` disables warm serving (its constants cannot be keyed)."""
    from shadow_tpu_torch.compile import serve as _serve
    from shadow_tpu_torch.core import simtime
    from shadow_tpu_torch.core.engine import EngineStats, _next_record
    from shadow_tpu_torch.net.build import _check_sim_device, plan_times

    plan = _resolve_loop(bundle, app_handlers, end_time=end_time,
                         fault_fn=fault_fn, mesh=mesh, mesh_axis=mesh_axis,
                         windows_per_dispatch=windows_per_dispatch,
                         adaptive_jump=adaptive_jump, sim=sim, device=device)
    dev, end, min_jump = plan.device, plan.end, plan.min_jump
    # the record-time wend clamp of make_wend_fn
    records = plan_times(bundle)
    sim = sim if sim is not None else bundle.sim
    _check_sim_device(sim, dev)
    hook = on_chunk if on_chunk is not None else on_round
    total = stats0 if stats0 is not None else EngineStats.create(device=dev)
    saved = []
    shards = 1 if mesh is None else mesh.size
    watched = (on_window is not None or hook is not None)

    def view(s, snapshot_due=False):
        """The global Sim the hooks and snapshots see (gathered over the
        mesh only when one of them runs)."""
        if mesh is None or not (watched or snapshot_due):
            return s
        from shadow_tpu_torch.parallel.shard import unshard_sim

        return unshard_sim(s, mesh)

    def snapshot(g, t):
        """Write `g` (global) as the snapshot at t: rank 0 writes, every
        rank waits for the file. A sentinel-carrying run stamps the
        verified-state ledger (the opt-in that funds the digests)."""
        path = f"{checkpoint_path}.{t}.npz"
        if mesh is None or mesh.rank == 0:
            stamp = (None if getattr(g, "sentinel", None) is None
                     else elastic_meta(g, shards))
            save(path, g, time_ns=t, shards=shards, elastic=stamp)
        if mesh is not None:
            mesh.barrier()
        saved.append((path, t))
    next_ckpt = (start_time + checkpoint_every_ns
                 if checkpoint_every_ns else None)
    wstart = max(int(sim.events.min_time().amin()), start_time)
    if feeder is not None:
        if getattr(sim, "inject", None) is None:
            raise ValueError(
                "run_windows(feeder=...) needs a sim with injection "
                "staging attached (NetConfig.inject_lanes > 0 or "
                "inject.attach)")
        # reconcile against (possibly restored) staging state, then
        # stage the first batch; staged events join the first-window
        # rule so a trace-only run (empty queue) still starts
        feeder.sync(sim)
        sim = feeder.refill(sim)
        wstart = max(min(int(sim.events.min_time().amin()),
                         feeder.pending_min()), start_time)

    def _stall_msg(t):
        return (f"injection stalled at t={t}: all {sim.inject.lanes} "
                f"staging lanes hold events at one timestamp and more "
                f"remain in the trace — raise --inject-lanes (or "
                f"NetConfig.inject_lanes) past the largest "
                f"same-timestamp burst")

    warm = _serve.warm_enabled(default=bool(warm_start))
    chunk, one_window, _, _, _ = _make_dispatch_fns(
        bundle, plan, sim, app_handlers, mesh=mesh, mesh_axis=mesh_axis,
        exchange_capacity=exchange_capacity, warm=warm,
        compile_info=compile_info)
    if dispatch_wrap is not None:
        # device-loss guard / chaos poison (parallel/elastic.py): the
        # wrap sees every dispatch the loop issues
        if chunk is not None:
            chunk = dispatch_wrap(chunk)
        if one_window is not None:
            one_window = dispatch_wrap(one_window)
    if mesh is not None:
        from shadow_tpu_torch.parallel.shard import shard_sim

        # the rank's shard; the input stays as it was
        sim = shard_sim(sim, mesh)

    if chunk is not None:
        if feeder is not None and wstart <= end:
            # streaming: each refill must land in the staging planes
            # before the next chunk reads them; the plain loop below
            # takes the closed-loop tail once the trace is staged and
            # merged
            prev_state = (None, None)
            while not feeder.done:
                sim, cstats, cnext = chunk(
                    sim, EngineStats.create(device=dev), wstart)
                # the chunk's next start only sees the queue and the
                # STAGED events; an unstaged trace event below it pulls
                # the next window start back (read before the refill
                # moves the horizon)
                nm = min(int(cnext), feeder.horizon)
                total = total.add(cstats)
                wend_c = min(nm, end + 1)
                due = (next_ckpt is not None and checkpoint_path is not None
                       and next_ckpt <= nm <= end)
                g = view(sim, due)
                if due:
                    snapshot(g, nm)
                    while next_ckpt <= nm:
                        next_ckpt += checkpoint_every_ns
                if on_window is not None:
                    on_window(g, wend_c)
                if hook is not None:
                    hook(g, cstats, wstart, wend_c, nm)
                sim = feeder.refill(sim, nm)
                if nm >= simtime.INVALID:
                    # quiet queue: jump to the next staged event
                    nm = feeder.pending_min()
                if nm > end or nm >= simtime.INVALID:
                    return view(sim, True), total, saved
                if not feeder.done and feeder.horizon <= nm:
                    raise RuntimeError(_stall_msg(nm))
                if (nm, feeder.cursor) == prev_state:
                    raise RuntimeError(_stall_msg(nm))
                prev_state = (nm, feeder.cursor)
                wstart = nm
        while wstart <= end:
            sim, cstats, nm = chunk(sim, EngineStats.create(device=dev),
                                    wstart)
            total = total.add(cstats)
            wend_c = min(nm, end + 1)
            due = (next_ckpt is not None and checkpoint_path is not None
                   and next_ckpt <= nm <= end)
            g = view(sim, due)
            if due:
                snapshot(g, nm)
                while next_ckpt <= nm:
                    next_ckpt += checkpoint_every_ns
            if on_window is not None:
                on_window(g, wend_c)
            if hook is not None:
                hook(g, cstats, wstart, wend_c, nm)
            wstart = nm
        return view(sim, True), total, saved

    while wstart <= end:
        if (next_ckpt is not None and wstart >= next_ckpt
                and checkpoint_path is not None):
            snapshot(view(sim, True), wstart)
            next_ckpt += checkpoint_every_ns
        wend = min(wstart + min_jump, end + 1,
                   _next_record(records, wstart))
        if feeder is not None:
            # prune merged (everything < this window's start), stage
            # fresh events, and keep the window inside the horizon
            sim = feeder.refill(sim, wstart)
            wend = min(wend, feeder.horizon)
            if wend <= wstart:
                raise RuntimeError(_stall_msg(wstart))
        sim, stats, nm = one_window(sim, wstart, wend)
        total = total.add(stats)
        if feeder is not None:
            # the chunked loop's horizon rule: the first unstaged trace
            # event bounds the next window start
            nm = min(nm, feeder.horizon)
        g = view(sim)
        if on_window is not None:
            on_window(g, wend)
        if hook is not None:
            hook(g, stats, wstart, wend, nm)
        if nm >= simtime.INVALID:
            if feeder is not None and not feeder.done:
                # queue and staging both drained, but the trace still
                # holds events: stage the next batch and jump there
                sim = feeder.refill(sim, nm)
                nm = feeder.pending_min()
                if nm < simtime.INVALID:
                    wstart = nm
                    continue
            break
        wstart = nm
    return view(sim, True), total, saved
