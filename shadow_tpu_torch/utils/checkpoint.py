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

Not ported yet (ROADMAP.md): elastic_meta (the sentinel, item 9),
replan_shards (parallel/, item 9), prewarm_dispatch (compile/, item
11), and run_windows' mesh, warm_start, compile_info and dispatch_wrap
arguments, which raise NotImplementedError.
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


def _npz_path(path: str) -> str:
    # np.savez appends ".npz" to paths but not to file objects, and the
    # atomic write goes through a file object
    return path if path.endswith(".npz") else path + ".npz"


def save(path: str, sim, *, time_ns: int, extra: dict | None = None,
         shards: int = 1, config_digest: str | None = None) -> str:
    """Snapshot a Sim at a window boundary; `time_ns` is the next window
    start (the resume point). Atomic: the snapshot appears at `path`
    complete or not at all. `shards` and `config_digest` are
    diagnostic metadata. Returns the path written."""
    leaves = convert.sim_to_numpy(sim)
    meta = {"time_ns": int(time_ns), "extra": extra or {},
            "layout": LAYOUT_VERSION, "keys": sorted(leaves),
            "crc32": {k: _crc(v) for k, v in leaves.items()},
            "capacities": capacities_of_sim(sim),
            "shards": int(shards),
            "config_digest": config_digest,
            "torch_version": torch.__version__}
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


def run_windows(bundle, app_handlers=(), *, end_time: int | None = None,
                start_time: int = 0, sim=None,
                checkpoint_every_ns: int | None = None,
                checkpoint_path: str | None = None,
                on_window=None, on_round=None, on_chunk=None,
                stats0=None, windows_per_dispatch: int | None = None,
                adaptive_jump: bool | None = None, device=None,
                mesh=None, feeder=None, warm_start=None,
                compile_info=None, dispatch_wrap=None, fault_fn=None):
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

    `mesh` and `dispatch_wrap` (ROADMAP.md Queue 1 item 9), `warm_start`
    and `compile_info` (item 11b) are not ported yet and raise
    NotImplementedError."""
    from shadow_tpu_torch.core import simtime
    from shadow_tpu_torch.core.engine import (
        EngineStats,
        _next_record,
        make_chunk_body,
        resolve_sparse_lanes,
        step_window,
    )
    from shadow_tpu_torch.net.build import (
        _check_sim_device,
        _resolve_bulk_fn,
        _resolve_caps,
        _resolve_fault_fn,
        _runner_device,
        plan_times,
        refuse_unported,
        resolve_wend_fn,
    )
    from shadow_tpu_torch.net.step import make_step_fn
    from shadow_tpu_torch.telemetry.flows import make_flow_fn
    from shadow_tpu_torch.telemetry.ring import make_telem_fn

    refuse_unported(mesh=(mesh, 9), dispatch_wrap=(dispatch_wrap, 9),
                    warm_start=(warm_start, "11b"),
                    compile_info=(compile_info, "11b"))
    dev = _runner_device(bundle, device)
    cfg = bundle.cfg
    caps = _resolve_caps(bundle, fault_fn)
    step = make_step_fn(cfg, app_handlers, caps=caps)
    end = int(end_time if end_time is not None else cfg.end_time)
    min_jump = max(int(bundle.min_jump), 1)
    bulk_fn = _resolve_bulk_fn(bundle, getattr(bundle, "app_bulk", None),
                               caps=caps)
    fault_fn = _resolve_fault_fn(bundle, fault_fn)
    wpd = (int(windows_per_dispatch) if windows_per_dispatch is not None
           else max(1, int(getattr(cfg, "windows_per_dispatch", 1) or 1)))
    if wpd < 1:
        raise ValueError(f"windows_per_dispatch must be >= 1, got {wpd}")
    adaptive = (bool(adaptive_jump) if adaptive_jump is not None
                else bool(getattr(cfg, "adaptive_jump", False)))
    sparse = resolve_sparse_lanes(cfg)
    telem_fn = make_telem_fn()
    flow_fn = make_flow_fn()
    # the record-time wend clamp of make_wend_fn
    records = plan_times(bundle)
    sim = sim if sim is not None else bundle.sim
    _check_sim_device(sim, dev)
    hook = on_chunk if on_chunk is not None else on_round
    total = stats0 if stats0 is not None else EngineStats.create(device=dev)
    saved = []
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

    if wpd > 1 or adaptive or getattr(sim, "causality", None) is not None:
        chunk = make_chunk_body(
            step, end_time=end,
            wend_fn=resolve_wend_fn(bundle, end, adaptive, fault_fn),
            chunk_windows=wpd, emit_capacity=cfg.emit_capacity,
            lane_fn=lambda s: s.net.lane_id, bulk_fn=bulk_fn,
            telem_fn=telem_fn, sparse_lanes=sparse, fault_fn=fault_fn,
            flow_fn=flow_fn)
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
                if (next_ckpt is not None and checkpoint_path is not None
                        and next_ckpt <= nm <= end):
                    p = save(f"{checkpoint_path}.{nm}.npz", sim,
                             time_ns=nm)
                    saved.append((p, nm))
                    while next_ckpt <= nm:
                        next_ckpt += checkpoint_every_ns
                if on_window is not None:
                    on_window(sim, wend_c)
                if hook is not None:
                    hook(sim, cstats, wstart, wend_c, nm)
                sim = feeder.refill(sim, nm)
                if nm >= simtime.INVALID:
                    # quiet queue: jump to the next staged event
                    nm = feeder.pending_min()
                if nm > end or nm >= simtime.INVALID:
                    return sim, total, saved
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
            if (next_ckpt is not None and checkpoint_path is not None
                    and next_ckpt <= nm <= end):
                p = save(f"{checkpoint_path}.{nm}.npz", sim, time_ns=nm)
                saved.append((p, nm))
                while next_ckpt <= nm:
                    next_ckpt += checkpoint_every_ns
            if on_window is not None:
                on_window(sim, wend_c)
            if hook is not None:
                hook(sim, cstats, wstart, wend_c, nm)
            wstart = nm
        return sim, total, saved

    while wstart <= end:
        if (next_ckpt is not None and wstart >= next_ckpt
                and checkpoint_path is not None):
            p = save(f"{checkpoint_path}.{wstart}.npz", sim, time_ns=wstart)
            saved.append((p, wstart))
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
        sim, stats, nm = step_window(
            sim, EngineStats.create(device=dev), step, wend,
            cfg.emit_capacity, sim.net.lane_id, bulk_fn=bulk_fn,
            telem_fn=telem_fn, wstart=wstart, sparse_lanes=sparse,
            fault_fn=fault_fn, flow_fn=flow_fn)
        total = total.add(stats)
        if feeder is not None:
            # the chunked loop's horizon rule: the first unstaged trace
            # event bounds the next window start
            nm = min(nm, feeder.horizon)
        if on_window is not None:
            on_window(sim, wend)
        if hook is not None:
            hook(sim, stats, wstart, wend, nm)
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
    return sim, total, saved
