"""Elastic degraded-mesh recovery (PyTorch port of
shadow_tpu/parallel/elastic.py): device-loss detection, the cross-shard
integrity sentinel, and shrink-to-survivors planning.

A sharded run would otherwise be pinned to the mesh it launched on: one
lost rank (a dead card, a killed process, an aborted communicator) or
one rank silently corrupting its replica of the replicated tables would
end or poison the run. Results are bit-identical for any shard count
and snapshots hold the GLOBAL layout, so a loss should cost a resume,
not a run. This module owns the three mechanisms:

1. **Device-loss classification** (`DeviceLossError`, `classify`,
   `guard_dispatch`): the reference's XLA markers, verbatim, plus the
   messages torch.distributed raises when a peer is gone — gloo's
   closed or reset connection, NCCL's communicator abort, the
   watchdog's collective timeout, and `DistBackendError` itself. A
   CUDA program fault (an illegal address) is a bug, not a lost
   device, and stays unclassified.

2. **The cross-shard integrity sentinel** (`SentinelState`,
   `attach_sentinel`, `make_sentinel_fn`): at every window barrier,
   after the route and the lane barrier, each rank folds the replicated
   leaves it carries into one u32 digest; ONE all_gather of the [size]
   digests gives every rank the same max, min, counts and offender
   (the reference's pmax, pmin, two psums and pmin). A disagreement
   latches a sticky SHARD_DIVERGENCE trip naming the suspect shard.
   `Sim.sentinel` None runs no op at all. The digest is a leaf and
   lands in checkpoints, so it equals the reference's bit for bit: the
   u32 words are carried in int64 masked to 32 bits.

3. **Shrink planning** (`next_pow2_down`, `survivor_mesh`,
   `shard_digests`): the reference builds a new Mesh over the
   surviving devices of one process. The port has one process a rank
   and a process group cannot drop a member in place, so the survivors
   meet again at a rendezvous that outlives any rank (`Rendezvous`, a
   file store per mesh generation beside the run's checkpoints), and
   the first next_pow2_down(live) of them, in old-rank order, form the
   new group (`survivor_mesh`); the rest retire.

The degradation ladder itself — retry the same mesh, shrink to
survivors, fall back to serial, always from the last VERIFIED
checkpoint — lives in faults/supervisor.py (`ElasticPolicy` here is its
knob block).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from shadow_tpu_torch.core.events import _Replace

I32 = torch.int32
I64 = torch.int64
_M32 = 0xFFFFFFFF

# ---------------------------------------------------------------------
# device-loss classification
# ---------------------------------------------------------------------

# The reference's markers (XLA/PJRT runtimes), verbatim, so every string
# it classifies is classified the same way; then the ones
# torch.distributed raises when a peer process or its card is gone.
# Deliberately broad: a false DEVICE_LOST costs one ladder step from a
# verified checkpoint; a missed one costs the run.
_LOSS_MARKERS = (
    "device_lost",
    "device lost",
    "device is lost",
    "device halted",
    "device unavailable",
    "failed to transfer",
    "transfer to device",
    "transfer from device",
    "data transfer failed",
    "device to host copy",
    "unable to enqueue",
    "failed to enqueue",
    "device failure",
    "chip unreachable",
    "ici link",
    "slice has been terminated",
    "core halted",
)
_TORCH_LOSS_MARKERS = (
    # gloo: the peer process died (its sockets closed or reset)
    "connection closed by peer",
    "connection reset by peer",
    "broken pipe",
    # NCCL: the communicator was aborted (a peer failed, or the
    # watchdog tore it down)
    "communicator was aborted",
    "nccl communicator was aborted",
    "ncclremoteerror",
    # the watchdog's collective timeout, and gloo's own (a peer that
    # stopped answering within the group's timeout)
    "watchdog caught collective operation timeout",
    "collective operation timeout",
    "timed out in call to",
    "timed out waiting",
)


class DeviceLossError(RuntimeError):
    """A dispatch failed (or overran its deadline) because the machine
    underneath lost a device or a rank — NOT a simulation fault.
    Carries the failed shard index (-1 = unknown) and device repr for
    the health report and the elastic block."""

    def __init__(self, message: str, *, shard: int = -1,
                 device: str | None = None, cause: str = "xla_error"):
        super().__init__(message)
        self.shard = int(shard)
        self.device = device
        self.cause = cause

    def as_dict(self) -> dict:
        return {"fault": "DEVICE_LOST", "shard": self.shard,
                "device": self.device, "cause": self.cause,
                "message": str(self)}


def _is_dist_backend_error(exc: BaseException) -> bool:
    """torch.distributed.DistBackendError (and its subclasses), looked
    up without importing torch.distributed where it is absent."""
    dist = getattr(torch, "distributed", None)
    cls = getattr(dist, "DistBackendError", None) if dist else None
    return cls is not None and isinstance(exc, cls)


def classify(exc: BaseException, *, shards: int = 1,
             elapsed_s: float | None = None,
             deadline_s: float | None = None) -> DeviceLossError | None:
    """Map an exception raised by (or a deadline measured around) a
    device dispatch to a DeviceLossError, or None when it is an
    ordinary error that should propagate as-is. The failed shard is
    parsed from the message when it names a device ordinal; -1
    (unknown) still drives the ladder — shrink decisions only need
    *that* a shard died, identity is for the report."""
    if isinstance(exc, DeviceLossError):
        return exc
    msg = str(exc).lower()
    hit = any(m in msg for m in _LOSS_MARKERS)
    cause = "xla_error"
    if not hit and (_is_dist_backend_error(exc)
                    or any(m in msg for m in _TORCH_LOSS_MARKERS)):
        hit, cause = True, "collective_error"
    if not hit and deadline_s is not None and elapsed_s is not None \
            and elapsed_s > deadline_s:
        return DeviceLossError(
            f"dispatch exceeded deadline ({elapsed_s:.1f}s > "
            f"{deadline_s:.1f}s): {exc}", cause="dispatch_deadline")
    if not hit:
        return None
    shard = -1
    for tok in ("device ordinal ", "device id ", "tpu_", "device "):
        i = msg.find(tok)
        if i >= 0:
            tail = msg[i + len(tok):]
            digits = ""
            for ch in tail:
                if ch.isdigit():
                    digits += ch
                else:
                    break
            if digits and int(digits) < max(shards, 1):
                shard = int(digits)
                break
    return DeviceLossError(str(exc), shard=shard, cause=cause)


def guard_dispatch(fn, *, shards: int = 1,
                   deadline_s: float | None = None):
    """Wrap a dispatch callable (the chunk/window fn run_windows
    drives): errors matching the loss markers re-raise as
    DeviceLossError, and a call that overran `deadline_s` raises one
    too (measured around the call, whose host reads block on the
    device). Ordinary errors propagate untouched."""
    def guarded(*args, **kwargs):
        t0 = time.monotonic()
        try:
            return fn(*args, **kwargs)
        except DeviceLossError:
            raise
        except Exception as e:           # noqa: BLE001 — classify-all
            loss = classify(e, shards=shards,
                            elapsed_s=time.monotonic() - t0,
                            deadline_s=deadline_s)
            if loss is not None:
                raise loss from e
            raise
    return guarded


def make_poisoned_dispatch(at_call, *, shard: int = 0,
                           message: str | None = None):
    """A dispatch_wrap that injects device losses: the dispatch counter
    (shared across supervisor attempts — the wrap is re-applied per
    attempt but the counter persists) raises a DEVICE_LOST-shaped
    RuntimeError at each call index in `at_call` (int or collection),
    so the full classify path is exercised. Consecutive indices take
    the ladder past same-mesh retry into shrink territory. On a mesh
    every rank counts the same dispatches and raises at the same call,
    so all ranks take the same rung without talking."""
    kills = {int(at_call)} if isinstance(at_call, int) \
        else {int(c) for c in at_call}
    state = {"n": 0}

    def wrap(fn):
        def poisoned(*args, **kwargs):
            n = state["n"]
            state["n"] = n + 1
            if n in kills:
                raise RuntimeError(
                    message or f"INTERNAL: DEVICE_LOST: device ordinal "
                    f"{shard} halted mid-dispatch (injected)")
            return fn(*args, **kwargs)
        return poisoned
    return wrap


# ---------------------------------------------------------------------
# cross-shard integrity sentinel
# ---------------------------------------------------------------------

@dataclass
class SentinelState(_Replace):
    """Sticky divergence latch — every leaf is a REPLICATED scalar (each
    update below is a pure function of the gathered digests), so the
    whole subtree is pinned at the dispatch boundary
    (parallel/shard.py _replicate_scalars), never delta-summed."""

    checks: torch.Tensor            # [] i64 barrier comparisons performed
    trip: torch.Tensor              # [] i32 sticky mismatch count
    shard: torch.Tensor             # [] i32 offending shard of FIRST trip
    tripped_at: torch.Tensor        # [] i64 wend of first trip (0 before)
    verified_through: torch.Tensor  # [] i64 last wend verified clean
    digest: torch.Tensor            # [] u32 (int64) last barrier digest

    @staticmethod
    def create(device=None) -> "SentinelState":
        def z(dt, v=0):
            return torch.full((), v, dtype=dt, device=device)
        return SentinelState(checks=z(I64), trip=z(I32), shard=z(I32, -1),
                             tripped_at=z(I64), verified_through=z(I64),
                             digest=z(I64))


def attach_sentinel(sim):
    """Return `sim` with the integrity sentinel attached (no-op if one
    already is), on the sim's device. Sim.sentinel defaults to None and
    contributes no leaf, so sentinel-off snapshots and programs are
    unchanged."""
    if getattr(sim, "sentinel", None) is not None:
        return sim
    return sim.replace(
        sentinel=SentinelState.create(device=sim.events.time.device))


_GOLDEN = 2654435761      # Knuth multiplicative hash
_PRIME = 16777619         # FNV prime
_BASIS = 0x811C9DC5       # FNV offset basis


def _mul32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(x * w) mod 2^32 for u32 words held in int64, without ever
    overflowing the int64: x splits into 16-bit halves."""
    lo = (x & 0xFFFF) * w
    hi = (((x >> 16) * w) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fold_u32(acc: int | torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The reference's fold: a position-weighted wraparound sum of the
    u32 words (so permutations change the digest), mixed
    multiplicatively with the running digest."""
    n = x.numel()
    w = (torch.arange(n, dtype=I64, device=x.device) * _GOLDEN + 1) & _M32
    s = _mul32(x.reshape(-1), w).sum() & _M32
    return (((acc * _PRIME) & _M32) ^ ((s + acc) & _M32)) & _M32


def _ref_dtype(path: str, leaf: torch.Tensor) -> np.dtype:
    from shadow_tpu_torch.convert import numpy_dtype

    return numpy_dtype(path, leaf)


def _leaf_u32(leaf: torch.Tensor, ref_dtype: np.dtype) -> list:
    """A leaf's bits as u32 words in int64, split as the reference
    splits its dtype: bool and 4-byte leaves one word, float32 bit-cast,
    8-byte leaves lo then hi word (a logical shift)."""
    if leaf.dtype == torch.bool:
        return [leaf.to(I64)]
    if leaf.dtype.is_floating_point:
        return [leaf.to(torch.float32).view(torch.int32).to(I64) & _M32]
    x = leaf.to(I64)
    if ref_dtype.itemsize == 8:
        return [x & _M32, (x >> 32) & _M32]
    return [x & _M32]


def _replicated_digest_leaves(sim) -> list:
    """[(flax path, tensor)] the per-barrier digest covers: the
    replicated lookup tables (sorted REPLICATED_FIELDS without the
    per-shard-delta path matrix), the injection cursors and the
    causality advance count — exactly the reference's list and
    order. The rings are write-only observability buffers and are not
    covered."""
    from shadow_tpu_torch.net.state import REPLICATED_FIELDS

    out = []
    net = getattr(sim, "net", None)
    if net is not None:
        for name in sorted(REPLICATED_FIELDS):
            if name == "ctr_path_packets":
                continue  # per-shard scatter-add deltas mid-chunk
            out.append((f".net.{name}", getattr(net, name)))
    inject = getattr(sim, "inject", None)
    if inject is not None:
        out.extend([(".inject.seq_floor", inject.seq_floor),
                    (".inject.horizon", inject.horizon)])
    caus = getattr(sim, "causality", None)
    if caus is not None:
        out.append((".causality.adv_count", caus.adv_count))
    return out


def digest_replicated(sim, wend) -> torch.Tensor:
    """[] int64: one u32 digest over the replicated-at-barrier leaves
    and wend, on the sim's device (no host read). All words concatenate
    into one flat vector folded by one position-weighted reduce from
    the FNV basis, as in the reference."""
    dev = sim.events.time.device
    w64 = torch.as_tensor(int(wend), dtype=I64, device=dev)
    words = [w.reshape(-1) for w in _leaf_u32(w64, np.dtype(np.int64))]
    for path, leaf in _replicated_digest_leaves(sim):
        for w in _leaf_u32(leaf, _ref_dtype(path, leaf)):
            words.append(w.reshape(-1))
    flat = torch.cat(words) if len(words) > 1 else words[0]
    return _fold_u32(_BASIS, flat)


def offender_of(digests) -> tuple:
    """(dmax, dmin, offender) over the ranks' digests (a [size] list or
    tensor), the reference's rule from its five collectives: suspects
    are the holders of the minority digest — ties blame the holders of
    the max — and the offender is the lowest suspect rank (`size` when
    none is suspect)."""
    d = [int(v) for v in (digests.tolist() if torch.is_tensor(digests)
                          else digests)]
    n = len(d)
    dmax, dmin = max(d), min(d)
    n_max = sum(v == dmax for v in d)
    minority_is_max = n_max * 2 <= n
    suspects = [i for i, v in enumerate(d)
                if (v == dmax if minority_is_max else v != dmax)]
    return dmax, dmin, (min(suspects) if suspects else n)


def make_sentinel_fn(mesh=None):
    """The engine's sentinel_fn(sim, wend) -> sim barrier hook
    (core/engine.step_window runs it after the route and the lane
    barrier). `mesh` None is the single-shard identity: the digest is
    still computed and `verified_through` still advances (serial runs
    get the same verified-state ledger), on the device with no host
    read, and it can never trip. On a mesh of more than one rank ONE
    all_gather of the [size] digests gives every rank the same max,
    min and offender (`offender_of`), so the new state is identical on
    every rank.

    When sim.sentinel is None the hook does nothing."""

    def sentinel_fn(sim, wend):
        st = getattr(sim, "sentinel", None)
        if st is None:
            return sim
        d = digest_replicated(sim, wend)
        dev = d.device
        wend64 = torch.as_tensor(int(wend), dtype=I64, device=dev)
        if mesh is None or mesh.size == 1:
            dmax = d
            mismatch = torch.zeros((), dtype=torch.bool, device=dev)
            offender = torch.full((), -1, dtype=I32, device=dev)
        else:
            dm, dn, off = offender_of(mesh.all_gather(d.reshape(1)))
            dmax = torch.as_tensor(dm, dtype=I64, device=dev)
            mismatch = torch.as_tensor(dm != dn, device=dev)
            offender = torch.as_tensor(off, dtype=I32, device=dev)
        first = mismatch & (st.trip == 0)
        trip = st.trip + mismatch.to(I32)
        return sim.replace(sentinel=st.replace(
            checks=st.checks + 1,
            trip=trip,
            shard=torch.where(first, offender, st.shard),
            tripped_at=torch.where(first, wend64, st.tripped_at),
            # a barrier only extends the verified prefix while the latch
            # is clean — everything after a trip is suspect
            verified_through=torch.where(trip == 0, wend64,
                                         st.verified_through),
            digest=dmax))

    return sentinel_fn


def make_divergence_fault_fn(mesh, *, shard: int, at_ns: int, inner=None):
    """TEST/CHAOS helper: a fault_fn that corrupts ONE rank's replica of
    a replicated table (latency_ns[0, 0] += 1) from `at_ns` on — the
    software stand-in for a replicated-memory bit flip. It acts on the
    rank `shard` of `mesh` only (the mesh the run started on; a rank
    that later runs the serial rung keeps its identity). Composes over
    an existing fault_fn via `inner`."""
    victim = mesh is not None and mesh.rank == int(shard)

    def fault_fn(sim, wend):
        if inner is not None:
            sim = inner(sim, wend)
        if not victim or int(wend) < int(at_ns):
            return sim
        lat = sim.net.latency_ns.clone()
        lat[0, 0] += 1
        return sim.replace(net=sim.net.replace(latency_ns=lat))
    return fault_fn


# ---------------------------------------------------------------------
# shrink planning
# ---------------------------------------------------------------------

def next_pow2_down(n: int) -> int:
    """Largest power of two <= n (>= 1)."""
    if n < 1:
        raise ValueError(f"no pow2 <= {n}")
    return 1 << (int(n).bit_length() - 1)


def survivor_ranks(size: int, lost_shard: int, live=None) -> list:
    """The old ranks that form the shrunk mesh, in old-rank order: the
    `live` ranks (default all of range(size)) less `lost_shard` (-1 =
    unknown: the last live rank drops when every rank is alive — any
    pow2-down subset works, the layout is global), cut to the first
    next_pow2_down of them. A list of one means a serial run."""
    size = int(size)
    live = sorted(range(size) if live is None else {int(r) for r in live})
    if 0 <= lost_shard < size:
        drop = int(lost_shard)
    elif len(live) == size:
        drop = live[-1]
    else:
        drop = None          # the dead rank is already missing
    survivors = [r for r in live if r != drop]
    return survivors[:next_pow2_down(max(len(survivors), 1))]


def survivor_mesh(mesh, axis: str, lost_shard: int, *, live=None,
                  rendezvous=None):
    """The next-pow2-down mesh over the ranks that survive losing
    `lost_shard` (the reference's survivor_mesh). Returns (new_mesh,
    new_shards), or (None, 1) when the survivors can only carry a
    serial run — the rank that carries it is survivor_ranks(...)[0].

    `mesh` is this rank's parallel.shard.Mesh, already torn down
    (Mesh.abort); `live` the old ranks the rendezvous found alive. With
    a `rendezvous` (Rendezvous) the survivors join a new process group
    there; a rank outside the survivors gets (None, 0): it retires.
    Without one, `new_mesh` is the plan itself: the survivors' old
    ranks in new-rank order."""
    if axis != mesh.axis:
        raise ValueError(f"axis {axis!r} is not the mesh's {mesh.axis!r}")
    ranks = survivor_ranks(mesh.size, lost_shard, live)
    if len(ranks) < 2:
        return None, 1
    if rendezvous is None:
        return ranks, len(ranks)
    if mesh.rank not in ranks:
        return None, 0
    from shadow_tpu_torch.parallel.shard import Mesh

    new = Mesh(len(ranks), ranks.index(mesh.rank),
               init_method=rendezvous.group_init(), device=mesh.device,
               axis=mesh.axis, timeout_s=mesh.timeout_s)
    return new, len(ranks)


def _pid_alive(pid: int) -> bool:
    """A process that exists and is not a zombie (reads /proc)."""
    try:
        os.kill(int(pid), 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    try:
        with open(f"/proc/{int(pid)}/stat") as f:
            return f.read().rsplit(")", 1)[-1].split()[0] != "Z"
    except OSError:
        return True


class Rendezvous:
    """Where the ranks of a mesh meet again after a loss: a
    torch.distributed FileStore per mesh generation beside the run's
    checkpoints (`prefix` = checkpoint_path + run id), so it outlives
    any rank. Generation g's live ranks register; the membership is
    sealed once every old rank has registered, declared itself out, or
    is a dead process (the ranks of a mesh share one machine), or at
    `deadline_s` after the first registration, whichever is first; the
    first seal wins, so every rank reads the same membership. A rank
    that registers after the seal is outside it and retires."""

    def __init__(self, prefix: str, generation: int, size: int, *,
                 deadline_s: float):
        self.prefix, self.gen = prefix, int(generation)
        self.size, self.deadline_s = int(size), float(deadline_s)

    def _store(self, world: int = -1):
        import torch.distributed as dist

        return dist.FileStore(f"{self.prefix}.gen{self.gen}.store", world)

    def group_init(self) -> str:
        return "file://" + os.path.abspath(
            f"{self.prefix}.gen{self.gen}.group")

    @staticmethod
    def clear(prefix: str) -> None:
        """Remove a former run's rendezvous files under `prefix`."""
        import glob

        for f in glob.glob(glob.escape(prefix) + ".gen*"):
            try:
                os.unlink(f)
            except OSError:
                pass

    @staticmethod
    def publish_pids(prefix: str, rank: int) -> None:
        """Record this rank's pid (generation 0), so survivors can tell
        a dead rank from a slow one."""
        Rendezvous(prefix, 0, 1, deadline_s=0)._store().set(
            f"pid/{int(rank)}", str(os.getpid()))

    def _pids(self) -> dict:
        st = Rendezvous(self.prefix, 0, 1, deadline_s=0)._store()
        out = {}
        for r in range(self.size):
            k = f"pid/{r}"
            if st.check([k]):
                out[r] = int(st.get(k))
        return out

    def meet(self, rank: int, *, join: bool = True) -> list:
        """Register old rank `rank` (or, with join=False, declare it
        out) and return the sealed membership: the sorted old ranks that
        registered in time."""
        st = self._store()
        st.set(f"{'live' if join else 'out'}/{int(rank)}", "1")
        if st.add("arrivals", 1) == 1:
            st.set("deadline", repr(time.time() + self.deadline_s))
        st.wait(["deadline"])
        deadline = float(st.get("deadline"))
        pids = self._pids()
        while True:
            live = [r for r in range(self.size) if st.check([f"live/{r}"])]
            done = [r for r in range(self.size)
                    if r in live or st.check([f"out/{r}"])
                    or (r in pids and not _pid_alive(pids[r]))]
            if len(done) == self.size or time.time() >= deadline:
                break
            time.sleep(0.02)
        st.compare_set("sealed", "", ",".join(map(str, live)))
        sealed = st.get("sealed").decode()
        return [int(r) for r in sealed.split(",") if r]


def shard_digests(sim, shards: int, axis: str = "hosts") -> list:
    """Host-side per-shard sha256 over the snapshot's leaves, split the
    way sim_specs shards them: leading-H leaves contribute shard s's
    row block to digest s; replicated leaves contribute whole to every
    shard's digest. Each leaf is hashed under its flax path name and as
    the reference's dtype (convert.sim_to_numpy), in the reference's
    flatten order, so the digests equal the reference's for the same
    state — the verified-state ledger's integrity stamp
    (utils/checkpoint.py)."""
    from shadow_tpu_torch.convert import sim_to_numpy
    from shadow_tpu_torch.parallel.shard import sim_specs

    shards = max(int(shards), 1)
    hashes = [hashlib.sha256() for _ in range(shards)]
    specs = sim_specs(sim, axis)
    for path, arr in sim_to_numpy(sim).items():
        name = path.encode()
        sharded = (specs[path] is not None and arr.ndim > 0
                   and arr.shape[0] % shards == 0)
        if sharded:
            per = arr.shape[0] // shards
            for s in range(shards):
                hashes[s].update(name)
                hashes[s].update(
                    np.ascontiguousarray(arr[s * per:(s + 1) * per])
                    .tobytes())
        else:
            blob = np.ascontiguousarray(arr).tobytes()
            for h in hashes:
                h.update(name)
                h.update(blob)
    return [h.hexdigest() for h in hashes]


# ---------------------------------------------------------------------
# the supervisor's ladder knobs
# ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ElasticPolicy:
    """Knobs for the device-loss degradation ladder
    (faults/supervisor.py): retry same mesh → shrink to survivors →
    serial fallback, resuming from the last VERIFIED checkpoint.
    Ladder steps do NOT burn the failure retry budget (like escalation
    heals: the sim did nothing wrong)."""

    same_mesh_retries: int = 1       # re-dispatch on the full mesh first
    allow_shrink: bool = True        # next-pow2-down onto survivors
    allow_serial: bool = True        # final rung: mesh=None
    min_shards: int = 1              # stop shrinking below this
    max_losses: int = 8              # total DEVICE_LOST budget per run
    dispatch_deadline_s: float | None = None  # hung-dispatch overrun

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def sentinel_report(sim) -> dict | None:
    """Host-side summary of the sentinel latch for manifests and
    health. None when the sentinel is not attached."""
    st = getattr(sim, "sentinel", None)
    if st is None:
        return None
    return {
        "checks": int(st.checks),
        "trips": int(st.trip),
        "shard": int(st.shard),
        "tripped_at_ns": int(st.tripped_at),
        "verified_through_ns": int(st.verified_through),
        "digest": int(st.digest),
    }
