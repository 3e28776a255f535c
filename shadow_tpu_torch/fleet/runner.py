"""The fleet supervisor: worker pool + scheduler + watchdog (PyTorch
port of shadow_tpu/fleet/runner.py).

Workers are spawned (never forked: a forked child cannot use its
parent's CUDA context) and each takes its device explicitly from the
fleet: `FleetRunner(device=...)`, "cuda" by default (all workers share
the card), "cpu" when asked. A worker that cannot reach CUDA fails its
jobs visibly; it never moves to the CPU.

One process owns the journal (single writer) and the pool of
spawn-context worker processes; everything else is message folding:

    dispatch: ready job + idle worker -> lease frame -> pipe send
    fold:     running / heartbeat / result messages -> state frames
    watchdog: missed heartbeats past the lease timeout, or a job
              past its wallclock deadline * grace (the supervisor's
              own in-run deadline should fire first — the watchdog
              is the backstop for a hung device call that never
              reaches a round barrier) -> SIGKILL -> worker_lost
    reap:     dead worker processes (killed by us, the OOM killer,
              or a test) -> worker_lost -> requeue from checkpoint

Graceful degradation: a lost worker shrinks the pool and its job is
requeued onto the survivors; only when the pool hits zero with work
remaining does the runner respawn a fresh worker (bounded — a
machine that eats every worker ends the fleet `stalled`, exit 6,
rather than looping forever).

Preemption (SIGTERM / stop()): dispatch halts, every worker gets
SIGTERM, each in-flight supervised run takes its preemption-style
final snapshot (the supervisor's preemption path) and reports a `preempted` result;
the runner journals those checkpoints as requeue frames, writes the
fleet manifest with `"preempted": true`, and exits 5. `fleet run
--resume` replays the journal and re-runs nothing that finished.

Exit codes: 0 fleet complete (salvage mode: quarantined jobs are
parked-with-artifacts, not failures) / 1 unsalvaged failures /
5 preempted / 6 stalled.
"""

from __future__ import annotations

import multiprocessing as mp
import multiprocessing.connection as mpc
import os
import signal
import time
from typing import Optional

from shadow_tpu_torch.fleet import manifest as manifest_mod
from shadow_tpu_torch.fleet import state as state_mod
from shadow_tpu_torch.fleet.spec import FleetPolicy
from shadow_tpu_torch.fleet.state import FleetQueue

_FATAL_ERRORS = ("ValueError", "TypeError", "KeyError",
                 "FileNotFoundError", "AssertionError")

EXIT_OK = 0
EXIT_FAILURES = 1
EXIT_PREEMPTED = 5
EXIT_STALLED = 6


def _is_fatal(result: dict) -> bool:
    """Deterministic spec/build-level errors re-raise identically on
    retry; burn no attempts on them."""
    err = result.get("error") or ""
    return any(err.startswith(t + ":") for t in _FATAL_ERRORS)


class FleetRunner:
    def __init__(self, fleet_dir: str, policy: FleetPolicy,
                 specs=None, *, workers: int = 2,
                 resume: bool = False, fsync: bool = True,
                 salvage: bool = True, drain_timeout_s: float = 60.0,
                 respawn_budget: int = 4, on_event=None, log=None,
                 now=time.time, device: str | None = None):
        os.makedirs(fleet_dir, exist_ok=True)
        self.fleet_dir = fleet_dir
        self.policy = policy
        self.queue = FleetQueue(fleet_dir, policy, specs,
                                resume=resume, fsync=fsync, now=now)
        self.now = now
        self.salvage = salvage
        self.drain_timeout_s = drain_timeout_s
        self.on_event = on_event
        self.log = log or (lambda m: None)
        self.workers: dict[str, dict] = {}
        self._ctx = mp.get_context("spawn")
        # the workers' device (the port's twin of the reference's
        # JAX_PLATFORMS passthrough): None is the card
        self.device = "cuda" if device is None else str(device)
        self._nworkers = max(1, workers)
        self._next_wid = 0
        self._respawns_left = respawn_budget
        self._stop = False
        self._draining = False
        self._drain_deadline: Optional[float] = None
        self._stalled = False
        self._hb_journaled: dict[str, float] = {}
        # worker id -> affinity key of its last-leased job: the
        # bucket-affinity pairing state (fleet/affinity.py). In-memory
        # only — after a runner restart every worker process is new,
        # so stale affinity would be wrong anyway.
        self._worker_last_key: dict[str, str] = {}
        # sweep integration (sweep/driver.py): a callable(queue) ->
        # dict producing the manifest's "sweep" roll-up block, so
        # every terminal-transition rewrite carries current sweep
        # progress — a fleet killed mid-sweep leaves an accurate one
        self.sweep_block_fn = None

    # -- events -------------------------------------------------------
    def _emit(self, ev: str, **payload) -> None:
        self.log(f"fleet: {ev} "
                 + " ".join(f"{k}={v}" for k, v in payload.items()))
        if self.on_event is not None:
            self.on_event(self, {"ev": ev, **payload})

    # -- pool ---------------------------------------------------------
    def _spawn_worker(self) -> str:
        from shadow_tpu_torch.fleet.worker import _entry

        wid = f"w{self._next_wid}"
        self._next_wid += 1
        parent, child = self._ctx.Pipe()
        proc = self._ctx.Process(
            target=_entry, args=(wid, self.fleet_dir, child, self.device),
            name=f"fleet-{wid}", daemon=True)
        proc.start()
        child.close()
        self.workers[wid] = {"proc": proc, "conn": parent,
                             "job": None, "attempt": 0}
        self._emit("worker_spawned", worker=wid, pid=proc.pid)
        return wid

    def worker_pid(self, wid: str) -> Optional[int]:
        w = self.workers.get(wid)
        return w["proc"].pid if w else None

    def _busy(self):
        return [wid for wid, w in self.workers.items() if w["job"]]

    def _drop_worker(self, wid: str, reason: str, *,
                     kill: bool = False) -> None:
        """Remove a worker from the pool; requeue whatever it held."""
        w = self.workers.pop(wid, None)
        self._worker_last_key.pop(wid, None)
        if w is None:
            return
        if kill and w["proc"].is_alive():
            w["proc"].kill()
        w["proc"].join(timeout=10)
        try:
            w["conn"].close()
        except OSError:
            pass
        job = w["job"]
        if job is not None:
            st = self.queue.worker_lost(wid, job, reason)
            self._emit("worker_lost", worker=wid, job=job,
                       reason=reason, job_status=st)
            if self.queue.jobs[job].terminal:
                self.write_manifest()
        else:
            self._emit("worker_exit", worker=wid, reason=reason)

    # -- scheduling ---------------------------------------------------
    def _dispatch(self, now: float) -> None:
        if self._draining:
            return
        from shadow_tpu_torch.fleet import affinity

        idle = [wid for wid, w in self.workers.items()
                if w["job"] is None and w["proc"].is_alive()]
        # bucket-affinity pairing (fleet/affinity.py): a worker that
        # just ran a job takes the first ready job sharing its program
        # key — the compiled program is still warm in that process —
        # while everything else keeps plain FIFO order
        pairs = affinity.assign(
            self.queue.ready(now), idle, self._worker_last_key,
            key_of=lambda j: affinity.affinity_key(j.spec))
        for wid, j in pairs:
            rec = self.queue.lease(j.spec.id, wid)
            self._worker_last_key[wid] = affinity.affinity_key(j.spec)
            w = self.workers[wid]
            w["job"] = j.spec.id
            w["attempt"] = rec["attempt"]
            self._hb_journaled[j.spec.id] = now
            # a device-loss requeue re-leases at the degraded width:
            # the dispatched spec carries the shrunk shard count while
            # the durable spec dir keeps the original ask
            spec_d = j.spec.as_dict()
            if j.shards_override:
                spec_d["shards"] = int(j.shards_override)
            try:
                w["conn"].send(("job", spec_d,
                                self.queue.job_dir(j.spec.id),
                                j.resume_from, rec["attempt"]))
            except (BrokenPipeError, OSError):
                self._drop_worker(wid, "pipe closed on dispatch")
                continue
            self._emit("leased", job=j.spec.id, worker=wid,
                       attempt=rec["attempt"],
                       resume_from=rec["resume_from"])

    def _fold(self, wid: str, msg) -> None:
        kind = msg[0]
        if kind == "running":
            _, job, attempt = msg
            self.queue.mark_running(job, wid)
            self._emit("running", job=job, worker=wid,
                       attempt=attempt, pid=self.worker_pid(wid))
        elif kind == "heartbeat":
            _, job, info = msg
            j = self.queue.jobs.get(job)
            if j is None or j.terminal:
                return
            ck = info.get("checkpoint")
            now = self.now()
            fresh_ck = ck is not None and ck != j.checkpoint
            stale = now - self._hb_journaled.get(job, 0.0) >= 2.0
            self.queue.heartbeat(job, checkpoint=ck,
                                 journal_it=fresh_ck or stale)
            if fresh_ck or stale:
                self._hb_journaled[job] = now
            self._emit("heartbeat", job=job, worker=wid,
                       checkpoint=ck)
        elif kind == "result":
            _, job, attempt, result = msg
            w = self.workers.get(wid)
            if w is not None and w["job"] == job:
                w["job"] = None
            self._fold_result(job, result)

    def _fold_result(self, job: str, result: dict) -> None:
        j = self.queue.jobs[job]
        if j.terminal:          # a watchdog verdict raced it; keep that
            return
        if result.get("ok"):
            self.queue.complete(job, result)
            fl = result.get("flows") or {}
            cz = result.get("causality") or {}
            self._emit("done", job=job,
                       **({"flows_sampled": fl.get("sampled"),
                           "flows_harvested": fl.get("harvested")}
                          if fl else {}),
                       **({"causality_sampled": cz.get("sampled"),
                           "causality_windows":
                           cz.get("windows_attributed")}
                          if cz else {}))
            self._backfill_lanes(job, result)
        elif result.get("device_lost"):
            # DEVICE_LOST with headroom left: the in-run elastic ladder
            # exhausted but the mesh can still shrink — requeue the
            # SAME attempt at the degraded width (device loss is
            # environment, not the job's fault; it must not burn the
            # failure budget). Bounded by the shared requeue budget.
            dl = result["device_lost"]
            st = self.queue.device_lost(
                job, lost_shard=int(dl.get("lost_shard", -1)),
                new_shards=int(dl.get("new_shards", 1)),
                cause=str(dl.get("cause", "")))
            self._emit("device_lost", job=job, status=st,
                       lost_shard=dl.get("lost_shard"),
                       new_shards=dl.get("new_shards"))
        elif result.get("preempted") and not result.get("deadline"):
            # graceful drain: the run snapshotted and yielded — park it
            # back in the queue as a continuation of the same attempt
            self.queue.record({"ev": "requeued", "job": job,
                               "resume_from": result.get("checkpoint"),
                               "cause": "fleet preempted"})
            self._emit("requeued", job=job,
                       resume_from=result.get("checkpoint"))
        else:
            failure = dict(result.get("failure")
                           or {"error": result.get("error",
                                                   "unknown failure")})
            if result.get("deadline"):
                # in-run wallclock deadline: a failure that consumes an
                # attempt (a continuation would loop on the same
                # deadline forever); the snapshot stays for forensics
                failure.setdefault("verdict", "deadline")
                failure["checkpoint"] = result.get("checkpoint")
            st = self.queue.fail(job, failure,
                                 fatal=_is_fatal(result))
            self._emit("failed", job=job, status=st,
                       error=failure.get("error",
                                         failure.get("verdict")))
        if j.terminal:
            self.write_manifest()

    def _backfill_lanes(self, job: str, result: dict) -> None:
        """A completed packed job may carry lane-requeue specs for
        its quarantined lanes (fleet/scenario.py): enqueue each as a
        standalone child job — the freed lane slots backfill into the
        normal scheduler, with the usual attempt/backoff/quarantine
        accounting applying to the children."""
        from shadow_tpu_torch.fleet.spec import JobSpec

        for child in (result.get("lanes") or {}).get("requeues", []):
            try:
                spec = JobSpec.from_dict(child)
            except (ValueError, TypeError) as e:
                self._emit("lane_requeue_rejected", job=job,
                           error=str(e))
                continue
            if self.queue.add_job(spec):
                self._emit("lane_requeued", job=job, child=spec.id,
                           lane_of=spec.lane_of)

    def _poll(self, timeout: float) -> None:
        conns = {w["conn"]: wid for wid, w in self.workers.items()}
        if not conns:
            time.sleep(min(timeout, 0.2))
            return
        for conn in mpc.wait(list(conns), timeout=timeout):
            wid = conns[conn]
            try:
                while conn.poll():
                    self._fold(wid, conn.recv())
            except (EOFError, OSError):
                self._drop_worker(wid, "pipe closed")

    def _watchdog(self, now: float) -> None:
        for wid in list(self._busy()):
            w = self.workers.get(wid)
            if w is None:
                continue
            j = self.queue.jobs[w["job"]]
            if j.deadline_at is not None and now > j.deadline_at:
                self._drop_worker(
                    wid, f"deadline watchdog "
                    f"(>{j.spec.max_wallclock_s}s * grace)", kill=True)
            elif j.lease_expires is not None and now > j.lease_expires:
                self._drop_worker(
                    wid, f"lease expired (no heartbeat for "
                    f"{self.policy.lease_timeout_s}s)", kill=True)

    def _reap(self) -> None:
        for wid in list(self.workers):
            w = self.workers[wid]
            if not w["proc"].is_alive():
                # drain any result that beat the death to the pipe
                try:
                    while w["conn"].poll():
                        self._fold(wid, w["conn"].recv())
                except (EOFError, OSError):
                    pass
                self._drop_worker(
                    wid, f"worker process died "
                    f"(exit {w['proc'].exitcode})")

    def _maybe_respawn(self) -> None:
        if (not self.workers and not self._draining
                and self.queue.pending() and self._respawns_left > 0):
            self._respawns_left -= 1
            self._spawn_worker()

    # -- preemption ---------------------------------------------------
    def stop(self) -> None:
        """Request a graceful drain (idempotent, signal-safe)."""
        self._stop = True

    def _begin_drain(self) -> None:
        self._draining = True
        self._drain_deadline = self.now() + self.drain_timeout_s
        for wid, w in self.workers.items():
            if w["proc"].is_alive():
                w["proc"].terminate()      # SIGTERM -> stop flag
        self._emit("draining", busy=len(self._busy()))

    # -- manifest -----------------------------------------------------
    def write_manifest(self, *, final: bool = False) -> str:
        man = manifest_mod.fleet_manifest(
            self.queue, workers_alive=len(self.workers),
            preempted=self._draining, stalled=self._stalled,
            complete=final and not self.queue.pending(),
            sweep=(self.sweep_block_fn(self.queue)
                   if self.sweep_block_fn is not None else None))
        return manifest_mod.write_fleet_manifest(
            os.path.join(self.fleet_dir, "fleet_manifest.json"), man)

    # -- main loop ----------------------------------------------------
    def run(self, *, install_signals: bool = False) -> int:
        prev = None
        if install_signals:
            prev = signal.signal(signal.SIGTERM,
                                 lambda s, f: self.stop())
        try:
            for _ in range(min(self._nworkers,
                               max(1, len(self.queue.pending())))):
                self._spawn_worker()
            self.write_manifest()
            while True:
                now = self.now()
                if self._stop and not self._draining:
                    self._begin_drain()
                self._dispatch(now)
                if not self.queue.pending():
                    break
                if self._draining:
                    if not self._busy():
                        break
                    if now > (self._drain_deadline or now):
                        for wid in list(self._busy()):
                            self._drop_worker(
                                wid, "drain timeout", kill=True)
                        break
                self._poll(0.2)
                self._watchdog(self.now())
                self._reap()
                self._maybe_respawn()
                if (self.queue.pending() and not self.workers
                        and self._respawns_left <= 0
                        and not self._draining):
                    self._stalled = True
                    self._emit("stalled",
                               pending=len(self.queue.pending()))
                    break
        finally:
            for wid, w in list(self.workers.items()):
                if w["job"] is None:
                    try:
                        w["conn"].send(("shutdown",))
                    except (BrokenPipeError, OSError):
                        pass
                    w["proc"].join(timeout=5)
            for wid in list(self.workers):
                self._drop_worker(wid, "fleet shutdown", kill=True)
            self.write_manifest(final=True)
            self.queue.close()
            if install_signals and prev is not None:
                signal.signal(signal.SIGTERM, prev)
        return self.exit_code()

    def exit_code(self) -> int:
        if self._draining:
            return EXIT_PREEMPTED
        if self._stalled or self.queue.pending():
            return EXIT_STALLED
        sts = [j.status for j in self.queue.jobs.values()]
        if state_mod.FAILED in sts:
            return EXIT_FAILURES
        if state_mod.QUARANTINED in sts and not self.salvage:
            return EXIT_FAILURES
        return EXIT_OK
