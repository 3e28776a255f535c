"""Durable fleet queue: the job state machine over the journal.

Life of a job (docs/8-fleet.md §state machine):

    queued -> leased -> running -> done
                             \\-> failed   (non-retryable)
                             \\-> (fail)   -> backoff -> queued ...
                                             attempts exhausted
                                             -> quarantined
    worker lost / lease expired / fleet preempted
        -> requeued (same attempt, resume_from = last checkpoint)
           requeue budget exhausted -> quarantined

Terminal states and what they mean:

- **done**: the scenario completed with a clean (or self-healed)
  verdict.
- **failed**: non-retryable — the worker classified the error as
  deterministic at spec/build level (bad spec, build exception);
  retrying would reproduce it.
- **quarantined**: the job exhausted its attempt budget (or its
  worker-loss requeue budget) and is *parked*: its last checkpoint,
  run manifest, and failure report stay salvaged in its spec dir and
  the fleet manifest records why — the job stops poisoning the queue
  but loses nothing.

Attempt accounting: `attempts` counts failure retries (1-based,
bounded by max_attempts); a worker-loss requeue re-executes the SAME
attempt from its checkpoint (bounded separately by requeue_budget) —
crashing workers must not burn a job's failure budget, and a resumed
execution is a continuation, not a do-over.

Every transition is one journal frame; the whole struct rebuilds by
replay (`FleetQueue(..., resume=True)`), which is exactly what
`fleet run --resume` does: done/failed/quarantined stick, leased and
running jobs come back as queued with their recorded resume point.

Deterministic backoff: see backoff_delay() — seeded by
(backoff_seed, job id, attempt), so two runs of the same fleet
produce the same schedule (reproducible fleet logs).
"""

# The port's copy of shadow_tpu/fleet/state.py (host-only code; the port
# imports nothing of the reference).

from __future__ import annotations

import os
import time
import zlib
from typing import Optional

import numpy as np

from shadow_tpu_torch.fleet import journal as journal_mod
from shadow_tpu_torch.fleet.spec import FleetPolicy, JobSpec

QUEUED = "queued"
LEASED = "leased"
RUNNING = "running"
DONE = "done"
FAILED = "failed"
QUARANTINED = "quarantined"

TERMINAL = (DONE, FAILED, QUARANTINED)


def backoff_delay(policy: FleetPolicy, job_id: str,
                  attempt: int) -> float:
    """Deterministic exponential backoff with seeded jitter. The
    jitter RNG is keyed by (fleet backoff seed, job id, attempt), so
    the delay for sweep-07's attempt 2 is the same number in every
    run of the fleet — reproducible logs — while still de-phasing
    jobs from each other (the point of jitter)."""
    base = min(policy.backoff_cap_s,
               policy.backoff_base_s * (2.0 ** max(attempt - 1, 0)))
    rng = np.random.default_rng(
        [policy.backoff_seed & 0xFFFFFFFF,
         zlib.crc32(job_id.encode()), attempt])
    return float(base * (1.0 + 0.25 * rng.random()))


class JobState:
    def __init__(self, spec: JobSpec):
        self.spec = spec
        self.status = QUEUED
        self.attempts = 0            # failure attempts started
        self.execs = 0               # executions incl. requeues
        self.worker_losses = 0
        self.device_losses = 0       # DEVICE_LOST requeues (elastic)
        self.shards_override: Optional[int] = None  # degraded width
        self.worker: Optional[str] = None
        self.lease_expires: Optional[float] = None
        self.deadline_at: Optional[float] = None
        self.last_heartbeat: Optional[float] = None
        self.backoff_until: float = 0.0
        self.backoff_history: list = []   # seconds per failure retry
        self.attempt_history: list = []   # attempt no. per execution
        self.resume_from: Optional[str] = None
        self.continuation = False    # next lease resumes, not retries
        self.checkpoint: Optional[str] = None  # latest known
        self.result: Optional[dict] = None
        self.failure: Optional[dict] = None
        self.quarantine_reason: Optional[str] = None

    @property
    def terminal(self) -> bool:
        return self.status in TERMINAL


class FleetQueue:
    """Single-writer queue (the fleet supervisor owns the journal).
    All transitions go through record(): append one frame, then fold
    it into the in-memory state — replay and live execution share the
    same fold, so a resumed queue cannot disagree with a live one."""

    def __init__(self, fleet_dir: str, policy: FleetPolicy,
                 specs=None, *, resume: bool = False,
                 fsync: bool = True, now=time.time):
        os.makedirs(fleet_dir, exist_ok=True)
        self.fleet_dir = fleet_dir
        self.policy = policy
        self.now = now
        self.jobs: dict[str, JobState] = {}
        self.events = 0
        # duplicate/conflicting frames the fold refused (idempotent
        # replay hardening): a journal whose tail carries a second
        # terminal transition for a settled job — a crash between a
        # worker's result landing and the supervisor's ack can write
        # one — must replay to the FIRST verdict, warn, and not crash.
        # The fleet manifest surfaces these (journal_warnings).
        self.fold_warnings: list = []
        jpath = os.path.join(fleet_dir, "journal.log")
        if resume:
            old, _ = journal_mod.replay(jpath)
            if not old and specs is None:
                raise FileNotFoundError(
                    f"--resume: no journal at {jpath}")
            for spec in self._specs_from_dirs():
                self.jobs[spec.id] = JobState(spec)
            for rec in old:
                self._apply(rec)
            self._requeue_inflight()
        elif os.path.exists(jpath) and journal_mod.replay(jpath)[0]:
            raise FileExistsError(
                f"{jpath} already holds a fleet journal — pass "
                f"--resume to continue it or point --fleet-dir at a "
                f"fresh directory")
        self.journal = journal_mod.Journal(jpath, fsync=fsync)
        if specs is not None:
            for spec in specs:
                if spec.id not in self.jobs:
                    self._add_job(spec)

    # -- spec dirs ----------------------------------------------------
    def job_dir(self, job_id: str) -> str:
        return os.path.join(self.fleet_dir, "jobs", job_id)

    def _specs_from_dirs(self) -> list:
        import json as _json

        out = []
        root = os.path.join(self.fleet_dir, "jobs")
        if not os.path.isdir(root):
            return out
        for name in sorted(os.listdir(root)):
            p = os.path.join(root, name, "spec.json")
            if os.path.isfile(p):
                with open(p) as f:
                    out.append(JobSpec.from_dict(_json.load(f)))
        return out

    def _add_job(self, spec: JobSpec) -> None:
        import json as _json

        d = self.job_dir(spec.id)
        os.makedirs(d, exist_ok=True)
        sp = os.path.join(d, "spec.json")
        tmp = sp + ".tmp"
        with open(tmp, "w") as f:
            _json.dump(spec.as_dict(), f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, sp)
        journal_mod.fsync_dir(d)
        self.jobs[spec.id] = JobState(spec)
        self.record({"ev": "job_added", "job": spec.id,
                     "spec_digest": spec.digest()})

    def add_job(self, spec: JobSpec) -> bool:
        """Backfill a job mid-run (the packed-job lane-requeue path):
        journal a job_added frame and write its spec dir, exactly like
        boot-time enqueue. Idempotent by id — on --resume the spec-dir
        scan restores the child spec and the replayed journal keeps
        its state, so a crash between requeue and lease loses
        nothing."""
        if spec.id in self.jobs:
            return False
        self._add_job(spec)
        return True

    # -- journal fold -------------------------------------------------
    def record(self, rec: dict) -> dict:
        rec.setdefault("t", round(self.now(), 3))
        self.journal.append(rec)
        self._apply(rec)
        return rec

    # events that (re)write a job's status — once a job is terminal,
    # folding another of these would overwrite its verdict, so the
    # fold keeps the FIRST terminal state and warns instead (the
    # journal is append-only; a dead writer's retry or a result that
    # raced a worker_lost can legitimately leave such frames).
    # worker_lost/heartbeat stay foldable: they only touch counters.
    _STATUS_EVENTS = ("leased", "running", "done", "failed",
                      "requeued", "quarantined")

    def _apply(self, rec: dict) -> None:
        self.events += 1
        ev = rec.get("ev")
        j = self.jobs.get(rec.get("job", ""))
        if j is not None and j.terminal and ev in self._STATUS_EVENTS:
            self.fold_warnings.append(
                f"journal: '{ev}' frame for job {j.spec.id} ignored — "
                f"job already terminal ({j.status}); keeping the "
                f"first verdict")
            return
        if ev == "leased" and j is not None:
            j.status = LEASED
            j.worker = rec.get("worker")
            j.attempts = max(j.attempts, int(rec.get("attempt", 1)))
            j.execs += 1
            j.attempt_history.append(int(rec.get("attempt", 1)))
            j.resume_from = rec.get("resume_from")
            j.lease_expires = rec.get("t", 0) + self.policy.lease_timeout_s
            j.last_heartbeat = rec.get("t")
            mw = j.spec.max_wallclock_s
            j.deadline_at = (rec.get("t", 0)
                             + mw * self.policy.deadline_grace
                             if mw else None)
        elif ev == "running" and j is not None:
            j.status = RUNNING
        elif ev == "heartbeat" and j is not None:
            j.last_heartbeat = rec.get("t")
            j.lease_expires = rec.get("t", 0) + self.policy.lease_timeout_s
            if rec.get("checkpoint"):
                j.checkpoint = rec["checkpoint"]
        elif ev == "done" and j is not None:
            j.status = DONE
            j.worker = None
            j.result = rec.get("result")
        elif ev == "failed" and j is not None:
            j.failure = rec.get("failure")
            if rec.get("final"):
                j.status = FAILED
                j.worker = None
            else:
                j.status = QUEUED
                j.worker = None
                j.backoff_until = rec.get("t", 0) + rec.get("backoff_s", 0)
                j.backoff_history.append(rec.get("backoff_s", 0))
                j.resume_from = None   # a failed attempt restarts clean
                j.continuation = False
        elif ev == "requeued" and j is not None:
            j.status = QUEUED
            j.worker = None
            j.resume_from = rec.get("resume_from")
            j.continuation = True
        elif ev == "worker_lost" and j is not None:
            j.worker_losses += 1
        elif ev == "device_lost" and j is not None:
            j.device_losses += 1
            if rec.get("new_shards"):
                j.shards_override = int(rec["new_shards"])
        elif ev == "quarantined" and j is not None:
            j.status = QUARANTINED
            j.worker = None
            j.quarantine_reason = rec.get("reason")
            j.failure = rec.get("failure", j.failure)

    def _requeue_inflight(self) -> None:
        """Resume fold-up: anything the dead fleet left leased or
        running comes back queued, resuming from its last recorded
        checkpoint (heartbeats carry them) or whatever the job dir
        scan finds."""
        from shadow_tpu_torch.utils import checkpoint as ckpt

        for j in self.jobs.values():
            if j.status in (LEASED, RUNNING):
                j.status = QUEUED
                j.worker = None
                j.resume_from = j.checkpoint or ckpt.latest_checkpoint(
                    os.path.join(self.job_dir(j.spec.id), "ck"))
                j.continuation = True
                j.backoff_until = 0.0

    # -- scheduler queries --------------------------------------------
    def ready(self, now: float) -> list:
        """QUEUED jobs whose backoff has elapsed, FIFO by job order."""
        return [j for j in self.jobs.values()
                if j.status == QUEUED and j.backoff_until <= now]

    def pending(self) -> list:
        return [j for j in self.jobs.values() if not j.terminal]

    def in_flight(self) -> list:
        return [j for j in self.jobs.values()
                if j.status in (LEASED, RUNNING)]

    def next_wakeup(self, now: float) -> float:
        """Seconds until the earliest backoff expiry (for the
        scheduler's poll timeout); 0 when something is ready."""
        waits = [max(0.0, j.backoff_until - now)
                 for j in self.jobs.values() if j.status == QUEUED]
        return min(waits) if waits else 0.0

    # -- transitions --------------------------------------------------
    def lease(self, job_id: str, worker: str) -> dict:
        j = self.jobs[job_id]
        assert j.status == QUEUED, (job_id, j.status)
        attempt = (j.attempts if j.continuation and j.attempts
                   else j.attempts + 1)
        return self.record({
            "ev": "leased", "job": job_id, "worker": worker,
            "attempt": attempt, "resume_from": j.resume_from})

    def mark_running(self, job_id: str, worker: str) -> None:
        self.record({"ev": "running", "job": job_id, "worker": worker,
                     "attempt": self.jobs[job_id].attempts})

    def heartbeat(self, job_id: str, *, checkpoint=None,
                  journal_it: bool = True) -> None:
        rec = {"ev": "heartbeat", "job": job_id,
               "checkpoint": checkpoint}
        if journal_it:
            self.record(rec)
        else:                       # lease refresh without a frame
            rec["t"] = self.now()
            self._apply(rec)

    def complete(self, job_id: str, result: dict) -> None:
        self.record({"ev": "done", "job": job_id,
                     "attempt": self.jobs[job_id].attempts,
                     "result": result})

    def fail(self, job_id: str, failure: dict, *,
             fatal: bool = False) -> str:
        """Returns the resulting status (queued/failed/quarantined)."""
        j = self.jobs[job_id]
        budget = j.spec.max_attempts or self.policy.max_attempts
        if fatal:
            self.record({"ev": "failed", "job": job_id,
                         "attempt": j.attempts, "failure": failure,
                         "final": True})
            return FAILED
        if j.attempts >= budget:
            self.quarantine(job_id, f"attempts exhausted "
                            f"({j.attempts}/{budget})", failure)
            return QUARANTINED
        delay = backoff_delay(self.policy, job_id, j.attempts)
        self.record({"ev": "failed", "job": job_id,
                     "attempt": j.attempts, "failure": failure,
                     "backoff_s": round(delay, 6)})
        return QUEUED

    def worker_lost(self, worker: str, job_id: Optional[str],
                    reason: str) -> str:
        """A worker died or its lease expired. Requeue its job (same
        attempt, resume from checkpoint) unless the job has burned
        its requeue budget. Returns the job's resulting status
        ('' when the worker held no job)."""
        self.record({"ev": "worker_lost", "worker": worker,
                     "job": job_id, "reason": reason})
        if job_id is None:
            return ""
        from shadow_tpu_torch.utils import checkpoint as ckpt

        j = self.jobs[job_id]
        if j.terminal:              # result raced the loss; keep it
            return j.status
        if j.worker_losses > self.policy.requeue_budget:
            self.quarantine(job_id, f"requeue budget exhausted "
                            f"({j.worker_losses} worker losses)",
                            {"reason": reason})
            return QUARANTINED
        resume = j.checkpoint or ckpt.latest_checkpoint(
            os.path.join(self.job_dir(job_id), "ck"))
        self.record({"ev": "requeued", "job": job_id,
                     "resume_from": resume, "cause": reason})
        return QUEUED

    def device_lost(self, job_id: str, *, lost_shard: int,
                    new_shards: int, cause: str = "") -> str:
        """A device in a leased shard set died mid-run (the in-run
        elastic ladder exhausted its meshes, or the worker surfaced a
        DEVICE_LOST verdict). Requeue the job as a continuation of the
        SAME attempt at the degraded width — device loss is
        environment, not the job's fault, so it must not burn the
        failure budget — bounded by the shared requeue budget. The
        degraded width sticks (shards_override) so the next lease
        dispatches the shrunk spec; checkpoints hold global layout, so
        the shrunk mesh resumes the same run. Returns the job's
        resulting status."""
        self.record({"ev": "device_lost", "job": job_id,
                     "lost_shard": lost_shard,
                     "new_shards": int(new_shards), "cause": cause})
        from shadow_tpu_torch.utils import checkpoint as ckpt

        j = self.jobs[job_id]
        if j.terminal:              # result raced the loss; keep it
            return j.status
        if (j.worker_losses + j.device_losses
                > self.policy.requeue_budget):
            self.quarantine(job_id, f"requeue budget exhausted "
                            f"({j.device_losses} device losses, "
                            f"{j.worker_losses} worker losses)",
                            {"fault": "DEVICE_LOST", "cause": cause})
            return QUARANTINED
        resume = j.checkpoint or ckpt.latest_checkpoint(
            os.path.join(self.job_dir(job_id), "ck"))
        self.record({"ev": "requeued", "job": job_id,
                     "resume_from": resume,
                     "cause": f"device lost (shard {lost_shard}): "
                              f"{cause}" if cause else
                              f"device lost (shard {lost_shard})"})
        return QUEUED

    def quarantine(self, job_id: str, reason: str,
                   failure: Optional[dict] = None) -> None:
        j = self.jobs[job_id]
        self.record({"ev": "quarantined", "job": job_id,
                     "attempt": j.attempts, "reason": reason,
                     "failure": failure})

    def close(self) -> None:
        self.journal.close()
