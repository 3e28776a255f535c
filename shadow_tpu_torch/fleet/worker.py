"""Fleet worker process: lease one job at a time, run it, report
(PyTorch port of shadow_tpu/fleet/worker.py).

Spawned (never forked — a forked child cannot use its parent's CUDA
context) by the fleet runner with one duplex pipe and the device its
jobs run on. Protocol, worker side:

  recv ("job", spec_dict, job_dir, resume_from, attempt)
  send ("running", job_id, attempt)
  send ("heartbeat", job_id, {"wstart": ns, "checkpoint": path})  (many)
  send ("result", job_id, attempt, result_dict)                   (one)
  recv ("shutdown",)  ->  exit 0

SIGTERM (the fleet's graceful-drain signal) sets a stop flag the
in-flight supervised run polls at every round barrier: the run takes
its preemption-style final snapshot, the worker reports the result
(`preempted: true`, checkpoint path inside) and exits — the runner
requeues the job as a continuation. SIGKILL reports nothing; the runner
detects the dead process and requeues from the job dir's newest
checkpoint (heartbeats carried it).

Crash-safety of the report itself: run_job also writes result.json
into the job dir before the pipe send, so a worker that dies between
finishing a job and reporting it still leaves a salvageable verdict.
"""

from __future__ import annotations

import os
import signal
import sys


def worker_main(worker_id: str, fleet_dir: str, conn,
                device: str = "cuda") -> int:
    # Workers are independent processes on the fleet's device, sharing
    # the claimed build root and the program store, so job N's build is
    # job N+1's (and every sibling worker's) hit.
    from shadow_tpu_torch.utils.compcache import enable_compile_cache

    enable_compile_cache()

    from shadow_tpu_torch.fleet.scenario import run_job
    from shadow_tpu_torch.fleet.spec import JobSpec

    stop = {"v": False}

    def _on_term(signum, frame):
        stop["v"] = True

    signal.signal(signal.SIGTERM, _on_term)

    log_path = os.path.join(fleet_dir, f"worker.{worker_id}.log")
    logf = open(log_path, "a", buffering=1)

    def log(msg):
        logf.write(f"{msg}\n")

    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return 0             # runner died; nothing useful to do
        if not msg or msg[0] == "shutdown":
            return 0
        assert msg[0] == "job", msg
        _, spec_dict, job_dir, resume_from, attempt = msg
        spec = JobSpec.from_dict(spec_dict)
        try:
            conn.send(("running", spec.id, attempt))
        except (BrokenPipeError, OSError):
            return 0

        def heartbeat(info, _id=spec.id):
            try:
                conn.send(("heartbeat", _id, info))
            except (BrokenPipeError, OSError):
                pass             # runner gone; finish the job anyway

        result = run_job(spec, job_dir, resume_from=resume_from,
                         stop=lambda: stop["v"], heartbeat=heartbeat,
                         log=log, device=device)
        try:
            conn.send(("result", spec.id, attempt, result))
        except (BrokenPipeError, OSError):
            return 0
        if stop["v"]:
            return 0             # drained: one preempted result, out


def _entry(worker_id: str, fleet_dir: str, conn, device: str = "cuda"):
    sys.exit(worker_main(worker_id, fleet_dir, conn, device))
