"""Fault-tolerant scenario-fleet runner (PyTorch port of
shadow_tpu/fleet/).

Runs heterogeneous scenarios (config x seed x fault plan, declared in a
JSON jobs file) across a pool of spawned worker processes on the card
(or the CPU when the fleet says so), surviving worker SIGKILL/OOM/hangs
and fleet-level SIGTERM without losing or re-running work:

- journal:   append-only CRC-framed state journal (the durable queue)
- spec:      jobs-file parsing, JobSpec, FleetPolicy
- state:     the job state machine folded over the journal
- affinity:  program-key affinity of ready jobs to warm workers
- scenario:  per-job execution (reuses faults.run_supervised,
             utils/checkpoint, telemetry manifests)
- worker:    the worker process main loop
- runner:    scheduler + watchdog + graceful degradation
- manifest:  fleet_manifest.json roll-up
- admission: continuous lane admission over one resident program
- cli:       `python -m shadow_tpu_torch.cli fleet run/status`
"""

from shadow_tpu_torch.fleet.spec import (  # noqa: F401
    FleetPolicy,
    JobSpec,
    load_jobs_file,
    parse_jobs_obj,
)
from shadow_tpu_torch.fleet.state import FleetQueue, backoff_delay  # noqa: F401
from shadow_tpu_torch.fleet.runner import (  # noqa: F401
    EXIT_FAILURES,
    EXIT_OK,
    EXIT_PREEMPTED,
    EXIT_STALLED,
    FleetRunner,
)
