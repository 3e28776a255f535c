"""Bucket-affinity scheduling: run jobs that share a compiled program
consecutively on the same worker.

A worker process that just finished a job holds that job's traced and
compiled dispatch program in process memory (and, warm serving on,
the AOT store's deserialized executable). Handing it another job with
the SAME program key makes the compile path free; handing it a
different shape pays a fresh trace. The queue stays a FIFO — this
module only changes which idle worker takes which ready job:

- phase 1: every idle worker that has a last-program key takes the
  FIRST ready job with a matching key (FIFO within the key group);
- phase 2: remaining workers take the remaining jobs in plain FIFO
  order, so a job with a cold key is never starved — it waits exactly
  as long as it would have without affinity, minus the jobs that
  jumped onto already-warm workers.

The affinity key is computed from the spec alone (no build, no trace
read): every spec field that shapes the compiled program, with the
capacity knobs quantized to the same power-of-two buckets the
scenario build applies (fleet/scenario.py / compile/buckets.py). Two
jobs with equal affinity keys build equal NetConfigs and therefore
hit the same AOT store entry; the per-job manifest's `compile.key`
is the ground truth the fleet manifest records next to it."""

# The port's copy of shadow_tpu/fleet/affinity.py (host-only code; the port
# imports nothing of the reference).

from __future__ import annotations

import hashlib
import json

from shadow_tpu_torch.compile.buckets import quantize_pow2

AFFINITY_PREFIX = "ak"

# JobSpec fields that do NOT shape the compiled program: identity,
# runtime data (seed — the RNG counter rides in arrays), retry/budget
# policy, host-side pacing, and lease terms (tenant class / SLO are
# admission-gate inputs evaluated on the host — the resident
# program's shape must NOT change when a tenant's SLO does, or every
# lease renegotiation would retrace). Everything else is
# program-shaping.
_NON_PROGRAM_FIELDS = frozenset({
    "id", "seed", "max_retries", "max_attempts", "max_wallclock_s",
    "checkpoint_every_windows", "lane_of", "kills", "verify",
    "round_sleep_s", "auto_grow", "max_grow", "tenant_class",
    "slo_p99_ms",
})


def affinity_key(spec) -> str:
    """Deterministic program-affinity key for a job spec: "ak" + 16
    hex over the program-shaping spec fields with capacities
    bucketed. The inject trace PATH stands in for the lane count when
    `inject_lanes` is unset — reading the trace here would put file
    I/O on the scheduling path; same path => same trace => same
    derived lane count."""
    d = spec.as_dict() if hasattr(spec, "as_dict") else dict(spec)
    shaped = {k: v for k, v in d.items()
              if k not in _NON_PROGRAM_FIELDS}
    for knob in ("event_capacity", "outbox_capacity", "router_ring",
                 "inject_lanes"):
        if shaped.get(knob):
            shaped[knob] = quantize_pow2(int(shaped[knob]))
    blob = json.dumps(shaped, sort_keys=True, default=str)
    return AFFINITY_PREFIX + hashlib.sha256(
        blob.encode()).hexdigest()[:16]


def assign(ready, idle, last_key: dict, key_of=affinity_key):
    """Pair ready jobs with idle workers, affinity first.

    `ready` is the FIFO-ordered ready list (fleet/state.py), `idle`
    the idle worker ids in a deterministic order, `last_key` maps
    worker id -> affinity key of its last job. Returns [(worker_id,
    job)] — deterministic in its inputs (tests assert this), every
    pair consuming one worker and one job."""
    remaining = list(ready)
    picked: dict = {}
    for wid in idle:
        k = last_key.get(wid)
        if k is None or not remaining:
            continue
        match = next((j for j in remaining if key_of(j) == k), None)
        if match is not None:
            picked[wid] = match
            remaining.remove(match)
    for wid in idle:
        if wid in picked or not remaining:
            continue
        picked[wid] = remaining.pop(0)
    return [(wid, picked[wid]) for wid in idle if wid in picked]
