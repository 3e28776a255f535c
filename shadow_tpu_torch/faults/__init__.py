"""Deterministic fault injection, run health and supervised recovery
(PyTorch port of shadow_tpu/faults/; the same public names).

- plan: record types, validation, JSON/config parsing, compilation
  (numpy only; a copy of the reference's).
- apply: a plan as the window-boundary fault_fn the engine runs (host
  table replay; crash resets).
- health: RunHealth latches folded from the engine's sticky counters.
- supervisor: the checkpointed retry loop, with capacity escalation
  and preemption-safe resume chains (serial path).
- escalate: latch -> capacity-knob mapping, grow policy, and the
  checkpoint-into-grown-shapes transplanter.
- conserve: the per-window conservation-invariant checker.
"""

from shadow_tpu_torch.faults.plan import (  # noqa: F401
    FaultKind,
    FaultPlan,
    FaultRecord,
    compile_plan,
    records_from_config,
    records_from_json,
    validate_records,
)
from shadow_tpu_torch.faults.apply import (  # noqa: F401
    fault_fn_for,
    install,
    make_fault_fn,
    seed_wakeups,
)
from shadow_tpu_torch.faults.health import RunHealth, gather  # noqa: F401
from shadow_tpu_torch.faults.supervisor import (  # noqa: F401
    DeadlineExceeded,
    LatchTrip,
    Preempted,
    SupervisorResult,
    run_supervised,
)
from shadow_tpu_torch.faults.escalate import (  # noqa: F401
    Escalation,
    EscalationPolicy,
    GrowBudgetExceeded,
    transplant,
)
from shadow_tpu_torch.faults import conserve  # noqa: F401
