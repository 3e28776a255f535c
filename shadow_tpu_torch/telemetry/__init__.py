"""Window telemetry: the device-resident per-window ring (ring.py), the
flow flight-recorder (flows.py), the causality recorder (causality.py),
their host-side drain and phase timers (harvest.py), and the exports
(export.py: Chrome trace, Prometheus text, run manifest)."""

from shadow_tpu_torch.telemetry.causality import (  # noqa: F401
    CAUSE_NAMES,
    AdvanceRecord,
    CausalityRecord,
    CausalityState,
    attach_causality,
    binding_histogram,
    causality_manifest_block,
    cause_name,
    critical_chains,
)
from shadow_tpu_torch.telemetry.export import (  # noqa: F401
    chrome_trace,
    metrics_from_manifest,
    prometheus_text,
    run_manifest,
    write_manifest,
    write_metrics,
    write_trace,
)
from shadow_tpu_torch.telemetry.flows import (  # noqa: F401
    DEFAULT_SAMPLE_PERIOD,
    FlowRecord,
    FlowRing,
    attach_flows,
    flows_manifest_block,
    latency_histograms,
    make_flow_fn,
    per_lane_latency,
    traffic_matrix,
)
from shadow_tpu_torch.telemetry.harvest import (  # noqa: F401
    Harvester,
    PhaseTimers,
    WindowRecord,
)
from shadow_tpu_torch.telemetry.ring import (  # noqa: F401
    DEFAULT_CAPACITY,
    TelemetryRing,
    attach,
    make_telem_fn,
)
