"""Window telemetry: the device-resident per-window ring (ring.py), its
host-side drain and phase timers (harvest.py), and the exports
(export.py: Chrome trace, Prometheus text, run manifest)."""

from shadow_tpu_torch.telemetry.export import (  # noqa: F401
    chrome_trace,
    metrics_from_manifest,
    prometheus_text,
    run_manifest,
    write_manifest,
    write_metrics,
    write_trace,
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
