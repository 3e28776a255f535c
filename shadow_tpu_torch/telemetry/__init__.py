"""Window telemetry: the device-resident per-window ring (ring.py) and
its host-side drain (harvest.py)."""

from shadow_tpu_torch.telemetry.harvest import (  # noqa: F401
    Harvester,
    WindowRecord,
)
from shadow_tpu_torch.telemetry.ring import (  # noqa: F401
    DEFAULT_CAPACITY,
    TelemetryRing,
    attach,
    make_telem_fn,
)
