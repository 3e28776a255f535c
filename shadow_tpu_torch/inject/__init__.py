"""Open-system traffic injection (PyTorch port of shadow_tpu/inject/).

Closed-loop apps (PHOLD, the TCP relay) generate their own load; this
package is the on-ramp for *external* load — recorded traces or the
compiled <traffic> phases of apps/tgen.py feeding the simulated hosts:

- staging.py  the device-resident bounded staging buffer merged into
              the EventQueue at window boundaries (overflow counted,
              never silent)
- trace.py    the on-disk trace formats: newline-JSON records and a
              CRC-framed binary fast path
- feeder.py   the host-side streamer: iterator/trace -> staging
              refills at dispatch granularity
"""

from shadow_tpu_torch.inject.feeder import Feeder   # noqa: F401
from shadow_tpu_torch.inject.staging import (       # noqa: F401
    InjectStaging,
    attach,
    merge_staged,
    staged_pending_min,
)
from shadow_tpu_torch.inject.trace import (         # noqa: F401
    read_trace,
    write_trace,
)


def manifest_block(sim, feeder=None):
    """The run manifest's `injection` block: device latches plus the
    feeder's host-side accounting. `deferred` closes the
    reconciliation the lint checks — every trace event is injected,
    dropped, or deferred past end-of-run, never silently lost. None
    when the sim carries no staging buffer."""
    st = getattr(sim, "inject", None)
    if st is None:
        return None
    import torch

    injected, dropped, late = (int(v) for v in torch.stack(
        [st.injected, st.dropped, st.late]).tolist())
    blk = {
        "lanes": int(st.lanes),
        "injected": injected,
        "dropped": dropped,
        "late": late,
    }
    if feeder is not None:
        blk.update(feeder.stats())
        te = feeder.trace_events
        # trace_events is unknown until the source drains (a trace
        # outliving end_time is legal); deferred is only defined once
        # the total is
        blk["deferred"] = (None if te is None
                           else max(0, te - injected - dropped))
    return blk
