"""Object counter / leak accounting (PyTorch port of
shadow_tpu/utils/objcount.py; ref: object_counter.c — every object
type's new/free counts are merged at shutdown, printed, and a nonzero
new-minus-free diff is flagged; slave.c:237-241).

The device state cannot leak memory (fixed-shape tensors), but it can
leak logically: sockets never freed, timers left armed, events never
processed. This module derives those counts from the device counters
and reports them in the reference's "ObjectCounter: counter values:
new=N free=F" shape. The reference's `runtime` branch (payload pools,
channels and processes of virtual processes) waits for
process/vproc.py (ROADMAP.md Queue 1 item 10b).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from shadow_tpu_torch.core import simtime


@dataclass
class ObjectCounts:
    """new/free per type; live = new - free (must match the state)."""

    counts: dict  # type -> (new, freed)

    def diff(self) -> dict:
        """type -> live count (the leak diff the reference prints)."""
        return {k: n - f for k, (n, f) in self.counts.items() if n - f}

    def format(self) -> str:
        parts = [f"{k}(new={n} free={f})"
                 for k, (n, f) in sorted(self.counts.items())]
        return "ObjectCounter: counter values: " + " ".join(parts)

    def format_diff(self) -> str:
        d = self.diff()
        if not d:
            return "ObjectCounter: all objects freed"
        parts = [f"{k}={v}" for k, v in sorted(d.items())]
        return "ObjectCounter: leak diff: " + " ".join(parts)


def gather(sim, runtime=None, stats=None) -> ObjectCounts:
    """Collect counts from the device state (one host read). Socket
    counts come from the ctr_sk_alloc/free counters; their diff is
    cross-checked against the live socket table so a miscounted free
    shows up as an inconsistency."""
    if runtime is not None:
        raise NotImplementedError(
            "shadow_tpu_torch: objcount of a virtual-process runtime "
            "(ROADMAP.md Queue 1 item 10b)")
    net = sim.net
    i64 = torch.int64
    sk_new, sk_free, live_table, armed, ev_live = torch.stack([
        net.ctr_sk_alloc.sum(dtype=i64), net.ctr_sk_free.sum(dtype=i64),
        (net.sk_type != 0).sum(dtype=i64),
        (net.tm_expire != simtime.INVALID).sum(dtype=i64),
        (sim.events.time != simtime.INVALID).sum(dtype=i64)]).tolist()
    counts: dict = {"socket": (sk_new, sk_free)}
    if sk_new - sk_free != live_table:
        # accounting bug — surface loudly like a leak
        counts["socket-UNACCOUNTED"] = (live_table, sk_new - sk_free)
    counts["timer-armed"] = (armed, 0)
    processed = int(stats.events_processed) if stats is not None else 0
    counts["event"] = (processed + ev_live, processed)
    return ObjectCounts(counts=counts)
