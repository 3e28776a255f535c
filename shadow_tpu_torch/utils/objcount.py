"""Object counter / leak accounting (PyTorch port of
shadow_tpu/utils/objcount.py; ref: object_counter.c — every object
type's new/free counts are merged at shutdown, printed, and a nonzero
new-minus-free diff is flagged; slave.c:237-241).

The device state cannot leak memory (fixed-shape tensors), but it can
leak logically: sockets never freed, timers left armed, events never
processed. This module derives those counts from the device counters
and reports them in the reference's "ObjectCounter: counter values:
new=N free=F" shape; with a ProcessRuntime it adds the virtual
processes' payload pool, channel fds and processes.
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
    """Collect counts from the device state (one host read) and
    (optionally) a ProcessRuntime. Socket counts come from the
    ctr_sk_alloc/free counters; their diff is cross-checked against the
    live socket table so a miscounted free shows up as an
    inconsistency."""
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

    if runtime is not None:
        pool = runtime.pool
        counts["payload"] = (pool.total_allocs(),
                             pool.total_allocs() - pool.live_refs())
        from shadow_tpu_torch.process.vproc import PIPE_FD_BASE

        chans = runtime._channels
        # channel fds: allocated minus still-registered
        total_fds = sum(max(nf - PIPE_FD_BASE, 0)
                        for nf in runtime._next_pipe_fd.values())
        counts["channel-fd"] = (total_fds, total_fds - len(chans))
        nproc = len(runtime.procs)
        counts["process"] = (nproc,
                             sum(1 for p in runtime.procs if p.done))
    return ObjectCounts(counts=counts)
