"""Per-window conservation invariants — the chaos harness's oracle
(PyTorch port of shadow_tpu/faults/conserve.py).

Every event that ever receives a (source, seq) identity bumps exactly
one `next_seq` counter (boot seeding in net/build.py, fault wakeups in
faults/apply.py, window emissions in core/events.py apply_emissions),
and every identified event is, at any window barrier, in exactly one
place: already processed, still queued, staged in the outbox, or
loudly dropped. That gives the ledger

    sum(next_seq) == events_processed + sum(fill_count)
                     + sum(outbox.count) [ + drops ]

EXACT when the overflow latches are zero — which is every healed run,
since any nonzero overflow is a fatal latch the supervisor escalates
on. With nonzero overflow the right side brackets the left instead
(EmitBuffer drops never received a seq, so `q.overflow` mixes
seq-carrying and seq-less drops): the checker degrades to a bounds
check rather than lying about exactness.

CRASH faults flush a host's event row non-conservatively by design
(the reference drops a dead host's events too), so chaos plans that
want the exact ledger exclude crash/restart kinds.

The clock half: window starts must be strictly increasing and each
round's next_min may never precede its window start (runahead legally
schedules *inside* the current window — `next_min < wend` is fine;
`next_min < wstart` is corruption, the same rule the supervisor
latches as time_regression).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """A device tensor (or array) as a numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclasses.dataclass(frozen=True)
class WindowSample:
    """The ledger at one window barrier (host-side ints — samples
    survive process kills and program rebuilds by construction)."""

    wstart: int
    wend: int
    next_min: int
    pushed: int       # sum(events.next_seq): identities ever assigned
    processed: int    # cumulative events_processed (incl. resume base)
    queued: int       # sum(events.fill_count())
    outboxed: int     # sum(outbox.count) (0 after route clears it)
    drops: int        # events.overflow + outbox.overflow (rq spill
                      # drops packets, not identified events)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def sample(sim, *, wstart: int, wend: int, next_min: int,
           processed_total: int) -> WindowSample:
    """Read the ledger off the device at a window barrier, in one host
    read. `processed_total` is the harness's cumulative processed count
    — cumulative across resumes/escalations, which per-attempt engine
    stats are not."""
    q = sim.events
    pushed, queued, outboxed, drops = torch.stack([
        q.next_seq.sum(dtype=torch.int64),
        q.fill_count().sum(dtype=torch.int64),
        sim.outbox.count.sum(dtype=torch.int64),
        q.overflow.to(torch.int64) + sim.outbox.overflow.to(torch.int64),
    ]).tolist()
    return WindowSample(
        wstart=int(wstart), wend=int(wend), next_min=int(next_min),
        pushed=int(pushed), processed=int(processed_total),
        queued=int(queued), outboxed=int(outboxed), drops=int(drops),
    )


def check(samples) -> list[str]:
    """Validate a run's sample sequence; returns human-readable
    violation strings (empty == conserved). Deliberately side-effect
    free and picky — tests corrupt counters to prove it catches."""
    errors: list[str] = []
    prev = None
    for i, s in enumerate(samples):
        where = f"window[{i}] (wstart={s.wstart})"
        if s.wend <= s.wstart:
            errors.append(f"{where}: wend={s.wend} <= wstart")
        if s.next_min < s.wstart:
            errors.append(f"{where}: clock regressed — next_min="
                          f"{s.next_min} < wstart={s.wstart}")
        if prev is not None and s.wstart <= prev.wstart:
            errors.append(
                f"{where}: window starts not strictly increasing "
                f"(previous wstart={prev.wstart})")
        if prev is not None and s.pushed < prev.pushed:
            errors.append(
                f"{where}: pushed count went backwards "
                f"({prev.pushed} -> {s.pushed}) — next_seq is "
                f"monotone by construction")
        if prev is not None and s.processed < prev.processed:
            errors.append(
                f"{where}: processed count went backwards "
                f"({prev.processed} -> {s.processed})")
        accounted = s.processed + s.queued + s.outboxed
        if s.drops == 0:
            if s.pushed != accounted:
                errors.append(
                    f"{where}: conservation violated — pushed="
                    f"{s.pushed} != processed={s.processed} + queued="
                    f"{s.queued} + outboxed={s.outboxed}")
        else:
            # drops mix seq-carrying and seq-less losses: bounds only
            if not (accounted <= s.pushed <= accounted + s.drops):
                errors.append(
                    f"{where}: pushed={s.pushed} outside "
                    f"[{accounted}, {accounted + s.drops}] "
                    f"(drops={s.drops})")
        prev = s
    return errors


@dataclasses.dataclass(frozen=True)
class LaneWindowSample:
    """The ledger at one window barrier, split per lane (lane-isolated
    packed runs, core/lanes.py). Packed ensembles carry no cross-lane
    traffic (each lane is an independent replica; apps/phold.py keeps
    peers inside the replica block), so every term of the global
    ledger decomposes by contiguous lane block — plus one new term:
    `flushed`, the quarantine freeze's loudly-discarded pending events
    (they carried identities, so they stay on the books)."""

    wstart: int
    wend: int
    pushed: tuple      # [R] lane sums of next_seq
    processed: tuple   # [R] lane shares of ctr_events_exec (cumulative)
    queued: tuple      # [R] lane sums of fill_count
    outboxed: tuple    # [R] lane sums of outbox.count
    drops: tuple       # [R] lane shares of events+outbox overflow
    flushed: tuple     # [R] quarantine-flush counts (lanes.flushed)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def lane_sample(sim, *, wstart: int, wend: int) -> LaneWindowSample:
    """Read the per-lane ledger off a lane-isolated sim at a window
    barrier. Requires the attribution planes (core.lanes.attach) —
    drops cannot be attributed per lane from the scalars alone."""
    lanes = sim.lanes
    R = lanes.replicas
    q = sim.events

    def ls(x):
        return tuple(int(v) for v in
                     _host(x).astype(np.int64).reshape(R, -1).sum(1))

    ev_h = _host(q.overflow_h).astype(np.int64)
    ob_h = _host(sim.outbox.overflow_h).astype(np.int64)
    return LaneWindowSample(
        wstart=int(wstart), wend=int(wend),
        pushed=ls(q.next_seq),
        processed=ls(sim.net.ctr_events_exec),
        queued=ls(q.fill_count()),
        outboxed=ls(sim.outbox.count),
        drops=tuple(int(a + b) for a, b in
                    zip(ev_h.reshape(R, -1).sum(1),
                        ob_h.reshape(R, -1).sum(1))),
        flushed=tuple(int(v) for v in _host(lanes.flushed)),
    )


def lane_check(samples) -> list[str]:
    """Validate a per-lane sample sequence: the global check()'s
    conservation rules applied to every lane independently, with the
    flushed term on the accounted side. A healthy lane must stay EXACT
    even while a neighbor lane overflows and is quarantined — that is
    the blast-radius containment oracle."""
    errors: list[str] = []
    prev = None
    for i, s in enumerate(samples):
        where = f"window[{i}] (wstart={s.wstart})"
        R = len(s.pushed)
        for r in range(R):
            lw = f"{where} lane[{r}]"
            if prev is not None and s.pushed[r] < prev.pushed[r]:
                errors.append(
                    f"{lw}: pushed count went backwards "
                    f"({prev.pushed[r]} -> {s.pushed[r]})")
            if prev is not None and s.processed[r] < prev.processed[r]:
                errors.append(
                    f"{lw}: processed count went backwards "
                    f"({prev.processed[r]} -> {s.processed[r]})")
            accounted = (s.processed[r] + s.queued[r] + s.outboxed[r]
                         + s.flushed[r])
            if s.drops[r] == 0:
                if s.pushed[r] != accounted:
                    errors.append(
                        f"{lw}: conservation violated — pushed="
                        f"{s.pushed[r]} != processed={s.processed[r]} "
                        f"+ queued={s.queued[r]} + outboxed="
                        f"{s.outboxed[r]} + flushed={s.flushed[r]}")
            else:
                # same degradation as check(): drops mix seq-carrying
                # and seq-less losses, so bounds only
                if not (accounted <= s.pushed[r]
                        <= accounted + s.drops[r]):
                    errors.append(
                        f"{lw}: pushed={s.pushed[r]} outside "
                        f"[{accounted}, {accounted + s.drops[r]}] "
                        f"(drops={s.drops[r]})")
        prev = s
    return errors


def stitch(before: list, after: list, resume_time: int) -> list:
    """Splice sample sequences across a kill/heal boundary: the resumed
    attempt replays from its checkpoint, so `before` samples at or
    past the resume point are superseded by the replay (bit-identical
    by the checkpoint contract — but the replayed copies carry the
    post-resume cumulative counters, so keep exactly one copy)."""
    kept = [s for s in before if s.wstart < resume_time]
    return kept + list(after)
