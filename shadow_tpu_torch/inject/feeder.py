"""Host-side injection feeder: trace/iterator -> staging refills
(PyTorch port of shadow_tpu/inject/feeder.py: the host bookkeeping is
the reference's numpy code; only the plane install and the post-restore
read touch the device).

The Feeder owns the host half of the injection contract. It reads a
trace (a file path handed to inject/trace.py, an in-memory list, or
any iterator of record dicts), keeps a host-side MIRROR of what is
staged on device, and rebuilds the staging planes between dispatches:

- `fill_all(sim)` stages the whole trace up front (whole-run jitted
  paths — engine.run, make_runner; errors if the trace is larger
  than the lane count, with the fix spelled out).
- `refill(sim, up_to_time)` is the streaming path driven by
  checkpoint.run_windows: `up_to_time` is the device's next window
  start, and the conservative invariant (a merged event's time is
  always < the next window start, a staged-pending event's never is)
  lets the host prune its mirror WITHOUT reading device state back —
  the refill is pure host bookkeeping + new plane arrays, each copied
  to the Sim's device once from pinned host memory without blocking
  the host.
- `sync(sim)` rebuilds the mirror FROM device state after a
  checkpoint restore, then repositions the source just past the last
  staged event — so a supervised resume replays nothing and drops
  nothing. Path sources reposition by reopening the file and
  skipping; list/iterator sources retain consumed history in memory
  (a live generator cannot be rewound any other way).

Slot rule (shared with staging.py): event at trace position `seq`
lives in lane `seq % L`. Staged positions therefore form a contiguous
window of at most L; `backpressure` counts the refills that wanted to
stage more but found every lane occupied — the signal that
--inject-lanes is too small for the trace's burst density.

The feeder also publishes `horizon`: the timestamp of the first
event it has NOT yet staged (INVALID once the source is drained).
staging.wend_clamp keeps every window end <= horizon, which is what
makes streamed injection deterministic instead of best-effort.
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator, Optional, Union

import torch

from shadow_tpu_torch.core import simtime
from shadow_tpu_torch.inject.trace import (
    TraceFormatError,
    normalize_event,
    read_trace,
)


class Feeder:
    """Streams an injection trace into a Sim's staging buffer."""

    def __init__(self, source: Union[str, os.PathLike, Iterable[dict],
                                     Iterator[dict]]):
        # torn-tail truncation warnings from the binary trace reader
        # (trace.py) — surfaced through stats() into the manifest's
        # injection block and health diagnostics
        self.warnings: list = []
        if isinstance(source, (str, os.PathLike)):
            self.path: Optional[str] = str(source)
            self._it = read_trace(self.path, self._warn)
            self._it_pos = 0
            self._mem = None
            self._mem_pos = 0
        else:
            self.path = None
            self._it = iter(source)
            self._it_pos = 0
            # consumed history: lets sync() reposition a live
            # iterator after a checkpoint restore
            self._mem: Optional[list] = []
            self._mem_pos = 0
        self._prev_t = 0          # sortedness check for raw iterators
        self._buf: list = []      # read-but-not-staged lookahead
        self._staged: dict = {}   # trace position -> normalized event
        self.cursor = 0           # next trace position to stage
        self.trace_events: Optional[int] = None  # known once drained
        self.backpressure = 0     # refills that found no free lane

    # ---------------------------------------------------------- source

    def _warn(self, msg: str) -> None:
        # re-reads (sync/_reposition reopen the file) re-hit the same
        # torn tail; keep one copy of each distinct warning
        if msg not in self.warnings:
            self.warnings.append(msg)

    def _read_next(self) -> Optional[dict]:
        """Next normalized event from the source, None when drained
        (latching trace_events to the final count)."""
        if self._mem is not None and self._mem_pos < len(self._mem):
            ev = self._mem[self._mem_pos]
            self._mem_pos += 1
            return ev
        try:
            raw = next(self._it)
        except StopIteration:
            if self.trace_events is None:
                self.trace_events = self._it_pos
            return None
        self._it_pos += 1
        if self.path is not None:
            ev = raw                      # read_trace already validated
        else:
            pos = len(self._mem)
            ev = normalize_event(raw, pos)
            if ev["t_ns"] < self._prev_t:
                raise TraceFormatError(
                    f"trace record {pos}: t_ns {ev['t_ns']} < previous "
                    f"{self._prev_t} — injection sources must be "
                    f"sorted by t_ns")
            self._prev_t = ev["t_ns"]
            self._mem.append(ev)
            self._mem_pos = len(self._mem)
        return ev

    def _reposition(self, pos: int) -> None:
        """Make the next _read_next() return trace position `pos`."""
        self._buf.clear()
        if self.path is not None:
            if self._it_pos > pos:
                self._it = read_trace(self.path, self._warn)
                self._it_pos = 0
            while self._it_pos < pos:
                if self._read_next() is None:
                    raise TraceFormatError(
                        f"trace {self.path}: checkpoint expects >= "
                        f"{pos} records, file has {self._it_pos} — "
                        f"wrong trace for this checkpoint?")
        else:
            while len(self._mem) < pos:
                self._mem_pos = len(self._mem)
                if self._read_next() is None:
                    raise TraceFormatError(
                        f"injection source: checkpoint expects >= "
                        f"{pos} records, source yielded "
                        f"{len(self._mem)}")
            self._mem_pos = pos

    def _peek(self) -> Optional[dict]:
        if not self._buf:
            ev = self._read_next()
            if ev is None:
                return None
            self._buf.append(ev)
        return self._buf[0]

    def _take(self) -> dict:
        return self._buf.pop(0)

    # --------------------------------------------------------- staging

    @property
    def done(self) -> bool:
        """Source drained AND every staged event merged on device."""
        return self._peek() is None and not self._staged

    @property
    def horizon(self) -> int:
        """Timestamp of the first not-yet-staged event (INVALID when
        the whole remaining trace is staged)."""
        ev = self._peek()
        return int(simtime.INVALID) if ev is None else ev["t_ns"]

    def pending_min(self) -> int:
        """Earliest staged-but-unmerged timestamp per the host mirror
        (INVALID when nothing is staged) — the host twin of
        staging.staged_pending_min, used by window drivers to pick
        the next window start after a quiet stretch without reading
        device state back."""
        return min((ev["t_ns"] for ev in self._staged.values()),
                   default=int(simtime.INVALID))

    def _floor(self) -> int:
        return min(self._staged) if self._staged else self.cursor

    def _stage_ready(self, st, num_hosts: int) -> int:
        """Pull events into free lanes (slot rule: at most L
        contiguous positions staged). Returns how many were added."""
        L = st.lanes
        nwords = int(st.words.shape[-1])
        added = 0
        while self.cursor - self._floor() < L:
            ev = self._peek()
            if ev is None:
                break
            if ev["host"] >= num_hosts:
                raise TraceFormatError(
                    f"trace record {self.cursor}: host {ev['host']} "
                    f">= num_hosts {num_hosts}")
            if len(ev["payload"]) > nwords:
                raise TraceFormatError(
                    f"trace record {self.cursor}: payload has "
                    f"{len(ev['payload'])} words, queue carries "
                    f"{nwords}")
            self._take()
            self._staged[self.cursor] = ev
            self.cursor += 1
            added += 1
        return added

    def _planes(self, st):
        """Host arrays for the staging planes from the mirror, in pinned
        memory when the Sim lies on the card (so each copy can run
        without blocking the host)."""
        L = st.lanes
        nwords = int(st.words.shape[-1])
        pinned = st.time.device.type == "cuda"

        def host(shape, dtype, fill=0):
            t = torch.full(shape, fill, dtype=dtype, pin_memory=pinned)
            return t.numpy()

        time = host((L,), torch.int64, int(simtime.INVALID))
        host_ = host((L,), torch.int32)
        kind = host((L,), torch.int32)
        seq = host((L,), torch.int64)
        words = host((L, nwords), torch.int32)
        for s, ev in self._staged.items():
            lane = s % L
            time[lane] = ev["t_ns"]
            host_[lane] = ev["host"]
            kind[lane] = ev["kind"]
            seq[lane] = s
            words[lane, :len(ev["payload"])] = ev["payload"]
        return time, host_, kind, seq, words

    def _install(self, sim):
        """Write the mirror's planes and the horizon to the Sim's
        device: one host-to-device copy per plane. The pinned host
        buffers are fresh per refill; torch's caching host allocator
        does not hand a buffer out again before its copy completed."""
        st = sim.inject
        dev = st.time.device
        time, host, kind, seq, words = self._planes(st)

        def put(a):
            return torch.from_numpy(a).to(dev, non_blocking=True)

        st = st.replace(
            time=put(time), host=put(host), kind=put(kind), seq=put(seq),
            words=put(words),
            horizon=torch.tensor(self.horizon, dtype=torch.int64,
                                 device=dev))
        return sim.replace(inject=st)

    def refill(self, sim, up_to_time: Optional[int] = None):
        """Prune mirror entries the device has merged (everything
        with t_ns < up_to_time, the device's next window start) and
        stage as many fresh events as fit. Pure host bookkeeping —
        no device reads — so it overlaps device compute."""
        st = getattr(sim, "inject", None)
        if st is None:
            raise ValueError(
                "sim has no injection staging buffer; call "
                "inject.attach(sim, lanes) (cli: --inject-lanes)")
        if up_to_time is not None:
            gone = [s for s, ev in self._staged.items()
                    if ev["t_ns"] < up_to_time]
            for s in gone:
                del self._staged[s]
        self._stage_ready(st, int(sim.events.num_hosts))
        if self._peek() is not None \
                and self.cursor - self._floor() >= st.lanes:
            self.backpressure += 1
        return self._install(sim)

    def fill_all(self, sim):
        """Stage the ENTIRE trace at once, for whole-run jitted paths
        that never return to the host mid-run. Errors if the trace
        does not fit the lanes — streaming needs a host-driven loop."""
        sim = self.refill(sim)
        if self._peek() is not None:
            raise ValueError(
                f"injection trace has more than "
                f"{sim.inject.lanes} events and cannot be fully "
                f"staged; raise --inject-lanes past the trace length "
                f"or run a host-driven loop (--supervise / "
                f"run_windows(feeder=...)) to stream it")
        return sim

    def sync(self, sim) -> None:
        """Rebuild the mirror from DEVICE state after a checkpoint
        restore and reposition the source just past it. Idempotent:
        calling on a freshly attached sim leaves the feeder at the
        start."""
        st = getattr(sim, "inject", None)
        if st is None:
            raise ValueError("sim has no injection staging buffer")
        time = st.time.cpu().numpy()
        seq = st.seq.cpu().numpy()
        floor = int(st.seq_floor)
        valid = time != int(simtime.INVALID)
        top = int(seq[valid].max()) + 1 if valid.any() else 0
        self.cursor = max(floor, top)
        # staged positions are contiguous, so the device's pending
        # window is exactly [floor, cursor). Re-read those records
        # through the source so the mirror carries payloads — device
        # state alone would suffice, but re-deriving from the trace
        # keeps one canonical reader and cross-checks that the right
        # trace is mounted for this checkpoint.
        self._staged.clear()
        self._reposition(floor)
        for pos in range(floor, self.cursor):
            ev = self._read_next()
            if ev is None:
                raise TraceFormatError(
                    f"trace ended at record {pos} but the checkpoint "
                    f"has events staged through {self.cursor - 1}")
            self._staged[pos] = ev

    # -------------------------------------------------------- manifest

    def stats(self) -> dict:
        """Host-side half of the manifest's injection block."""
        out = {
            "trace_path": self.path,
            "trace_events": self.trace_events,
            "staged_cursor": self.cursor,
            "backpressure": self.backpressure,
        }
        if self.warnings:
            out["trace_warnings"] = list(self.warnings)
        return out
