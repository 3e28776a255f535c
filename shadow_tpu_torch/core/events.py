"""Device-resident event queues (PyTorch port of shadow_tpu/core/events.py).

Each host owns one row of fixed-capacity struct-of-arrays tensors;
"pop" is a masked lexicographic argmin over (time, src, seq) within the
row (ref: event.c:110-153), so the order is the reference's heap order
whatever the device. Cross-host sends are staged per *source* host in
an Outbox and routed to destination rows once per window
(route_outbox).

The containers are plain dataclasses of tensors with the reference's
field names; an optional field left ``None`` contributes no leaf.
Functions return new containers and never write into their inputs.

Host syncs: route_outbox reads the outbox's occupied width once per
window (narrow tier / empty elision) and the insert reads the largest
per-row arrival count once (select sweep versus sorted scatter) — the
port's form of the reference's lax.cond predicates.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from shadow_tpu_torch.core import simtime
from shadow_tpu_torch.core.insert_kernels import mailbox_gather

I32 = torch.int32
I64 = torch.int64
INT64_MAX = simtime.INVALID
# Generic int32 payload words carried by every event (a simulated TCP
# header plus the delivery-status audit word; ref: packet.h:66-86).
NWORDS = 17
# Narrow width for configs without TCP state: the protocol-independent
# words (packetfmt indices 0..5).
NWORDS_BASE = 6


class _Replace:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def static(default):
    """A dataclass field that is configuration, not state (the
    reference's struct.field(pytree_node=False)): it holds no tensor,
    is no leaf of the flax field-path tree (convert.py), and compaction
    passes it through."""
    return dataclasses.field(default=default, metadata={"static": True})


def is_static(f: dataclasses.Field) -> bool:
    return bool(f.metadata.get("static"))


def fit_words(words: torch.Tensor, width: int) -> torch.Tensor:
    """Pad (zeros) or slice the trailing word dim to `width`. Slicing
    is only sound when the dropped columns are zero (narrow queues
    exist only in non-TCP configs)."""
    w = words.shape[-1]
    if w == width:
        return words
    if w > width:
        return words[..., :width]
    return F.pad(words, (0, width - w))


def as_tensor(value, dtype, device) -> torch.Tensor:
    """`value` as a tensor of `dtype` on `device`. A Python scalar is
    filled on the device (one kernel), not copied from the host: a
    host-to-device copy of a scalar waits for the stream."""
    if isinstance(value, torch.Tensor):
        return value.to(dtype)
    if isinstance(value, (bool, int, float)):
        return torch.full((), value, dtype=dtype, device=device)
    return torch.as_tensor(value, dtype=dtype, device=device)


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding [0, 2**32) -> the int32 with the same bits."""
    return (x - ((x >> 31) & 1) * (1 << 32)).to(I32)


class EventKind:
    """Builtin event kinds (same ids as the reference)."""

    NONE = 0
    PACKET = 1
    PACKET_LOCAL = 2
    TIMER = 3
    PROC_START = 4
    PROC_STOP = 5
    NIC_RECV = 6
    NIC_SEND = 7
    TCP_RTX_TIMER = 8
    TCP_CLOSE_TIMER = 9
    TCP_DACK_TIMER = 10
    HEARTBEAT = 11
    TCP_FLUSH = 12
    FAULT_WAKEUP = 13
    USER = 16


@dataclass
class EventQueue(_Replace):
    """Per-host event store: row h = host h's pending events;
    time == simtime.INVALID marks an empty slot."""

    time: torch.Tensor   # [H, K] i64
    kind: torch.Tensor   # [H, K] i32
    src: torch.Tensor    # [H, K] i32
    seq: torch.Tensor    # [H, K] i32
    words: torch.Tensor  # [H, K, NWORDS] i32
    next_seq: torch.Tensor  # [H] i32
    overflow: torch.Tensor  # [] i32
    overflow_h: Any = None

    @property
    def num_hosts(self) -> int:
        return self.time.shape[0]

    @property
    def capacity(self) -> int:
        return self.time.shape[1]

    @staticmethod
    def create(num_hosts: int, capacity: int, nwords: int = NWORDS,
               device=None) -> "EventQueue":
        H, K = num_hosts, capacity
        return EventQueue(
            time=torch.full((H, K), simtime.INVALID, dtype=I64, device=device),
            kind=torch.zeros((H, K), dtype=I32, device=device),
            src=torch.zeros((H, K), dtype=I32, device=device),
            seq=torch.zeros((H, K), dtype=I32, device=device),
            words=torch.zeros((H, K, nwords), dtype=I32, device=device),
            next_seq=torch.zeros((H,), dtype=I32, device=device),
            overflow=torch.zeros((), dtype=I32, device=device),
        )

    def valid(self) -> torch.Tensor:
        return self.time != simtime.INVALID

    def fill_count(self) -> torch.Tensor:
        """[H] number of occupied slots per host row."""
        return self.valid().sum(dim=1, dtype=I32)

    def occupancy(self) -> tuple:
        """(min, max, sum) of per-host occupied slots — the telemetry
        ring's queue-occupancy probe."""
        fill = self.fill_count()
        return fill.amin(), fill.amax(), fill.sum(dtype=I64)

    def min_time(self) -> torch.Tensor:
        """[H] earliest pending event time per host (INVALID if none)."""
        return self.time.amin(dim=1)


class Popped(NamedTuple):
    """One popped event per host lane (valid=False lanes hold garbage
    and are masked by handlers)."""

    valid: torch.Tensor  # [H] bool
    time: torch.Tensor   # [H] i64
    kind: torch.Tensor   # [H] i32
    src: torch.Tensor    # [H] i32
    seq: torch.Tensor    # [H] i32
    words: torch.Tensor  # [H, NWORDS] i32


def _onehot(mask: torch.Tensor, slot: torch.Tensor, width: int) -> torch.Tensor:
    """[H] masked slot -> [H, width] one-hot row selector."""
    ar = torch.arange(width, device=mask.device)
    return mask[:, None] & (ar[None, :] == slot[:, None])


def _put(arr: torch.Tensor, sel: torch.Tensor, value) -> torch.Tensor:
    """Masked row write arr[H,W] (or [H,W,NWORDS] when value is
    [H,NWORDS]) under a one-hot selector."""
    value = as_tensor(value, arr.dtype, arr.device)
    if arr.ndim == 3:
        return torch.where(sel[:, :, None], value[:, None, :], arr)
    v = value[:, None] if value.ndim == 1 else value
    return torch.where(sel, v, arr)


def _tie_key(src: torch.Tensor, seq: torch.Tensor) -> torch.Tensor:
    """Pack (srcHost, perSourceSeq as u32) into one sortable i64."""
    return (src.to(I64) << 32) | (seq.to(I64) & 0xFFFFFFFF)


def pop_earliest(q: EventQueue, horizon):
    """Pop each host's earliest event with time < horizon (one pop per
    host per micro-step; hosts in parallel)."""
    t = q.time
    tmin = t.amin(dim=1, keepdim=True)
    tie = torch.where(t == tmin, _tie_key(q.src, q.seq), INT64_MAX)
    idx = tie.argmin(dim=1)
    rows = torch.arange(q.num_hosts, device=t.device)
    ptime = t[rows, idx]
    valid = ptime < horizon
    popped = Popped(valid=valid, time=ptime, kind=q.kind[rows, idx],
                    src=q.src[rows, idx], seq=q.seq[rows, idx],
                    words=q.words[rows, idx])
    sel = _onehot(valid, idx, q.capacity)
    return q.replace(time=torch.where(sel, simtime.INVALID, t)), popped


def _first_true(m: torch.Tensor) -> torch.Tensor:
    """[H, W] bool -> [H] index of the first True (0 when none)."""
    return m.to(torch.uint8).argmax(dim=1)


def push_rows(q: EventQueue, mask, time, kind, src, seq, words) -> EventQueue:
    """Insert one event into each masked host row (first free slot)."""
    words = fit_words(words, q.words.shape[-1])
    free = ~q.valid()
    has_free = free.any(dim=1)
    slot = _first_true(free)
    ok = mask & has_free
    sel = _onehot(ok, slot, q.capacity)
    lost = mask & ~has_free
    q = q.replace(
        time=_put(q.time, sel, time),
        kind=_put(q.kind, sel, kind),
        src=_put(q.src, sel, src),
        seq=_put(q.seq, sel, seq),
        words=_put(q.words, sel, words),
        overflow=q.overflow + lost.sum(dtype=I32),
    )
    if q.overflow_h is not None:
        q = q.replace(overflow_h=q.overflow_h + lost.to(I32))
    return q


@dataclass
class Outbox(_Replace):
    """Cross-host events staged per *source* host; routed to
    destination rows once per window by route_outbox()."""

    dst: torch.Tensor    # [H, M] i32 (-1 = empty)
    time: torch.Tensor   # [H, M] i64
    kind: torch.Tensor   # [H, M] i32
    src: torch.Tensor    # [H, M] i32
    seq: torch.Tensor    # [H, M] i32
    words: torch.Tensor  # [H, M, NWORDS] i32
    count: torch.Tensor  # [H] i32
    overflow: torch.Tensor  # [] i32
    narrow_hit: torch.Tensor   # [] i32
    narrow_miss: torch.Tensor  # [] i32
    max_occupied: torch.Tensor  # [] i32
    route_elided: torch.Tensor  # [] i32
    overflow_h: Any = None

    @property
    def num_hosts(self) -> int:
        return self.dst.shape[0]

    @property
    def capacity(self) -> int:
        return self.dst.shape[1]

    def occupied(self) -> torch.Tensor:
        """[H, M] bool: slots holding a staged entry (dst >= 0)."""
        return self.dst >= 0

    @staticmethod
    def create(num_hosts: int, capacity: int, nwords: int = NWORDS,
               device=None) -> "Outbox":
        H, M = num_hosts, capacity
        z = lambda: torch.zeros((), dtype=I32, device=device)  # noqa: E731
        return Outbox(
            dst=torch.full((H, M), -1, dtype=I32, device=device),
            time=torch.full((H, M), simtime.INVALID, dtype=I64, device=device),
            kind=torch.zeros((H, M), dtype=I32, device=device),
            src=torch.zeros((H, M), dtype=I32, device=device),
            seq=torch.zeros((H, M), dtype=I32, device=device),
            words=torch.zeros((H, M, nwords), dtype=I32, device=device),
            count=torch.zeros((H,), dtype=I32, device=device),
            overflow=z(), narrow_hit=z(), narrow_miss=z(),
            max_occupied=z(), route_elided=z(),
        )


def outbox_append(out: Outbox, mask, dst, time, kind, src, seq, words) -> Outbox:
    words = fit_words(words, out.words.shape[-1])
    room = out.count < out.capacity
    ok = mask & room
    sel = _onehot(ok, out.count, out.capacity)
    lost = mask & ~room
    if out.overflow_h is not None:
        out = out.replace(overflow_h=out.overflow_h + lost.to(I32))
    return out.replace(
        dst=_put(out.dst, sel, dst),
        time=_put(out.time, sel, time),
        kind=_put(out.kind, sel, kind),
        src=_put(out.src, sel, src),
        seq=_put(out.seq, sel, seq),
        words=_put(out.words, sel, words),
        count=out.count + ok.to(I32),
        overflow=out.overflow + lost.sum(dtype=I32),
    )


def segment_ranks(sorted_keys: torch.Tensor) -> torch.Tensor:
    """[n] rank of each element within its run of equal keys (keys
    already sorted)."""
    n = sorted_keys.shape[0]
    pos = torch.arange(n, device=sorted_keys.device)
    is_start = torch.ones((n,), dtype=torch.bool, device=sorted_keys.device)
    is_start[1:] = sorted_keys[1:] != sorted_keys[:-1]
    seg_start = torch.cummax(torch.where(is_start, pos, 0), dim=0).values
    return pos - seg_start


def _pack_time(t: torch.Tensor):
    """i64 -> (lo, hi) i32 words, exact for every bit pattern."""
    return u32_to_i32(t & 0xFFFFFFFF), (t >> 32).to(I32)


def _unpack_time(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    return (hi.to(I64) << 32) | (lo.to(I64) & 0xFFFFFFFF)


def _free_slot_of_rank(q: EventQueue) -> torch.Tensor:
    """[H, K] map: rank r among a row's free slots (ascending slot
    order) -> slot index, K where the row has fewer than r+1 free
    slots."""
    K = q.capacity
    free = ~q.valid()
    order = torch.argsort((~free).to(torch.uint8), dim=1, stable=True).to(I32)
    n_free = free.sum(dim=1, dtype=I32)
    ar = torch.arange(K, device=free.device)
    return torch.where(ar[None, :] < n_free[:, None], order, K)


# Per-destination-row arrival budget of the select sweep: when every
# destination row receives at most this many entries, each row's
# arrivals are fetched as one contiguous [INSERT_SWEEP, P] window of
# the row-sorted stream (mailbox_gather) and placed into the row's free
# slots by rank. Rows over budget take the sorted-scatter form.
INSERT_SWEEP = 32


def _queue_packed(q: EventQueue) -> torch.Tensor:
    """The queue's planes as one [H, K, 5+W] i32 tensor."""
    lo, hi = _pack_time(q.time)
    return torch.cat([lo[:, :, None], hi[:, :, None], q.kind[:, :, None],
                      q.src[:, :, None], q.seq[:, :, None], q.words], dim=2)


def _queue_unpacked(q: EventQueue, packed_q, overflow_add,
                    overflow_add_h=None) -> EventQueue:
    q = q.replace(
        time=_unpack_time(packed_q[:, :, 0], packed_q[:, :, 1]),
        kind=packed_q[:, :, 2].contiguous(),
        src=packed_q[:, :, 3].contiguous(),
        seq=packed_q[:, :, 4].contiguous(),
        words=packed_q[:, :, 5:].contiguous(),
        overflow=q.overflow + overflow_add,
    )
    if q.overflow_h is not None and overflow_add_h is not None:
        q = q.replace(overflow_h=q.overflow_h + overflow_add_h)
    return q


def _insert_sorted(q: EventQueue, rowc: torch.Tensor, packed: torch.Tensor):
    """The "sort2" insert: a stable sort of the candidates by
    destination row (ties keep caller order, the determinism contract),
    per-row arrival counts and exclusive starts, then one of two
    writers — both give the same values entry for entry:

    - select sweep (every row receives at most INSERT_SWEEP entries):
      each row's arrivals are one contiguous window of the sorted
      stream, fetched by the mailbox_gather kernel; arrival j lands in
      the row's j-th free slot.
    - sorted scatter (fallback): each valid entry's rank in its row
      picks the rank-th free slot; entries that do not fit are counted
      as overflow and written to a pad row/column that is cut off.
    """
    H, K = q.time.shape
    row_o, perm = torch.sort(rowc, stable=True)
    packed_o = packed[perm]
    valid_o = row_o < H

    cnt = torch.bincount(row_o, minlength=H + 1)[:H].to(I32)
    start = (torch.cumsum(cnt, dim=0, dtype=I32) - cnt).contiguous()
    free = ~q.valid()
    nfree = free.sum(dim=1, dtype=I32)
    packed_q = _queue_packed(q)
    Wn = INSERT_SWEEP
    ofl_h = ((cnt - nfree).clamp(min=0).to(I32)
             if q.overflow_h is not None else None)

    if int(cnt.max()) <= Wn:
        pad_o = F.pad(packed_o, (0, 0, 0, Wn)).contiguous()
        win = mailbox_gather(pad_o, start, Wn)                 # [H, Wn, P]
        f_rank = torch.cumsum(free, dim=1, dtype=I32) - free.to(I32)
        take = free & (f_rank < cnt[:, None])
        j = f_rank.clamp(0, Wn - 1).to(I64)
        cand = torch.gather(
            win, 1, j[:, :, None].expand(-1, -1, win.shape[2]))
        acc = torch.where(take[:, :, None], cand, packed_q)
        ofl = (cnt - nfree).clamp(min=0).sum(dtype=I32)
        return _queue_unpacked(q, acc, ofl, ofl_h)

    rank_o = segment_ranks(row_o)
    slot_map = _free_slot_of_rank(q)
    rank_c = torch.where(valid_o, rank_o.clamp(0, K - 1), K - 1)
    cand = slot_map[row_o.clamp(0, H - 1), rank_c]
    fits = valid_o & (rank_o < K) & (cand < K)
    r = torch.where(valid_o, row_o, H)
    s = torch.where(fits, cand.to(I64), K)
    padded = F.pad(packed_q, (0, 0, 0, 1, 0, 1)).clone()
    padded[r, s] = packed_o
    ofl = (valid_o & ~fits).sum(dtype=I32)
    return _queue_unpacked(q, padded[:H, :K], ofl, ofl_h)


def insert_flat(q: EventQueue, valid, row, time, kind, src, seq,
                words) -> EventQueue:
    """Insert a flat batch of events into their destination rows, in
    caller order within each row. Overflow is counted, never silent.
    All planes move as ONE packed [n, 5+W] i32 tensor (time split into
    two i32 words)."""
    H = q.num_hosts
    rowc = torch.where(valid, row, H).to(I64)
    tlo, thi = _pack_time(time)
    packed = torch.cat([tlo[:, None], thi[:, None], kind[:, None],
                        src[:, None], seq[:, None], words], dim=1)
    return _insert_sorted(q, rowc, packed)


def clear_outbox(out: Outbox) -> Outbox:
    return out.replace(
        dst=torch.full_like(out.dst, -1),
        time=torch.full_like(out.time, simtime.INVALID),
        count=torch.zeros_like(out.count),
    )


# Narrow-route tier: outbox rows are cursor-appended, so when every
# row's occupied width fits this width the route runs over a sliced
# [H, ROUTE_NARROW] view. None / 0 disables.
ROUTE_NARROW = 24


def _route_width(q: EventQueue, out: Outbox, width: int) -> EventQueue:
    """Insert the first `width` outbox columns of every row."""
    H = out.dst.shape[0]
    n = H * width
    dst = out.dst[:, :width].reshape(n)
    occupied = dst >= 0
    bad_dst = occupied & (dst >= H)
    valid = occupied & ~bad_dst
    q = insert_flat(
        q, valid, dst,
        out.time[:, :width].reshape(n), out.kind[:, :width].reshape(n),
        out.src[:, :width].reshape(n), out.seq[:, :width].reshape(n),
        out.words[:, :width].reshape(n, out.words.shape[-1]))
    if q.overflow_h is not None:
        q = q.replace(overflow_h=q.overflow_h
                      + bad_dst.reshape(H, width).sum(dim=1, dtype=I32))
    return q.replace(overflow=q.overflow + bad_dst.sum(dtype=I32))


def route_outbox(q: EventQueue, out: Outbox, narrow: int | None = None):
    """Deliver all staged cross-host events into destination rows.

    The narrow tier gates on the true maximum OCCUPIED column, so
    slicing drops only empty slots; an occupied width of zero elides
    the insert entirely (counted in route_elided). One host sync reads
    the occupied width."""
    H, M = out.dst.shape
    width = ROUTE_NARROW if narrow is None else narrow
    if width and width < M:
        cols = torch.arange(1, M + 1, dtype=I32, device=out.dst.device)
        occ_w = torch.where(out.dst >= 0, cols[None, :], 0).amax()
        ow = int(occ_w)
        hit, empty = ow <= width, ow == 0
        out = out.replace(
            narrow_hit=out.narrow_hit + int(hit),
            narrow_miss=out.narrow_miss + int(not hit),
            max_occupied=torch.maximum(out.max_occupied, occ_w),
            route_elided=out.route_elided + int(empty))
        if not empty:
            q = _route_width(q, out, width if hit else M)
    else:
        empty = not bool((out.dst >= 0).any())
        out = out.replace(route_elided=out.route_elided + int(empty))
        if not empty:
            q = _route_width(q, out, M)
    return q, clear_outbox(out)


@dataclass
class EmitBuffer(_Replace):
    """Per-micro-step emission staging: each lane appends at its
    private cursor; apply_emissions() assigns per-source sequence
    numbers in slot order."""

    dst: torch.Tensor    # [H, E] i32
    time: torch.Tensor   # [H, E] i64
    kind: torch.Tensor   # [H, E] i32
    words: torch.Tensor  # [H, E, NWORDS] i32
    count: torch.Tensor  # [H] i32
    overflow: torch.Tensor  # [] i32
    overflow_h: Any = None

    @property
    def num_hosts(self) -> int:
        return self.dst.shape[0]

    @property
    def capacity(self) -> int:
        return self.dst.shape[1]

    @staticmethod
    def create(num_hosts: int, capacity: int = 4, nwords: int = NWORDS,
               device=None) -> "EmitBuffer":
        H, E = num_hosts, capacity
        return EmitBuffer(
            dst=torch.full((H, E), -1, dtype=I32, device=device),
            time=torch.full((H, E), simtime.INVALID, dtype=I64, device=device),
            kind=torch.zeros((H, E), dtype=I32, device=device),
            words=torch.zeros((H, E, nwords), dtype=I32, device=device),
            count=torch.zeros((H,), dtype=I32, device=device),
            overflow=torch.zeros((), dtype=I32, device=device),
        )


def emit(buf: EmitBuffer, mask, dst, time, kind, words) -> EmitBuffer:
    H = buf.num_hosts
    words = fit_words(words, buf.words.shape[-1])
    kind = as_tensor(kind, I32, mask.device).expand(H)
    room = buf.count < buf.capacity
    ok = mask & room
    sel = _onehot(ok, buf.count, buf.capacity)
    lost = mask & ~room
    if buf.overflow_h is not None:
        buf = buf.replace(overflow_h=buf.overflow_h + lost.to(I32))
    return buf.replace(
        dst=_put(buf.dst, sel, dst),
        time=_put(buf.time, sel, time),
        kind=_put(buf.kind, sel, kind),
        words=_put(buf.words, sel, words),
        count=buf.count + ok.to(I32),
        overflow=buf.overflow + lost.sum(dtype=I32),
    )


def emit_words(*vals, num_hosts: int | None = None, device=None) -> torch.Tensor:
    """Assemble an [H, NWORDS] word array from [H] (or scalar) columns."""
    assert len(vals) <= NWORDS, f"{len(vals)} payload words > NWORDS={NWORDS}"
    H = num_hosts
    for v in vals:
        if isinstance(v, torch.Tensor) and v.ndim == 1:
            H = v.shape[0]
            device = v.device
    assert H is not None
    out = torch.zeros((H, NWORDS), dtype=I32, device=device)
    for i, v in enumerate(vals):
        out[:, i] = as_tensor(v, I32, device)
    return out


def apply_emissions(q: EventQueue, out: Outbox, buf: EmitBuffer,
                    lane_id: torch.Tensor | None = None):
    """Move staged emissions into the local queue / cross-host outbox,
    assigning per-source sequence numbers in slot order. Emission dst
    fields are global host ids; dst == lane_id stays local."""
    H, E = buf.dst.shape
    lane = (torch.arange(H, dtype=I32, device=buf.dst.device)
            if lane_id is None else lane_id.to(I32))
    nvalid = torch.zeros((H,), dtype=I32, device=buf.dst.device)
    # slots past the last occupied one (across lanes) hold nothing, and
    # moving an empty slot is the identity: one host read bounds the loop
    cols = torch.arange(1, E + 1, dtype=I32, device=buf.dst.device)
    used = int(torch.where(buf.dst >= 0, cols, 0).amax()) if E else 0
    for e in range(used):
        d = buf.dst[:, e]
        v = d >= 0
        seq = q.next_seq + nvalid
        is_local = v & (d == lane)
        is_remote = v & (d != lane)
        q = push_rows(q, is_local, buf.time[:, e], buf.kind[:, e], lane, seq,
                      buf.words[:, e])
        out = outbox_append(out, is_remote, d, buf.time[:, e], buf.kind[:, e],
                            lane, seq, buf.words[:, e])
        nvalid = nvalid + v.to(I32)
    q = q.replace(next_seq=q.next_seq + nvalid,
                  overflow=q.overflow + buf.overflow)
    if q.overflow_h is not None and buf.overflow_h is not None:
        q = q.replace(overflow_h=q.overflow_h + buf.overflow_h)
    return q, out


# --- Window kind census ------------------------------------------------
#
# One u32 bitmask: bit k set when any event of kind k is present; kinds
# >= 31 share bit 31 (an over-approximation, which is sound because
# every handler is a masked batch update). Returned as an int64 scalar
# tensor holding the u32 value.

def kind_mask(kind: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """[] bitmask of the kinds at the positions where `m` holds (no
    host sync: absent positions scatter into a spare bin)."""
    k = torch.where(m, kind.clamp(0, 31).to(I64), 32).reshape(-1)
    present = torch.zeros(33, dtype=I64, device=kind.device)
    present[k] = 1
    bits = present[:32] << torch.arange(32, dtype=I64, device=kind.device)
    return bits.sum()


def kind_census(q: EventQueue, wend) -> torch.Tensor:
    """[] bitmask of event kinds present in `q` before `wend`."""
    return kind_mask(q.kind, q.time < wend)


def emit_kind_bits(buf: EmitBuffer) -> torch.Tensor:
    """[] bitmask of event kinds staged in an EmitBuffer."""
    return kind_mask(buf.kind, buf.dst >= 0)


def census_mask(kinds) -> int:
    """Static u32 mask for a handler family's kind tuple (host side)."""
    m = 0
    for k in kinds:
        m |= 1 << min(int(k), 31)
    return m
