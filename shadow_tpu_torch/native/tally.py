"""RetransmitTally — Python face of the native interval-set
scoreboard (ref: tcp_retransmit_tally.h:29-50 C ABI), with the pure
Python twin of shadow_tpu/native/tally.py (`_PyTally`, identical
semantics) for a process where the library cannot be built
(``native.load_error()`` says why; ``native.require()`` refuses that
case)."""

from __future__ import annotations

import ctypes

from shadow_tpu_torch.native import load

DUPL_ACK_LOST_THRESH = 3  # ref: tcp_retransmit_tally.h kDuplAckLostThresh


class _PyTally:
    """Fallback with the same behavior as retransmit_tally.cc."""

    def __init__(self, snd_una: int):
        self.snd_una = snd_una
        self.recovery_point = -1
        self.dupl_acks = 0
        self.sacked: list[tuple[int, int]] = []
        self.retransmitted: list[tuple[int, int]] = []
        self.marked: list[tuple[int, int]] = []

    @staticmethod
    def _insert(rs, b, e):
        if b >= e:
            return
        out = []
        for rb, re in rs:
            if re < b or e < rb:
                out.append((rb, re))
            else:
                b, e = min(b, rb), max(e, re)
        out.append((b, e))
        out.sort()
        rs[:] = out

    @staticmethod
    def _trim(rs, seq):
        rs[:] = [(max(b, seq), e) for b, e in rs if e > seq]

    def mark_sacked(self, b, e):
        self._insert(self.sacked, b, e)

    def mark_retransmitted(self, b, e):
        self._insert(self.retransmitted, b, e)

    def mark_lost(self, b, e):
        self._insert(self.marked, b, e)

    def dupl_ack(self):
        self.dupl_acks += 1

    def set_recovery_point(self, seq):
        self.recovery_point = seq

    def advance(self, snd_una):
        if snd_una <= self.snd_una:
            self.dupl_acks += 1
            return
        self.snd_una = snd_una
        self.dupl_acks = 0
        for rs in (self.sacked, self.retransmitted, self.marked):
            self._trim(rs, snd_una)
        if self.recovery_point >= 0 and snd_una >= self.recovery_point:
            self.recovery_point = -1

    def is_sacked(self, b, e):
        return any(rb <= b and e <= re for rb, re in self.sacked)

    def sacked_bytes(self):
        return sum(e - b for b, e in self.sacked)

    def lost_ranges(self):
        lost: list[tuple[int, int]] = []
        for r in self.marked:
            self._insert(lost, *r)
        if (self.recovery_point >= 0
                and self.dupl_acks >= DUPL_ACK_LOST_THRESH):
            cur, end = self.snd_una, self.recovery_point
            for sb, se in self.sacked:
                if se <= cur:
                    continue
                if sb >= end:
                    break
                if sb > cur:
                    self._insert(lost, cur, min(sb, end))
                cur = max(cur, se)
                if cur >= end:
                    break
            if cur < end:
                self._insert(lost, cur, end)
        # sacked bytes are never lost (explicit marks can cover them:
        # ref compute_lost subtracts sacked_ from marked_lost_), nor
        # are retransmitted-and-not-again-lost ranges
        for rb, re in list(self.sacked) + list(self.retransmitted):
            out = []
            for lb, le in lost:
                if le <= rb or re <= lb:
                    out.append((lb, le))
                    continue
                if lb < rb:
                    out.append((lb, rb))
                if re < le:
                    out.append((re, le))
            lost = out
        return lost


class RetransmitTally:
    """Uses the native library when available, _PyTally otherwise."""

    MAX_RANGES = 64

    def __init__(self, snd_una: int = 0):
        self._lib = load()
        if self._lib is not None:
            self._h = self._lib.retransmit_tally_new(snd_una)
            self._py = None
        else:
            self._h = None
            self._py = _PyTally(snd_una)

    def __del__(self):
        if getattr(self, "_lib", None) is not None and self._h:
            self._lib.retransmit_tally_free(self._h)
            self._h = None

    @property
    def native(self) -> bool:
        return self._py is None

    def mark_sacked(self, b, e):
        if self._py:
            return self._py.mark_sacked(b, e)
        self._lib.retransmit_tally_sacked(self._h, b, e)

    def mark_retransmitted(self, b, e):
        if self._py:
            return self._py.mark_retransmitted(b, e)
        self._lib.retransmit_tally_retransmitted(self._h, b, e)

    def mark_lost(self, b, e):
        if self._py:
            return self._py.mark_lost(b, e)
        self._lib.retransmit_tally_mark_lost(self._h, b, e)

    def dupl_ack(self):
        if self._py:
            return self._py.dupl_ack()
        self._lib.retransmit_tally_dupl_ack(self._h)

    def set_recovery_point(self, seq):
        if self._py:
            return self._py.set_recovery_point(seq)
        self._lib.retransmit_tally_set_recovery_point(self._h, seq)

    def advance(self, snd_una):
        if self._py:
            return self._py.advance(snd_una)
        self._lib.retransmit_tally_advance(self._h, snd_una)

    def is_sacked(self, b, e) -> bool:
        if self._py:
            return self._py.is_sacked(b, e)
        return bool(self._lib.retransmit_tally_is_sacked(self._h, b, e))

    def sacked_bytes(self) -> int:
        if self._py:
            return self._py.sacked_bytes()
        return int(self._lib.retransmit_tally_sacked_bytes(self._h))

    def lost_ranges(self) -> list[tuple[int, int]]:
        if self._py:
            return self._py.lost_ranges()
        n = self.MAX_RANGES
        begins = (ctypes.c_int64 * n)()
        ends = (ctypes.c_int64 * n)()
        k = self._lib.retransmit_tally_lost_ranges(self._h, begins, ends, n)
        return [(int(begins[i]), int(ends[i])) for i in range(k)]
