"""Deterministic sim-time-stamped logging (a copy of
shadow_tpu/utils/shadowlog.py) — the
semantics of the reference's two-tier logger (ref:
src/support/logger/logger.h macros + logger/shadow_logger.c): records
carry (sim time, host, domain, level); buffered records are flushed
time-sorted so the log reads in simulated-time order regardless of
emission order (the reference achieves this with per-thread buffers
merged on a helper pthread — here a single sorted flush per
window/round does the same job on the host side).

Output line format mirrors the reference closely enough for
tools/parse_shadow.py to treat either log:

  00:00:01.000000000 [message] [hostname] text
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Optional, TextIO


class LogLevel:
    """ref: src/support/logger/log_level.c"""

    ERROR = 0
    CRITICAL = 1
    WARNING = 2
    MESSAGE = 3
    INFO = 4
    DEBUG = 5


_NAMES = ["error", "critical", "warning", "message", "info", "debug"]


def level_from_name(name: str) -> int:
    return _NAMES.index(name.lower())


def level_name(level: int) -> str:
    return _NAMES[level]


def format_simtime(ns: int) -> str:
    """hh:mm:ss.nnnnnnnnn (the reference's log timestamp layout)."""
    s, nrem = divmod(int(ns), 1_000_000_000)
    h, s = divmod(s, 3600)
    m, s = divmod(s, 60)
    return f"{h:02d}:{m:02d}:{s:02d}.{nrem:09d}"


@dataclass(order=True)
class LogRecord:
    sim_time: int
    seq: int                 # emission order tie-break (determinism)
    level: int = field(compare=False)
    host: str = field(compare=False)
    message: str = field(compare=False)

    def format(self) -> str:
        return (f"{format_simtime(self.sim_time)} "
                f"[{level_name(self.level)}] [{self.host}] {self.message}")


class SimLogger:
    """Buffering, time-sorting logger (ref: shadow_logger.c flush
    cycle, slave.c:446-450). error() raises, like the reference's
    error() abort (logger.h:19-29). ``require_native``: a flush of
    4,096 records or more raises, with native.load_error(), when the
    native library is missing, rather than sorting with list.sort (the
    CLI sets it on the card)."""

    def __init__(self, level: int = LogLevel.MESSAGE,
                 stream: Optional[TextIO] = None, buffered: bool = True,
                 require_native: bool = False):
        self.level = level
        self.require_native = require_native
        self.stream = stream if stream is not None else sys.stdout
        self.buffered = buffered
        self._buf: list[LogRecord] = []
        self._seq = 0
        self.records_emitted = 0
        # flushes sorted by the native argsort (batches of 4,096+)
        self.native_sorts = 0

    def log(self, level: int, sim_time: int, host: str, message: str):
        if level > self.level:
            return
        rec = LogRecord(sim_time=int(sim_time), seq=self._seq, level=level,
                        host=host, message=message)
        self._seq += 1
        if self.buffered:
            self._buf.append(rec)
        else:
            self.stream.write(rec.format() + "\n")
            self.records_emitted += 1
        if level == LogLevel.ERROR:
            self.flush()
            raise RuntimeError(f"[{host}] {message}")

    def error(self, t, host, msg):
        self.log(LogLevel.ERROR, t, host, msg)

    def critical(self, t, host, msg):
        self.log(LogLevel.CRITICAL, t, host, msg)

    def warning(self, t, host, msg):
        self.log(LogLevel.WARNING, t, host, msg)

    def message(self, t, host, msg):
        self.log(LogLevel.MESSAGE, t, host, msg)

    def info(self, t, host, msg):
        self.log(LogLevel.INFO, t, host, msg)

    def debug(self, t, host, msg):
        self.log(LogLevel.DEBUG, t, host, msg)

    def flush(self):
        """Sort-by-time flush (ref: logger_helper.c:50-66). Batches of
        4,096 records and more go through the native stable argsort
        (native/logsort.cc) when the library loads, and through
        list.sort, the same order, otherwise (unless require_native)."""
        if len(self._buf) >= 4096:
            self._buf = self._native_sorted(self._buf)
        else:
            self._buf.sort()
        for rec in self._buf:
            self.stream.write(rec.format() + "\n")
        self.records_emitted += len(self._buf)
        self._buf.clear()

    def _native_sorted(self, buf: list[LogRecord]) -> list[LogRecord]:
        import ctypes

        import numpy as np

        from shadow_tpu_torch import native

        lib = native.require() if self.require_native else native.load()
        if lib is None:
            buf.sort()
            return buf
        n = len(buf)
        times = np.fromiter((r.sim_time for r in buf), np.int64, n)
        seqs = np.fromiter((r.seq for r in buf), np.int64, n)
        out = np.zeros(n, np.int64)
        p = ctypes.POINTER(ctypes.c_int64)
        lib.logsort_argsort(times.ctypes.data_as(p), seqs.ctypes.data_as(p),
                            n, out.ctypes.data_as(p))
        self.native_sorts += 1
        return [buf[i] for i in out]
