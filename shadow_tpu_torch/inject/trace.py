"""On-disk injection trace formats (a copy of shadow_tpu/inject/trace.py:
the port keeps its own, stdlib only; docs/9-injection.md).

A trace is an ordered list of events to inject into the simulation:

    {"t_ns": <int>, "host": <int>, "kind": <int>, "payload": [<i32>...]}

- t_ns     absolute sim time in ns; MUST be non-decreasing through
           the file (the merge's determinism proof needs `time <
           wend` to select a position-contiguous prefix; readers
           reject unsorted traces instead of silently reordering)
- host     global destination host id (row in the event queue)
- kind     event kind (apps claim EventKind.USER + n; apps/tgen.py's
           compiled traces use its KIND_TGEN)
- payload  up to NWORDS i32 words handed to the handler verbatim
           (shorter is zero-padded on device)

Two encodings, sniffed by the first two bytes:

- newline-JSON: one record object per line (the greppable default)
- binary fast path: the fleet journal's frame layout (journal.py)
  with magic b"SI" — magic(2) + u32 length + u32 crc32 + payload +
  b"\\n", payload = little-endian i64 t_ns, i32 host, i32 kind,
  u32 word count, then the words as i32. A torn or CRC-corrupt
  TRAILING frame — the one a dying writer never finished — is
  truncated with a warning (the fleet journal's torn-tail policy;
  the warning reaches the run manifest and health diagnostics via
  the feeder). Damage anywhere BEFORE the tail still raises: a
  mid-file bad frame followed by intact frames is corruption, not a
  torn write, and silently skipping it would drop real events.

Both readers are generators — the feeder streams chunk-sized batches
without holding million-event traces in memory.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Iterable, Iterator

MAGIC = b"SI"
_HEADER = struct.Struct("<2sII")       # magic, length, crc32
_FIXED = struct.Struct("<qiiI")        # t_ns, host, kind, word count


class TraceFormatError(ValueError):
    """Malformed or unsorted injection trace."""


def normalize_event(obj, pos: int) -> dict:
    """Canonicalize one trace record: required int fields, host/kind
    non-negative, payload a list of ints. `pos` is the record's
    position in the trace, used for error messages and as the event's
    global sequence number downstream."""
    try:
        t = int(obj["t_ns"])
        host = int(obj["host"])
        kind = int(obj["kind"])
    except (KeyError, TypeError, ValueError) as e:
        raise TraceFormatError(
            f"trace record {pos}: need int t_ns/host/kind fields "
            f"({e})") from None
    payload = obj.get("payload") or []
    try:
        payload = [int(w) for w in payload]
    except (TypeError, ValueError):
        raise TraceFormatError(
            f"trace record {pos}: payload must be a list of ints")
    if t < 0 or host < 0 or kind < 0:
        raise TraceFormatError(
            f"trace record {pos}: t_ns/host/kind must be >= 0 "
            f"(got {t}/{host}/{kind})")
    return {"t_ns": t, "host": host, "kind": kind, "payload": payload}


def _check_sorted(prev: int, t: int, pos: int) -> int:
    if t < prev:
        raise TraceFormatError(
            f"trace record {pos}: t_ns {t} < previous {prev} — "
            f"traces must be sorted by t_ns (non-decreasing)")
    return t


def _read_json(f) -> Iterator[dict]:
    prev, pos = 0, 0
    for lineno, line in enumerate(f, 1):
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except ValueError:
            raise TraceFormatError(
                f"trace line {lineno}: not valid JSON")
        ev = normalize_event(obj, pos)
        prev = _check_sorted(prev, ev["t_ns"], pos)
        pos += 1
        yield ev


def _warn_tail(on_warning, msg: str) -> None:
    if on_warning is not None:
        on_warning(msg)
    else:
        import sys
        print(f"WARNING: {msg}", file=sys.stderr)


def _read_binary(f, on_warning=None) -> Iterator[dict]:
    prev, pos = 0, 0
    while True:
        head = f.read(_HEADER.size)
        if not head:
            return
        if len(head) < _HEADER.size:
            # a short header can only be the torn tail — truncate
            _warn_tail(on_warning,
                       f"trace: torn trailing frame at record {pos} "
                       f"(short header) — truncated; the writer died "
                       f"mid-append")
            return
        magic, length, crc = _HEADER.unpack(head)
        if magic != MAGIC:
            raise TraceFormatError(
                f"trace record {pos}: bad frame magic {magic!r}")
        payload = f.read(length)
        nl = f.read(1)
        if len(payload) < length or nl != b"\n":
            # ran off the end of the file mid-frame: torn tail
            _warn_tail(on_warning,
                       f"trace: torn trailing frame at record {pos} "
                       f"(short payload) — truncated; the writer "
                       f"died mid-append")
            return
        if zlib.crc32(payload) != crc:
            # CRC-corrupt LAST frame is the torn-tail case (a partial
            # overwrite the length field happened to cover); corrupt
            # frames with intact successors are mid-file damage and
            # still raise — truncating would drop real events
            if not f.read(1):
                _warn_tail(on_warning,
                           f"trace: CRC-corrupt trailing frame at "
                           f"record {pos} — truncated; the writer "
                           f"died mid-append")
                return
            raise TraceFormatError(
                f"trace record {pos}: frame CRC mismatch")
        if len(payload) < _FIXED.size:
            raise TraceFormatError(
                f"trace record {pos}: frame too short for record")
        t, host, kind, nw = _FIXED.unpack_from(payload)
        words = struct.unpack_from(f"<{nw}i", payload, _FIXED.size)
        ev = normalize_event(
            {"t_ns": t, "host": host, "kind": kind,
             "payload": list(words)}, pos)
        prev = _check_sorted(prev, ev["t_ns"], pos)
        pos += 1
        yield ev


def read_trace(path: str, on_warning=None) -> Iterator[dict]:
    """Stream normalized events from a trace file, sniffing the
    encoding from the first two bytes. Raises TraceFormatError on
    malformed records or t_ns ordering violations — except a torn /
    CRC-corrupt TRAILING binary frame, which is truncated with a
    warning (delivered to `on_warning(msg)` when given, stderr
    otherwise; the Feeder routes it into health diagnostics)."""
    with open(path, "rb") as f:
        head = f.read(2)
        f.seek(0)
        if head == MAGIC:
            yield from _read_binary(f, on_warning)
        else:
            import io
            yield from _read_json(io.TextIOWrapper(f, "utf-8"))


def write_trace(path: str, events: Iterable[dict], *,
                binary: bool = False) -> int:
    """Write a trace file (validating and normalizing each record,
    including the sortedness rule — writers fail exactly where
    readers would). Returns the record count."""
    n, prev = 0, 0
    if binary:
        with open(path, "wb") as f:
            for obj in events:
                ev = normalize_event(obj, n)
                prev = _check_sorted(prev, ev["t_ns"], n)
                words = ev["payload"]
                payload = _FIXED.pack(
                    ev["t_ns"], ev["host"], ev["kind"], len(words))
                payload += struct.pack(f"<{len(words)}i", *words)
                f.write(_HEADER.pack(MAGIC, len(payload),
                                     zlib.crc32(payload))
                        + payload + b"\n")
                n += 1
    else:
        with open(path, "w", encoding="utf-8") as f:
            for obj in events:
                ev = normalize_event(obj, n)
                prev = _check_sorted(prev, ev["t_ns"], n)
                f.write(json.dumps(ev, separators=(",", ":"),
                                   sort_keys=True) + "\n")
                n += 1
    return n
