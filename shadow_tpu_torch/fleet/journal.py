"""Append-only, CRC-framed state journal — the fleet queue's source
of truth (docs/8-fleet.md).

Every queue transition (job added, leased, running, heartbeat, done,
failed, requeued, quarantined, worker lost, fleet preempted) is one
frame appended to `journal.log`. A frame is

    magic   2 bytes  b"SJ"   (catches "this is not a journal" early)
    length  4 bytes  u32 LE  payload byte count
    crc32   4 bytes  u32 LE  over the payload bytes
    payload N bytes  JSON (UTF-8), one record object
    newline 1 byte   b"\\n"  (debuggability: `strings journal.log`
                              reads roughly like JSON lines)

Durability contract (the fleet's analog of utils/checkpoint.py's
torn-snapshot rule): each append is a single write() of the whole
frame followed by flush + fsync, and the journal's parent directory
is fsynced when the file is first created — so acknowledged frames
survive power loss, not just process death. A frame torn by a crash
mid-write (short frame, bad CRC, bad magic) can only be the LAST
frame; replay() stops at the first bad frame and reports the byte
offset of the good prefix, and Journal() opened for append truncates
the file back to that offset so the torn tail can never corrupt
later frames. tests/test_fleet.py::test_journal_torn_write proves
the truncate-and-replay round trip.

Single writer by design: only the fleet supervisor process appends.
Workers report through their pipes and their per-job dirs; the
supervisor serializes everything into this one ordered record, which
is what makes `fleet run --resume` a pure replay.

Idempotent-fold contract: replay() returns frames verbatim — it is
the FOLDS over them that must be idempotent against duplicates. A
crash between an effect landing and its ack can journal the same
terminal transition twice (a second `done`/`failed`/`quarantined`
for a settled job, a second terminal lease frame for a settled
lane); both consumers keep the FIRST terminal state and warn instead
of crashing or flipping the verdict (fleet/state.py FleetQueue._apply
for job frames, fleet/admission.py LeaseTable._apply for lane-lease
frames). tests/test_fleet.py and tests/test_admission.py cover the
duplicate-terminal and torn-tail cases for both frame families.
"""

# The port's copy of shadow_tpu/fleet/journal.py (host-only code; the port
# imports nothing of the reference).

from __future__ import annotations

import json
import os
import struct
import zlib

MAGIC = b"SJ"
_HEADER = struct.Struct("<2sII")   # magic, length, crc32


def fsync_dir(path: str) -> None:
    """fsync a DIRECTORY so a rename/create inside it is durable
    (POSIX: the atomic rename in checkpoint.save and the journal
    create both reach the disk only when their directory entry does).
    Best-effort on filesystems that refuse O_RDONLY dir fsync."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def encode_frame(record: dict) -> bytes:
    payload = json.dumps(record, separators=(",", ":"),
                         sort_keys=True).encode()
    return (_HEADER.pack(MAGIC, len(payload), zlib.crc32(payload))
            + payload + b"\n")


def replay(path: str) -> tuple[list, int]:
    """Read every intact frame. Returns (records, good_bytes) where
    good_bytes is the offset just past the last intact frame — a torn
    or corrupt tail (short header, short payload, CRC mismatch, bad
    magic) ends the replay there instead of raising: the tail can
    only be the frame the dying writer never finished."""
    records: list = []
    good = 0
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return records, good
    off = 0
    n = len(data)
    while off + _HEADER.size <= n:
        magic, length, crc = _HEADER.unpack_from(data, off)
        if magic != MAGIC:
            break
        end = off + _HEADER.size + length + 1   # +1 newline
        if end > n:
            break
        payload = data[off + _HEADER.size:end - 1]
        if data[end - 1:end] != b"\n" or zlib.crc32(payload) != crc:
            break
        try:
            records.append(json.loads(payload))
        except ValueError:
            break
        off = end
        good = off
    return records, good


class Journal:
    """Append handle. Opening truncates any torn tail (see replay)
    and fsyncs the parent directory if the file was just created."""

    def __init__(self, path: str, *, fsync: bool = True):
        self.path = path
        self.fsync = fsync
        existed = os.path.exists(path)
        _, good = replay(path) if existed else ([], 0)
        self._f = open(path, "ab")
        if existed and self._f.tell() > good:
            self._f.truncate(good)
            self._f.seek(good)
        if not existed:
            self._f.flush()
            os.fsync(self._f.fileno())
            fsync_dir(os.path.dirname(os.path.abspath(path)))

    def append(self, record: dict) -> None:
        self._f.write(encode_frame(record))
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
