"""The port's copy of shadow_tpu/hostrun/trace.py, over its own vproc.

Syscall trace recording + normalization for dual-mode conformance.

Both backends — the vproc simulation (process/vproc.py) and the
real-kernel executor (hostrun/executor.py) — attach the same
TraceRecorder: every COMPLETED syscall appends one raw record
(host, pid, op, args, ret), plus one exit record per process. The
normalizer then rewrites each per-process sequence into a
backend-independent canonical form the differential checker
(hostrun/diff.py) can compare exactly:

- fds -> kind-prefixed first-appearance tokens per process ("sock0",
  "pipe1", ...), retired on close so slot reuse vs fresh numbering
  cannot diverge the rename
- payload bytes -> (length, sha256-prefix) digests
- wall/sim clocks -> "T" (gettime is timing, not semantics)
- kernel-chosen ephemeral ports -> "P"
- queue depths (SIOCINQ/OUTQ) and timer expiration counts -> sign
  tokens ("+"), since both are legitimately timing-dependent
- ready-set results (epoll_wait/poll/select/wait_readable) sorted,
  and consecutive identical ready-sets separated only by stream ops
  folded to one — a wakeup-granularity difference, not a semantic one
- consecutive same-fd stream ops (send/recv/read/write families)
  coalesced into one record with summed counts / concatenated
  payload digests — partial-transfer chunking differs per backend

What stays raw is the point of the exercise: op order, success/-1
returns, port numbers programs chose, byte totals, payload content,
mutex/cond ids, pids. See docs/7-conformance.md for the full matrix.
"""

from __future__ import annotations

import hashlib
import json
import threading

from shadow_tpu_torch.process.vproc import (
    EPOLL_FD_BASE, FILE_FD_BASE, PIPE_FD_BASE, TIMER_FD_BASE)

# ops whose consecutive same-fd records coalesce (partial-transfer
# chunking is backend timing, the TOTAL is the semantics)
STREAM_OPS = frozenset((
    "send", "send_data", "recv", "recv_data", "write", "read"))
# ops returning a ready-set (order-insensitive; foldable)
READY_OPS = frozenset(("epoll_wait", "poll", "select", "wait_readable"))


def _digest(data: bytes):
    return [len(data), hashlib.sha256(bytes(data)).hexdigest()[:12]]


def _jsonable(v):
    """Best-effort canonical value for arbitrary process results."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (bytes, bytearray)):
        return _digest(v)
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return repr(v)


class TraceRecorder:
    """Thread-safe raw-record sink shared by one backend run.

    `ip_names` maps simulated IP ints to host names so addresses
    normalize to stable identities (both backends hand programs the
    same simulated IPs, so this is cosmetic-but-readable).
    """

    def __init__(self, ip_names=None):
        self.ip_names = dict(ip_names or {})
        self._records: list[tuple] = []
        self._lock = threading.Lock()

    # -- recording (hot path: raw append only) -------------------------

    def record(self, host: int, pid: int, op: str, args: tuple, ret):
        with self._lock:
            self._records.append((host, pid, op, args, ret))

    def record_exit(self, host: int, pid: int, result):
        with self._lock:
            self._records.append((host, pid, "_exit", (), result))

    # -- normalization --------------------------------------------------

    def _ip(self, ip):
        if not isinstance(ip, int):
            return _jsonable(ip)
        if (ip >> 24) == 127:
            return "loopback"
        return self.ip_names.get(ip, ip)

    def normalized(self) -> dict:
        """{'h<host>:p<pid>': [canonical records...]} — the form the
        differential checker compares."""
        with self._lock:
            records = list(self._records)
        seqs: dict[tuple, list] = {}
        for host, pid, op, args, ret in records:
            seqs.setdefault((host, pid), []).append((op, args, ret))
        out = {}
        for (host, pid), seq in sorted(seqs.items()):
            seq = _fold_ready_sets(seq)
            seq = _coalesce_streams(seq)
            out[f"h{host}:p{pid}"] = _Canonicalizer(self._ip).run(seq)
        return out

    def dump(self, path: str, meta=None) -> None:
        doc = {"meta": meta or {}, "procs": self.normalized()}
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)


def load(path: str) -> dict:
    """Load a dumped trace; returns the full {'meta', 'procs'} doc."""
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------
# raw-sequence passes (run BEFORE canonicalization so payload bytes
# are still concatenable and fds still raw-comparable)
# ---------------------------------------------------------------------

def _fold_ready_sets(seq):
    """Drop a ready-set record identical to the previous kept one when
    only stream ops sit between them: a server looping
    epoll_wait -> send with backend-specific partial-send chunking
    produces N vs M wakeups for the same semantics."""
    out = []
    last_ready = None          # index into out of last kept ready rec
    streams_only = True
    for rec in seq:
        op = rec[0]
        if op in READY_OPS:
            if (last_ready is not None and streams_only
                    and out[last_ready] == rec):
                continue
            out.append(rec)
            last_ready = len(out) - 1
            streams_only = True
            continue
        if op not in STREAM_OPS:
            last_ready = None
        out.append(rec)
    return out


def _merge(a, b):
    """Merge two same-op same-fd stream records (None = can't)."""
    op, args_a, ret_a = a
    _, args_b, ret_b = b
    if args_a[0] != args_b[0]:
        return None
    fd = args_a[0]
    if op in ("send", "recv"):
        if not (isinstance(ret_a, int) and isinstance(ret_b, int)
                and ret_a >= 0 and ret_b >= 0):
            return None
        return (op, (fd,), ret_a + ret_b)
    if op in ("send_data", "write"):
        if not (isinstance(ret_a, int) and isinstance(ret_b, int)
                and ret_a >= 0 and ret_b >= 0):
            return None
        data = bytes(args_a[1]) + bytes(args_b[1])
        return (op, (fd, data), ret_a + ret_b)
    if op in ("recv_data", "read"):
        if not (isinstance(ret_a, (bytes, bytearray))
                and isinstance(ret_b, (bytes, bytearray))):
            return None
        return (op, (fd,), bytes(ret_a) + bytes(ret_b))
    return None


def _coalesce_streams(seq):
    out = []
    for rec in seq:
        op = rec[0]
        if out and op in STREAM_OPS and out[-1][0] == op:
            merged = _merge(out[-1], rec)
            if merged is not None:
                out[-1] = merged
                continue
        # normalize stream args up front so single records and merged
        # ones share a shape: (fd,) for count-carrying, (fd, data)
        # retained for send-side payloads
        if op in ("send", "recv", "recv_data", "read"):
            rec = (op, (rec[1][0],), rec[2])
        out.append(rec)
    return out


# ---------------------------------------------------------------------
# canonicalization
# ---------------------------------------------------------------------

def _fd_kind(fd: int) -> str:
    if fd >= TIMER_FD_BASE:
        return "timer"
    if fd >= FILE_FD_BASE:
        return "file"
    if fd >= PIPE_FD_BASE:
        return "pipe"
    if fd >= EPOLL_FD_BASE:
        return "ep"
    return "sock"


class _Canonicalizer:
    """Per-process canonical rewrite (fd tokens, digests, timing
    tokens). One instance per process sequence."""

    def __init__(self, ip_fn):
        self._ip = ip_fn
        self._tok: dict[int, str] = {}
        self._counts: dict[str, int] = {}

    def tok(self, fd):
        if not isinstance(fd, int) or fd < 0:
            return fd
        t = self._tok.get(fd)
        if t is None:
            kind = _fd_kind(fd)
            n = self._counts.get(kind, 0)
            self._counts[kind] = n + 1
            t = f"{kind}{n}"
            self._tok[fd] = t
        return t

    def retire(self, fd):
        self._tok.pop(fd, None)

    def run(self, seq):
        return [self.one(op, args, ret) for op, args, ret in seq]

    def one(self, op, a, ret):
        tok = self.tok
        if op == "socket":
            return [op, [int(a[0])], tok(ret)]
        if op == "bind":
            cret = ("P" if (a[1] == 0 and isinstance(ret, int)
                            and ret > 0) else ret)
            return [op, [tok(a[0]), int(a[1])], cret]
        if op in ("listen", "accept"):
            return [op, [tok(a[0])],
                    tok(ret) if op == "accept" else ret]
        if op == "connect":
            return [op, [tok(a[0]), self._ip(a[1]), int(a[2])], ret]
        if op in ("send", "recv"):
            return [op, [tok(a[0])], ret]
        if op == "send_data":
            return [op, [tok(a[0]), _digest(a[1])], ret]
        if op == "recv_data":
            cret = _digest(ret) if isinstance(ret, (bytes, bytearray)) \
                else ret
            return [op, [tok(a[0])], cret]
        if op == "sendto":
            return [op, [tok(a[0]), self._ip(a[1]), int(a[2]), a[3]],
                    _jsonable(ret)]
        if op == "sendto_data":
            return [op, [tok(a[0]), self._ip(a[1]), int(a[2]),
                         _digest(a[3])], _jsonable(ret)]
        if op in ("recvfrom", "recvfrom_data"):
            if isinstance(ret, tuple) and len(ret) == 3:
                payload = ret[2]
                cret = [self._ip(ret[0]), "P",
                        _digest(payload)
                        if isinstance(payload, (bytes, bytearray))
                        else payload]
            else:
                cret = _jsonable(ret)
            return [op, [tok(a[0])], cret]
        if op == "close":
            t = tok(a[0])
            self.retire(a[0])
            return [op, [t], ret]
        if op == "shutdown":
            return [op, [tok(a[0]), int(a[1])], ret]
        if op == "sleep":
            return [op, [int(a[0])], ret]
        if op == "gettime":
            return [op, [], "T"]
        if op == "gethostbyname":
            return [op, [a[0]], self._ip(ret) if ret != -1 else -1]
        if op == "timerfd_create":
            return [op, [], tok(ret)]
        if op == "timerfd_settime":
            return [op, [tok(a[0]), int(a[1]), int(a[2])], ret]
        if op == "timerfd_read":
            return [op, [tok(a[0])],
                    "+" if isinstance(ret, int) and ret > 0 else ret]
        if op in ("setsockopt", "getsockopt"):
            return [op, [tok(a[0])] + [int(x) for x in a[1:]], ret]
        if op in ("ioctl_inq", "ioctl_outq"):
            return [op, [tok(a[0])],
                    "+" if isinstance(ret, int) and ret > 0 else ret]
        if op == "wait_readable":
            return [op, [sorted(tok(f) for f in a[0])],
                    sorted(tok(f) for f in ret) if isinstance(
                        ret, (list, tuple)) else ret]
        if op == "poll":
            cargs = [sorted([tok(f), int(e)] for f, e in a[0]), int(a[1])]
            cret = sorted([tok(f), int(e)] for f, e in ret) \
                if isinstance(ret, (list, tuple)) else ret
            return [op, cargs, cret]
        if op == "select":
            cargs = [sorted(tok(f) for f in a[0]),
                     sorted(tok(f) for f in a[1]), int(a[2])]
            if isinstance(ret, tuple) and len(ret) == 2:
                cret = [sorted(tok(f) for f in ret[0]),
                        sorted(tok(f) for f in ret[1])]
            else:
                cret = _jsonable(ret)
            return [op, cargs, cret]
        if op == "epoll_create":
            return [op, [], tok(ret)]
        if op == "epoll_ctl":
            return [op, [tok(a[0]), int(a[1]), tok(a[2]), int(a[3])],
                    ret]
        if op == "epoll_wait":
            cret = sorted([tok(f), int(e)] for f, e in ret) \
                if isinstance(ret, (list, tuple)) else ret
            return [op, [tok(a[0])], cret]
        if op == "fopen":
            return [op, [a[0], a[1]], tok(ret)]
        if op in ("fseek", "fstat_size"):
            return [op, [tok(a[0])] + [int(x) for x in a[1:]], ret]
        if op == "getrandom":
            return [op, [int(a[0])],
                    _digest(ret) if isinstance(ret, (bytes, bytearray))
                    else ret]
        if op == "write":
            # fds 1/2 are stdio ONLY when no live socket token claims
            # them — the socket fd space starts at 0 and overlaps (a
            # `write` never targets a socket, so a tokenized 1/2 here
            # means slot numbering, not stdio)
            if a[0] in (1, 2) and a[0] not in self._tok:
                t = "stdout" if a[0] == 1 else "stderr"
            else:
                t = tok(a[0])
            if len(a) > 1:
                return [op, [t, _digest(a[1])], ret]
            return [op, [t], ret]
        if op == "read":
            return [op, [tok(a[0])],
                    _digest(ret) if isinstance(ret, (bytes, bytearray))
                    else ret]
        if op == "sigaction":
            return [op, [int(a[0]), "handler"], ret]
        if op == "thread_create":
            return [op, ["fn"], ret]
        if op in ("pipe", "socketpair"):
            cret = [tok(ret[0]), tok(ret[1])] \
                if isinstance(ret, tuple) else ret
            return [op, [], cret]
        if op == "_exit":
            return [op, [], _jsonable(ret)]
        # default: mutex/cond/thread_join/kill/raise_sig/funlink/
        # c_rand/getpid/gethostname/fork/exec/system/errno — args are
        # already stable ints/strings across backends
        return [op, [_jsonable(x) for x in a], _jsonable(ret)]
