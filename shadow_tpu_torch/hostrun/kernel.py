"""The port's copy of shadow_tpu/hostrun/kernel.py, over its own vproc.

Real-kernel primitives for the host-run backend: deterministic
localhost port mapping and a portable timerfd stand-in.

The conformance executor (hostrun/executor.py) presents programs the
SAME virtual namespace the simulation does — simulated IP ints,
program-level port numbers, vproc fd bases — and maps them onto real
OS resources here. Keeping the mapping deterministic (seed-derived
candidate ports, sticky (vhost, vport, proto) -> real-port
assignments) is what lets bind conflicts surface as real EADDRINUSE
exactly where the simulation reports them, and lets traces normalize
without per-run noise (docs/7-conformance.md).
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time


class PortsUnavailable(RuntimeError):
    """The sandbox has no bindable localhost ports (or no loopback at
    all). Tests catch this and pytest.skip instead of flaking."""


class PortAllocator:
    """Deterministic candidate-port source with collision retry.

    Candidates are a seed-derived permutation of [base, base+span), so
    two runs of one seed probe the same sequence (stable real ports ->
    stable traces), while parallel pytest workers with different seeds
    land in different parts of the range. A candidate is validated by
    actually binding a probe socket; busy ports are skipped, and the
    executor retries through `next_port` if it loses the (tiny)
    probe-to-bind race.
    """

    def __init__(self, seed: int = 1, base: int = 23000, span: int = 20000,
                 max_probes: int = 512):
        import numpy as np

        self._rng = np.random.default_rng(
            np.random.SeedSequence([int(seed), 0x9047]))
        self.base, self.span = base, span
        self.max_probes = max_probes
        self._issued: set[int] = set()

    def _candidates(self):
        while True:
            yield self.base + int(self._rng.integers(0, self.span))

    @staticmethod
    def _probe(port: int, proto: int) -> bool:
        try:
            s = socket.socket(socket.AF_INET, proto)
        except OSError:
            raise PortsUnavailable("cannot create AF_INET sockets")
        try:
            s.bind(("127.0.0.1", port))
            return True
        except OSError:
            return False
        finally:
            s.close()

    def next_port(self, proto: int = socket.SOCK_STREAM) -> int:
        """A fresh localhost port that was free at probe time."""
        probes = 0
        for cand in self._candidates():
            if cand in self._issued:
                continue
            probes += 1
            if probes > self.max_probes:
                raise PortsUnavailable(
                    f"no free localhost port after {self.max_probes} probes")
            if self._probe(cand, proto):
                self._issued.add(cand)
                return cand

    @staticmethod
    def preflight() -> None:
        """Raise PortsUnavailable if loopback binding is impossible at
        all (no-network sandboxes) — the cheap check tests gate on."""
        try:
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        except OSError as e:
            raise PortsUnavailable(str(e))
        try:
            s.bind(("127.0.0.1", 0))
        except OSError as e:
            raise PortsUnavailable(str(e))
        finally:
            s.close()


class PortMap:
    """Sticky (vhost, vport, proto) -> real localhost port map shared
    by every process of a run.

    Stickiness is the conflict semantics: the second socket binding
    the same virtual (host, port) is pointed at the SAME real port,
    so the real kernel answers EADDRINUSE just like the simulated
    table does (_host_isInterfaceAvailable, host.c:1029-1052). The
    reverse map recovers (vhost, vport) from a real peer address for
    recvfrom/getpeername-shaped results.
    """

    def __init__(self, alloc: PortAllocator):
        self.alloc = alloc
        self._fwd: dict[tuple, int] = {}    # (vhost, vport, proto) -> real
        self._rev: dict[tuple, tuple] = {}  # (real, proto) -> (vhost, vport)
        self._lock = threading.Lock()

    def real_port(self, vhost: int, vport: int, proto: int) -> int:
        """The real port assigned to a virtual (host, port); allocates
        on first use, returns the recorded one after."""
        key = (vhost, vport, proto)
        with self._lock:
            real = self._fwd.get(key)
            if real is None:
                real = self.alloc.next_port(proto)
                self._fwd[key] = real
                self._rev[(real, proto)] = (vhost, vport)
            return real

    def rebind(self, vhost: int, vport: int, proto: int) -> int:
        """Replace a stale assignment (probe-to-bind race lost): drop
        the recorded real port and allocate a fresh one."""
        key = (vhost, vport, proto)
        with self._lock:
            old = self._fwd.pop(key, None)
            if old is not None:
                self._rev.pop((old, proto), None)
        return self.real_port(vhost, vport, proto)

    def register_eph(self, vhost: int, vport: int, proto: int,
                     real: int) -> None:
        """Record a kernel-assigned ephemeral real port under its
        virtual identity (so peers resolve it in recvfrom)."""
        with self._lock:
            self._fwd[(vhost, vport, proto)] = real
            self._rev[(real, proto)] = (vhost, vport)

    def virtual_of(self, real: int, proto: int):
        """(vhost, vport) of a real port, or None if unregistered."""
        with self._lock:
            return self._rev.get((real, proto))

    def wait_for(self, vhost: int, vport: int, proto: int,
                 timeout: float = 5.0):
        """Block until (vhost, vport) has a real assignment — the
        analog of SYN retransmission riding out a not-yet-listening
        server. Returns the real port, or None on timeout."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                real = self._fwd.get((vhost, vport, proto))
            if real is not None:
                return real
            if time.monotonic() >= deadline:
                return None
            time.sleep(0.005)


class HostTimer:
    """timerfd stand-in built from a socketpair + threading.Timer
    (os.timerfd_create only exists from Python 3.13; this runs
    anywhere). The read end is a real fd — epoll/select/poll see it —
    and each expiration feeds one 8-byte count, so a blocking read
    returns the expirations since the last read, like timerfd(2).

    `time_scale` converts virtual nanoseconds to real seconds (the
    same factor the executor applies to sleep), so a 1 s virtual
    timer fires after time_scale real seconds.
    """

    def __init__(self, time_scale: float):
        self.time_scale = time_scale
        self._r, self._w = socket.socketpair()
        self._r.setblocking(True)
        self._timer: threading.Timer | None = None
        self._lock = threading.Lock()
        self._interval_ns = 0
        self._closed = False

    def fileno(self) -> int:
        return self._r.fileno()

    def _fire(self):
        with self._lock:
            if self._closed:
                return
            try:
                self._w.send(struct.pack("<Q", 1))
            except OSError:
                return
            if self._interval_ns > 0:
                self._timer = threading.Timer(
                    self._interval_ns * self.time_scale / 1e9, self._fire)
                self._timer.daemon = True
                self._timer.start()

    def _drain(self) -> int:
        """Nonblocking: consume and sum queued expiration counts."""
        total = 0
        self._r.setblocking(False)
        try:
            while True:
                try:
                    chunk = self._r.recv(8)
                except BlockingIOError:
                    break
                if not chunk:
                    break
                total += struct.unpack("<Q", chunk.ljust(8, b"\0"))[0]
        finally:
            self._r.setblocking(True)
        return total

    def settime(self, expire_ns: int, interval_ns: int = 0) -> int:
        """Arm (relative expire + optional interval, timerfd(2)
        default semantics) or disarm with expire_ns == 0. Disarm also
        discards not-yet-read expirations, matching the simulated
        timer_disarm invalidating in-flight fires."""
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            self._interval_ns = int(interval_ns)
            if expire_ns == 0:
                self._drain()
                return 0
            self._timer = threading.Timer(
                int(expire_ns) * self.time_scale / 1e9, self._fire)
            self._timer.daemon = True
            self._timer.start()
            return 0

    def read_blocking(self) -> int:
        """Block until >=1 expiration, return the count since the last
        read (the timerfd read contract)."""
        chunk = self._r.recv(8)
        if not chunk:
            return 0
        total = struct.unpack("<Q", chunk.ljust(8, b"\0"))[0]
        return total + self._drain()

    def close(self):
        with self._lock:
            self._closed = True
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
        for s in (self._r, self._w):
            try:
                s.close()
            except OSError:
                pass


def pipe_pair():
    """A real unidirectional pipe: (read_fd, write_fd) raw fds."""
    return os.pipe()
