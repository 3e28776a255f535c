"""The port's copy of shadow_tpu/hostrun/executor.py, over its own vproc.

Real-host-kernel backend: run vproc generator programs against the
actual OS.

This is the conformance half of the reference's dual-mode testing
discipline (SURVEY §4, src/test/test_launcher.c): every workload the
repo runs in-sim can also execute here, unchanged, with each virtual
process driven by a real OS thread making real syscalls — real
sockets/epoll/pipes on localhost, real blocking. Programs see the
SAME virtual namespace the simulation presents (simulated IP ints,
program-chosen port numbers, vproc fd-base layout); the mapping to
real resources happens inside this executor (hostrun/kernel.py), so
the two backends' traces line up without heavyweight rewriting
(docs/7-conformance.md).

Backend-independent syscalls (files, deterministic random, pids,
signals, fork/exec stubs) dispatch through the SAME SHARED_OPS table
the simulation uses (process/vproc.py) — identical by construction.

Known deviations from the simulated backend (see the docs matrix):
- gettime reports scaled wall time: real durations, not exact
  simulated instants (traces normalize clocks away);
- getsockopt(SO_SNDBUF/RCVBUF) returns the user-set value, masking
  Linux's doubling, to match the reference's emulated getsockopt;
- sleep-granularity asserts (test_sleep's exact-delta check) cannot
  hold on a real clock — that workload is sim-only.
"""

from __future__ import annotations

import errno as _errno
import os
import select
import socket as _socket
import threading
import time

from shadow_tpu_torch.net.sockets import MIN_RANDOM_PORT
from shadow_tpu_torch.net.state import SocketType
from shadow_tpu_torch.process.vproc import (
    EPOLL, EPOLL_FD_BASE, FILE_FD_BASE, PIPE_FD_BASE, SHARED_OPS,
    TIMER_FD_BASE, HostSideState, Sys, file_read, file_write,
    stdio_write)

from .kernel import HostTimer, PortAllocator, PortMap

_READ_CAP = 1 << 20     # cap a single real read/recv chunk


class _ProcKilled(BaseException):
    """Unhandled-signal self-delivery: unwinds the driving thread out
    of the generator (the slave_incrementPluginError analog)."""

    def __init__(self, sig):
        self.sig = sig


class _HProc:
    """One virtual process = one OS thread driving its generator.
    Duck-types the fields SHARED_OPS and _deliver_signal touch on the
    simulation's _Proc."""

    def __init__(self, host, gen, pid, start_time=0, stop_time=-1):
        self.host = host
        self.gen = gen
        self.pid = pid
        self.start_time = start_time
        self.stop_time = stop_time
        self.sig_handlers = {}
        self.last_errno = 0
        self.done = False
        self.result = None
        self.killed = None           # signal number once killed
        self.epolls = {}             # vfd -> entry (per-proc, like sim)
        self.next_epfd = EPOLL_FD_BASE
        self.finished = threading.Event()
        self.thread = None
        self.error = None


class _HMutex:
    def __init__(self):
        self.lock = threading.Lock()
        self.owner = 0
        self.meta = threading.Lock()


class _HCond:
    def __init__(self):
        self.waiters = {}            # pid -> Event, insertion = FIFO
        self.meta = threading.Lock()


class HostKernelExecutor:
    """ProcessRuntime's API shape (spawn/run/stdio_of) against the
    real kernel. `time_scale` maps simulated nanoseconds to real
    seconds for sleeps/timers/start-times (default: 1 sim second =
    50 real milliseconds)."""

    def __init__(self, bundle, time_scale: float = 0.05, trace=None,
                 portmap: PortMap | None = None):
        self.bundle = bundle
        self.cfg = bundle.cfg
        self.time_scale = float(time_scale)
        self.trace = trace
        self.portmap = portmap or PortMap(
            PortAllocator(seed=int(self.cfg.seed)))
        # identical host-side state to the simulation's: same seed ->
        # same getrandom/c_rand streams, same virtual files
        self.host_state = HostSideState(
            seed=int(self.cfg.seed), host_names=list(bundle.host_names))
        self.procs: list[_HProc] = []
        self.errors: list = []
        self._fds: dict[tuple, dict] = {}       # (host, vfd) -> entry
        self._next_sock: dict[int, int] = {}
        self._next_pipe: dict[int, int] = {}
        self._timer_alloc: dict[int, int] = {}
        self._next_eph: dict[int, int] = {}
        self._mutexes: dict[tuple, _HMutex] = {}
        self._next_mutex: dict[int, int] = {}
        self._conds: dict[tuple, _HCond] = {}
        self._next_cond: dict[int, int] = {}
        self._next_pid = 1
        self._bound: dict[tuple, int] = {}      # (real, proto) -> refs
        self._lock = threading.Lock()
        self._t0 = None
        # simulated-IP -> host index (programs address peers by the
        # sim IPs env['resolve']/gethostbyname hand them)
        self._ip_host = {int(bundle.ip_of(n)): i
                         for i, n in enumerate(bundle.host_names)}
        self._host_ip = {i: ip for ip, i in self._ip_host.items()}

    # -- registration ---------------------------------------------------

    def spawn(self, host: int, proc_fn, start_time: int = 0,
              stop_time: int = -1):
        gen = proc_fn(host)
        if not hasattr(gen, "send") or not hasattr(gen, "close"):
            raise TypeError(
                f"virtual process for host {host} returned "
                f"{type(gen).__name__}, not a generator")
        with self._lock:
            pid = self._next_pid
            self._next_pid += 1
        p = _HProc(host, gen, pid, start_time, stop_time)
        self.procs.append(p)
        return p

    def stdio_of(self, host: int, pid: int, fd: int = 1) -> bytes:
        return bytes(self.host_state.stdio.get((host, pid, fd), b""))

    # -- run loop -------------------------------------------------------

    def _scale(self, ns: int) -> float:
        return max(ns, 0) * self.time_scale / 1e9

    def run(self, wall_timeout: float | None = None):
        """Start every process thread, wait for completion, tear down
        real resources. Raises the first program error (assertion
        failures surface exactly like sim-side plugin errors)."""
        if wall_timeout is None:
            wall_timeout = self._scale(int(self.cfg.end_time)) + 30.0
        self._t0 = time.monotonic()
        for p in list(self.procs):
            self._start(p)
        deadline = time.monotonic() + wall_timeout
        stuck = []
        for p in self.procs:        # list may grow via thread_create
            remaining = max(deadline - time.monotonic(), 0.0)
            p.finished.wait(remaining)
            if not p.finished.is_set():
                stuck.append(p)
        if stuck:
            for p in self.procs:
                p.killed = p.killed or -1
            self._teardown()        # closing fds unblocks real syscalls
            for p in stuck:
                p.finished.wait(2.0)
            raise TimeoutError(
                "host-kernel run exceeded its wall budget "
                f"({wall_timeout:.1f}s); stuck: "
                f"{[(p.host, p.pid) for p in stuck]}")
        self._teardown()
        if self.errors:
            raise self.errors[0]

    def _start(self, p: _HProc):
        t = threading.Thread(target=self._drive, args=(p,), daemon=True,
                             name=f"hostrun-h{p.host}-p{p.pid}")
        p.thread = t
        t.start()

    def _drive(self, p: _HProc):
        try:
            if p.start_time > 0:
                time.sleep(self._scale(p.start_time))
            if p.stop_time >= 0:
                killer = threading.Timer(
                    self._scale(p.stop_time - p.start_time),
                    lambda: setattr(p, "killed", p.killed or -1))
                killer.daemon = True
                killer.start()
            try:
                call = next(p.gen)
                while True:
                    if p.killed is not None:
                        p.gen.close()
                        if self.trace is not None:
                            self.trace.record_exit(
                                p.host, p.pid, ("killed", p.killed))
                        return
                    result = self._exec(p, call)
                    if self.trace is not None:
                        self.trace.record(p.host, p.pid, call.op,
                                          call.args, result)
                    call = p.gen.send(result)
            except StopIteration as e:
                p.result = e.value
                if self.trace is not None:
                    self.trace.record_exit(p.host, p.pid, p.result)
        except _ProcKilled as k:
            p.killed = k.sig
            if self.trace is not None:
                self.trace.record_exit(p.host, p.pid, ("killed", k.sig))
        except BaseException as e:          # noqa: BLE001 — reported by run()
            p.error = e
            self.errors.append(e)
        finally:
            p.done = True
            p.finished.set()

    def _teardown(self):
        for key, ent in list(self._fds.items()):
            self._close_entry(ent)
        self._fds.clear()
        for p in self.procs:
            for ent in p.epolls.values():
                self._close_entry(ent)

    @staticmethod
    def _close_entry(ent):
        try:
            k = ent["kind"]
            if k == "sock":
                ent["sock"].close()
            elif k == "ep":
                ent["ep"].close()
            elif k == "timer":
                ent["t"].close()
            elif k == "chan":
                for fd in (ent.get("r"), ent.get("w")):
                    if fd is not None:
                        try:
                            os.close(fd)
                        except OSError:
                            pass
                for o in ent.get("objs", ()):
                    o.close()
        except (OSError, KeyError):
            pass

    # -- lookup helpers -------------------------------------------------

    def _entry(self, p: _HProc, vfd: int):
        if EPOLL_FD_BASE <= vfd < PIPE_FD_BASE:
            return p.epolls.get(vfd)
        return self._fds.get((p.host, vfd))

    def _realfd(self, p: _HProc, vfd: int):
        ent = self._entry(p, vfd)
        if ent is None:
            return None
        k = ent["kind"]
        if k == "sock":
            return ent["sock"].fileno()
        if k == "timer":
            return ent["t"].fileno()
        if k == "chan":
            return ent["r"] if ent.get("r") is not None else ent["w"]
        if k == "ep":
            return ent["ep"].fileno()
        return None

    def _host_of_ip(self, ip: int, default: int) -> int:
        if (ip >> 24) == 127:
            return default
        return self._ip_host.get(int(ip), default)

    def _deliver_signal(self, p: _HProc, sig: int) -> int:
        """SHARED_OPS hook: same contract as the simulation's. The
        handler runs synchronously on the calling thread; an unhandled
        signal kills the target (self-delivery unwinds immediately,
        cross-thread targets die at their next syscall boundary)."""
        handler = p.sig_handlers.get(sig)
        if handler is None:
            p.killed = sig
            cur = threading.current_thread()
            if p.thread is cur or p.thread is None:
                raise _ProcKilled(sig)
            return -1
        handler(sig)
        return 0

    # -- syscall execution ---------------------------------------------

    def _exec(self, p: _HProc, call: Sys):
        op, a = call.op, call.args
        h = p.host

        if op in SHARED_OPS:
            ready, result = SHARED_OPS[op](self.host_state, self, p, a)
            return result

        fn = getattr(self, f"_op_{op}", None)
        if fn is None:
            raise ValueError(f"host-kernel backend: unsupported op {op}")
        return fn(p, h, a)

    # sockets ----------------------------------------------------------

    @staticmethod
    def _proto(stype):
        return (_socket.SOCK_STREAM if stype == SocketType.TCP
                else _socket.SOCK_DGRAM)

    def _op_socket(self, p, h, a):
        proto = self._proto(a[0])
        try:
            s = _socket.socket(_socket.AF_INET, proto)
        except OSError:
            return -1
        s.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 0)
        with self._lock:
            vfd = self._next_sock.get(h, 0)
            self._next_sock[h] = vfd + 1
            self._fds[(h, vfd)] = {
                "kind": "sock", "sock": s, "proto": proto,
                "vbound": None, "user_buf": {}}
        return vfd

    def _op_bind(self, p, h, a):
        vfd, vport = a
        ent = self._entry(p, vfd)
        if ent is None or ent["kind"] != "sock":
            return -1
        proto = ent["proto"]
        if vport == 0:
            try:
                ent["sock"].bind(("127.0.0.1", 0))
            except OSError:
                return -1
            real = ent["sock"].getsockname()[1]
            with self._lock:
                veph = self._next_eph.get(h, MIN_RANDOM_PORT)
                self._next_eph[h] = veph + 1
            self.portmap.register_eph(h, veph, proto, real)
            self._track_bound(real, proto, +1)
            ent["vbound"] = veph
            return veph
        real = self.portmap.real_port(h, vport, proto)
        for attempt in range(4):
            try:
                ent["sock"].bind(("127.0.0.1", real))
                self._track_bound(real, proto, +1)
                ent["vbound"] = vport
                ent["real_port"] = real
                return vport
            except OSError as e:
                if e.errno != _errno.EADDRINUSE:
                    return -1        # EINVAL (re-bind of a bound socket)
                if (real, proto) in self._bound:
                    return -1        # OUR conflict: virtual EADDRINUSE
                # an outside process squats our sticky port — re-map
                # deterministically and retry (collision retry contract)
                real = self.portmap.rebind(h, vport, proto)
        return -1

    def _track_bound(self, real, proto, delta):
        with self._lock:
            key = (real, proto)
            n = self._bound.get(key, 0) + delta
            if n > 0:
                self._bound[key] = n
            else:
                self._bound.pop(key, None)

    def _op_listen(self, p, h, a):
        ent = self._entry(p, a[0])
        if ent is None or ent["kind"] != "sock":
            return -1
        ent["sock"].listen(64)
        return 0

    def _op_connect(self, p, h, a):
        vfd, ip, vport = a
        ent = self._entry(p, vfd)
        if ent is None or ent["kind"] != "sock":
            return -1
        dst = self._host_of_ip(ip, h)
        # the analog of SYN retransmission riding out a server that
        # has not bound yet — but a never-bound port is a fast RST
        real = self.portmap.wait_for(dst, vport, ent["proto"],
                                     timeout=self._scale(
                                         int(self.cfg.end_time)) + 1.0)
        if real is None:
            return -1
        try:
            ent["sock"].connect(("127.0.0.1", real))
        except OSError:
            return -1
        if ent["vbound"] is None:
            self._register_autobound(h, ent)
        return 0

    def _register_autobound(self, h, ent):
        """Record a kernel-autobound local port under a virtual
        ephemeral identity so peers can resolve it."""
        try:
            real = ent["sock"].getsockname()[1]
        except OSError:
            return
        with self._lock:
            veph = self._next_eph.get(h, MIN_RANDOM_PORT)
            self._next_eph[h] = veph + 1
        self.portmap.register_eph(h, veph, ent["proto"], real)
        ent["vbound"] = veph

    def _op_accept(self, p, h, a):
        ent = self._entry(p, a[0])
        if ent is None or ent["kind"] != "sock":
            return -1
        try:
            conn, _addr = ent["sock"].accept()
        except OSError:
            return -1
        with self._lock:
            vfd = self._next_sock.get(h, 0)
            self._next_sock[h] = vfd + 1
            self._fds[(h, vfd)] = {
                "kind": "sock", "sock": conn, "proto": ent["proto"],
                "vbound": None, "user_buf": {}}
        return vfd

    def _op_send(self, p, h, a):
        ent = self._entry(p, a[0])
        if ent is None or ent["kind"] != "sock":
            return -1
        try:
            return ent["sock"].send(b"\0" * int(a[1]))
        except OSError:
            return -1

    def _op_send_data(self, p, h, a):
        ent = self._entry(p, a[0])
        if ent is None or ent["kind"] != "sock":
            return -1
        try:
            return ent["sock"].send(bytes(a[1]))
        except OSError:
            return -1

    def _op_recv(self, p, h, a):
        ent = self._entry(p, a[0])
        if ent is None or ent["kind"] != "sock":
            return 0
        try:
            data = ent["sock"].recv(min(int(a[1]), _READ_CAP))
        except OSError:
            return 0
        return len(data)

    def _op_recv_data(self, p, h, a):
        ent = self._entry(p, a[0])
        if ent is None or ent["kind"] != "sock":
            return b""
        try:
            return ent["sock"].recv(min(int(a[1]), _READ_CAP))
        except OSError:
            return b""

    def _dst_addr(self, p, h, ent, ip, vport):
        dst = self._host_of_ip(ip, h)
        real = self.portmap.wait_for(dst, vport, ent["proto"],
                                     timeout=2.0)
        return ("127.0.0.1", real) if real is not None else None

    def _op_sendto(self, p, h, a):
        vfd, ip, vport, n = a
        return self._sendto_impl(p, h, vfd, ip, vport, b"\0" * int(n))

    def _op_sendto_data(self, p, h, a):
        vfd, ip, vport, data = a
        return self._sendto_impl(p, h, vfd, ip, vport, bytes(data))

    def _sendto_impl(self, p, h, vfd, ip, vport, payload):
        ent = self._entry(p, vfd)
        if ent is None or ent["kind"] != "sock":
            return False
        if ent["vbound"] is None:
            # a sendto on an unbound UDP socket autobinds — register
            # the identity so the receiver's recvfrom resolves us
            try:
                ent["sock"].bind(("127.0.0.1", 0))
            except OSError:
                return False
            self._register_autobound(h, ent)
        addr = self._dst_addr(p, h, ent, ip, vport)
        if addr is None:
            return False
        try:
            ent["sock"].sendto(payload, addr)
        except OSError:
            return False
        return True

    def _op_recvfrom(self, p, h, a):
        ip, vport, data = self._recvfrom_impl(p, h, a[0])
        return (ip, vport, len(data))

    def _op_recvfrom_data(self, p, h, a):
        return self._recvfrom_impl(p, h, a[0])

    def _recvfrom_impl(self, p, h, vfd):
        ent = self._entry(p, vfd)
        if ent is None or ent["kind"] != "sock":
            return (-1, -1, b"")
        data, addr = ent["sock"].recvfrom(65536)
        virt = self.portmap.virtual_of(addr[1], ent["proto"])
        if virt is None:
            return (self._host_ip.get(h, -1), -1, data)
        src_host, src_vport = virt
        return (self._host_ip.get(src_host, -1), src_vport, data)

    def _op_shutdown(self, p, h, a):
        ent = self._entry(p, a[0])
        if ent is None or ent["kind"] != "sock":
            return 0
        try:
            ent["sock"].shutdown(int(a[1]))   # SHUT_* ints match
        except OSError:
            pass
        return 0

    def _op_setsockopt(self, p, h, a):
        vfd, opt, val = a
        ent = self._entry(p, vfd)
        if ent is None or ent["kind"] != "sock":
            return -1
        if opt not in (_socket.SO_SNDBUF, _socket.SO_RCVBUF):
            return -1
        ent["sock"].setsockopt(_socket.SOL_SOCKET, opt, int(val))
        # report back the USER value: Linux doubles the stored size
        # for bookkeeping, but the emulated surface (and the
        # reference's sockbuf test) expects the set value round-trip
        ent["user_buf"][opt] = int(val)
        return 0

    def _op_getsockopt(self, p, h, a):
        vfd, opt = a
        ent = self._entry(p, vfd)
        if ent is None or ent["kind"] != "sock":
            return -1
        if opt not in (_socket.SO_SNDBUF, _socket.SO_RCVBUF):
            return -1
        if opt in ent["user_buf"]:
            return ent["user_buf"][opt]
        return ent["sock"].getsockopt(_socket.SOL_SOCKET, opt)

    def _op_ioctl_inq(self, p, h, a):
        import fcntl
        import struct
        import termios

        fd = self._realfd(p, a[0])
        if fd is None:
            return -1
        buf = fcntl.ioctl(fd, termios.FIONREAD, struct.pack("i", 0))
        return struct.unpack("i", buf)[0]

    def _op_ioctl_outq(self, p, h, a):
        import fcntl
        import struct
        import termios

        fd = self._realfd(p, a[0])
        if fd is None:
            return -1
        buf = fcntl.ioctl(fd, termios.TIOCOUTQ, struct.pack("i", 0))
        return struct.unpack("i", buf)[0]

    # time -------------------------------------------------------------

    def _op_gettime(self, p, h, a):
        return int((time.monotonic() - self._t0) / self.time_scale * 1e9)

    def _op_sleep(self, p, h, a):
        time.sleep(self._scale(int(a[0])))
        return 0

    def _op_gethostbyname(self, p, h, a):
        addr = self.bundle.dns.resolve_name(a[0])
        return addr.ip if addr is not None else -1

    # timers -----------------------------------------------------------

    def _op_timerfd_create(self, p, h, a):
        with self._lock:
            nxt = self._timer_alloc.get(h, 0)
            if nxt >= self.cfg.timers_per_host:
                return -1
            self._timer_alloc[h] = nxt + 1
            vfd = TIMER_FD_BASE + nxt
            self._fds[(h, vfd)] = {"kind": "timer",
                                   "t": HostTimer(self.time_scale)}
        return vfd

    def _op_timerfd_settime(self, p, h, a):
        ent = self._entry(p, a[0])
        if ent is None or ent["kind"] != "timer":
            return -1
        return ent["t"].settime(int(a[1]), int(a[2]))

    def _op_timerfd_read(self, p, h, a):
        ent = self._entry(p, a[0])
        if ent is None or ent["kind"] != "timer":
            return -1
        return ent["t"].read_blocking()

    # readiness --------------------------------------------------------

    def _op_wait_readable(self, p, h, a):
        pairs = [(vfd, self._realfd(p, vfd)) for vfd in a[0]]
        reals = [r for _, r in pairs if r is not None]
        rl, _, _ = select.select(reals, [], [])
        ready = set(rl)
        return [vfd for vfd, r in pairs if r in ready]

    def _sel_timeout(self, timeout_ns):
        return None if timeout_ns < 0 else self._scale(int(timeout_ns))

    def _op_poll(self, p, h, a):
        entries, timeout_ns = a
        rmap = {vfd: self._realfd(p, vfd) for vfd, _ in entries}
        rfds = [rmap[v] for v, e in entries
                if e & EPOLL.IN and rmap[v] is not None]
        wfds = [rmap[v] for v, e in entries
                if e & EPOLL.OUT and rmap[v] is not None]
        rl, wl, _ = select.select(rfds, wfds, [],
                                  self._sel_timeout(timeout_ns))
        rl, wl = set(rl), set(wl)
        out = []
        for vfd, ev in entries:
            rev = ((EPOLL.IN if rmap[vfd] in rl else 0)
                   | (EPOLL.OUT if rmap[vfd] in wl else 0)) & ev
            if rev:
                out.append((vfd, rev))
        return out

    def _op_select(self, p, h, a):
        rfds, wfds, timeout_ns = a
        rmap = {v: self._realfd(p, v) for v in tuple(rfds) + tuple(wfds)}
        rl, wl, _ = select.select(
            [rmap[v] for v in rfds if rmap[v] is not None],
            [rmap[v] for v in wfds if rmap[v] is not None], [],
            self._sel_timeout(timeout_ns))
        rl, wl = set(rl), set(wl)
        return ([v for v in rfds if rmap[v] in rl],
                [v for v in wfds if rmap[v] in wl])

    # epoll ------------------------------------------------------------

    @staticmethod
    def _ep_events(v_events: int) -> int:
        ev = 0
        if v_events & EPOLL.IN:
            ev |= select.EPOLLIN
        if v_events & EPOLL.OUT:
            ev |= select.EPOLLOUT
        if v_events & EPOLL.ET:
            ev |= select.EPOLLET
        if v_events & EPOLL.ONESHOT:
            ev |= select.EPOLLONESHOT
        return ev

    def _op_epoll_create(self, p, h, a):
        vfd = p.next_epfd
        p.next_epfd += 1
        p.epolls[vfd] = {"kind": "ep", "ep": select.epoll(), "vfds": {}}
        return vfd

    def _op_epoll_ctl(self, p, h, a):
        epfd, ctl, vfd, events = a
        ent = p.epolls.get(epfd)
        if ent is None:
            return -1
        real = self._realfd(p, vfd)
        if real is None:
            return -1
        try:
            if ctl == EPOLL.CTL_ADD:
                ent["ep"].register(real, self._ep_events(events))
                ent["vfds"][real] = vfd
            elif ctl == EPOLL.CTL_MOD:
                ent["ep"].modify(real, self._ep_events(events))
                ent["vfds"][real] = vfd
            elif ctl == EPOLL.CTL_DEL:
                ent["ep"].unregister(real)
                ent["vfds"].pop(real, None)
            else:
                return -1
        except (OSError, FileExistsError, FileNotFoundError):
            return -1               # EEXIST / ENOENT, like the sim
        return 0

    def _op_epoll_wait(self, p, h, a):
        ent = p.epolls.get(a[0])
        if ent is None:
            return []
        evs = ent["ep"].poll()      # blocks, like the vproc contract
        out = []
        for real, ev in evs:
            vfd = ent["vfds"].get(real)
            if vfd is None:
                continue
            mask = 0
            if ev & (select.EPOLLIN | select.EPOLLHUP | select.EPOLLERR):
                mask |= EPOLL.IN
            if ev & select.EPOLLOUT:
                mask |= EPOLL.OUT
            if mask:
                out.append((vfd, mask))
        return out

    # channels / files / stdio -----------------------------------------

    def _op_pipe(self, p, h, a):
        r, w = os.pipe()
        with self._lock:
            base = self._next_pipe.get(h, PIPE_FD_BASE)
            self._next_pipe[h] = base + 2
            self._fds[(h, base)] = {"kind": "chan", "r": r, "w": None}
            self._fds[(h, base + 1)] = {"kind": "chan", "r": None, "w": w}
        return (base, base + 1)

    def _op_socketpair(self, p, h, a):
        s1, s2 = _socket.socketpair()
        with self._lock:
            base = self._next_pipe.get(h, PIPE_FD_BASE)
            self._next_pipe[h] = base + 2
            self._fds[(h, base)] = {
                "kind": "chan", "r": s1.fileno(), "w": s1.fileno(),
                "objs": (s1,)}
            self._fds[(h, base + 1)] = {
                "kind": "chan", "r": s2.fileno(), "w": s2.fileno(),
                "objs": (s2,)}
        return (base, base + 1)

    def _op_write(self, p, h, a):
        vfd, data = a
        if vfd in (1, 2):
            return stdio_write(self.host_state,
                               self.bundle.host_names[h], h, p.pid,
                               vfd, bytes(data))
        if FILE_FD_BASE <= vfd < TIMER_FD_BASE:
            return file_write(self.host_state, h, vfd, bytes(data))
        ent = self._entry(p, vfd)
        if ent is None or ent["kind"] != "chan" or ent.get("w") is None:
            return -1
        try:
            return os.write(ent["w"], bytes(data))
        except BrokenPipeError:
            return -1               # EPIPE: read side closed
        except OSError:
            return -1

    def _op_read(self, p, h, a):
        vfd, maxb = a
        if FILE_FD_BASE <= vfd < TIMER_FD_BASE:
            return file_read(self.host_state, h, vfd, int(maxb))
        ent = self._entry(p, vfd)
        if ent is None or ent["kind"] != "chan" or ent.get("r") is None:
            return b""
        try:
            return os.read(ent["r"], min(int(maxb), _READ_CAP))
        except OSError:
            return b""

    def _op_close(self, p, h, a):
        vfd = a[0]
        if FILE_FD_BASE <= vfd < TIMER_FD_BASE:
            return (0 if self.host_state.file_fds.pop((h, vfd), None)
                    is not None else -1)
        if EPOLL_FD_BASE <= vfd < PIPE_FD_BASE:
            ent = p.epolls.pop(vfd, None)
            if ent is not None:
                ent["ep"].close()
            return 0
        with self._lock:
            ent = self._fds.pop((h, vfd), None)
        if ent is None:
            return 0
        if ent["kind"] == "sock" and ent.get("real_port") is not None:
            self._track_bound(ent["real_port"], ent["proto"], -1)
        self._close_entry(ent)
        return 0

    # threads / sync ---------------------------------------------------

    def _op_thread_create(self, p, h, a):
        gen = a[0](h)
        with self._lock:
            pid = self._next_pid
            self._next_pid += 1
        t = _HProc(h, gen, pid, start_time=0)
        self.procs.append(t)
        self._start(t)
        return t.pid

    def _op_thread_join(self, p, h, a):
        tgt = next((q for q in self.procs
                    if q.pid == a[0] and q.host == h), None)
        if tgt is None:
            return None
        tgt.finished.wait()
        return tgt.result

    def _op_mutex_init(self, p, h, a):
        with self._lock:
            mid = self._next_mutex.get(h, 1)
            self._next_mutex[h] = mid + 1
            self._mutexes[(h, mid)] = _HMutex()
        return mid

    def _op_mutex_lock(self, p, h, a):
        m = self._mutexes.get((h, a[0]))
        if m is None:
            return -1
        with m.meta:
            if m.owner == p.pid:
                return 0            # sim semantics: re-lock by owner
        m.lock.acquire()
        with m.meta:
            m.owner = p.pid
        return 0

    def _op_mutex_trylock(self, p, h, a):
        m = self._mutexes.get((h, a[0]))
        if m is None:
            return -1
        with m.meta:
            if m.owner == p.pid:
                return True
            if m.owner:
                return False        # EBUSY
            if not m.lock.acquire(blocking=False):
                return False
            m.owner = p.pid
            return True

    def _op_mutex_unlock(self, p, h, a):
        m = self._mutexes.get((h, a[0]))
        if m is None:
            return -1
        with m.meta:
            if m.owner != p.pid:
                return -1           # EPERM
            m.owner = 0
        m.lock.release()
        return 0

    def _op_cond_init(self, p, h, a):
        with self._lock:
            cid = self._next_cond.get(h, 1)
            self._next_cond[h] = cid + 1
            self._conds[(h, cid)] = _HCond()
        return cid

    def _op_cond_wait(self, p, h, a):
        cid, mid = a
        c = self._conds.get((h, cid))
        m = self._mutexes.get((h, mid))
        if c is None or m is None:
            return -1
        with m.meta:
            if m.owner != p.pid:
                return -1           # EPERM: must hold the mutex
        ev = threading.Event()
        with c.meta:
            c.waiters[p.pid] = ev
        self._op_mutex_unlock(p, h, (mid,))
        ev.wait()
        self._op_mutex_lock(p, h, (mid,))
        with c.meta:
            c.waiters.pop(p.pid, None)
        return 0

    def _op_cond_signal(self, p, h, a):
        c = self._conds.get((h, a[0]))
        if c is None:
            return -1
        with c.meta:
            for pid, ev in c.waiters.items():   # FIFO: oldest waiter
                if not ev.is_set():
                    ev.set()
                    break
        return 0

    def _op_cond_broadcast(self, p, h, a):
        c = self._conds.get((h, a[0]))
        if c is None:
            return -1
        with c.meta:
            for ev in c.waiters.values():
                ev.set()
        return 0
