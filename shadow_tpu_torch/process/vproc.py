"""Virtual processes: host-side Python coroutines against a
simulated-syscall surface (PyTorch port of shadow_tpu/process/vproc.py).

This is the TPU-native replacement for the reference's L5 — the
interposition stack that loads real ELF binaries into linker
namespaces, interposes their libc calls, and runs them on cooperative
green threads (ref: process.c:1055-1195, interposer.c:37-170,
src/external/rpth). A TPU cannot dlmopen a Linux binary, so
applications are written as Python generator coroutines that *yield
syscalls* — the same contract as the ~400 process_emu_* entry points
(ref: process.h:103-437) with the same blocking semantics: a blocking
call suspends the coroutine (the rpth green-thread block,
pth_high.c) until the simulated kernel marks it runnable again
(the epoll notify -> process_continue chain, epoll.c:638-680,
process.c:1197-1275).

Scheduling granularity — an explicit deviation from the reference:
coroutines are resumed at conservative-window boundaries, not at
individual events. The device drains a whole window, the runtime
fetches readiness state once, and every runnable coroutine advances
until it blocks (the analog of `pth_yield` until all threads block,
process.c:1227-1229). Syscall effects are applied at the next window
start time. This batching is what makes host<->device traffic feasible
(SURVEY.md §7.4.4); latency-critical apps should be written as
on-device handler models instead (apps/pingpong, apps/bulk,
apps/phold).

Determinism: coroutines resume in host-id order, syscalls apply in
resume order, and window boundaries are deterministic — so runs are
exactly reproducible, and equal to the reference's run for run: the
same syscalls, the same device dispatches in the same order, the same
payload-pool ids.

The port runs each window eagerly through core/engine.py step_window
(the reference compiles it with jax.jit). Host reads: the readiness
planes (sk_flags, sk_in_gen, sk_out_gen) and tcp.st are fetched at
most once between state mutations, as in the reference; each batched
syscall reads its per-host results back in one copy; the next window
start is step_window's own when no syscall has touched the queues
since the window. A coroutine must yield this module's Sys: a Sys of
another package raises TypeError where the scheduler first sees it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Generator, Optional

import numpy as np
import torch

from shadow_tpu_torch.core import simtime
from shadow_tpu_torch.core.engine import EngineStats, step_window
from shadow_tpu_torch.core.events import EmitBuffer, apply_emissions
from shadow_tpu_torch.net import nic
from shadow_tpu_torch.net import tcp as tcpmod
from shadow_tpu_torch.net import timers as timermod
from shadow_tpu_torch.net import udp as udpmod
from shadow_tpu_torch.net.rings import gather_hs, set_hs
from shadow_tpu_torch.net.sockets import sk_bind, sk_create
from shadow_tpu_torch.net.state import NetConfig, SocketFlags, SocketType
from shadow_tpu_torch.net.step import make_step_fn

I32 = torch.int32
I64 = torch.int64


def _np(t: torch.Tensor) -> np.ndarray:
    """A device tensor as a host array (one device-to-host copy)."""
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------
# syscall surface (the process_emu_* contract, ref: process.h:103-437)
# ---------------------------------------------------------------------

@dataclass(frozen=True)
class Sys:
    """One yielded syscall. Coroutines receive the result as the value
    of the `yield` expression."""

    op: str
    args: tuple = ()


def socket(stype=SocketType.UDP):
    return Sys("socket", (stype,))


def bind(fd, port):
    return Sys("bind", (fd, port))


def listen(fd):
    return Sys("listen", (fd,))


def connect(fd, ip, port):
    """TCP active open; blocks until ESTABLISHED (or reset -> -1)."""
    return Sys("connect", (fd, ip, port))


def accept(fd):
    """Blocks until a child is queued; returns the child fd."""
    return Sys("accept", (fd,))


def send(fd, nbytes):
    """TCP stream send; blocks until >0 bytes are accepted, returns
    that count (partial sends happen when the send buffer is near
    full)."""
    return Sys("send", (fd, nbytes))


def sendto(fd, ip, port, nbytes):
    """UDP datagram send; non-blocking, returns True if queued."""
    return Sys("sendto", (fd, ip, port, nbytes))


def recv(fd, maxbytes=1 << 30):
    """Blocks until data (returns byte count) or EOF (returns 0)."""
    return Sys("recv", (fd, maxbytes))


def recvfrom(fd):
    """UDP receive; blocks until a datagram arrives, returns
    (src_ip, src_port, nbytes)."""
    return Sys("recvfrom", (fd,))


def send_data(fd, data: bytes):
    """TCP stream send carrying REAL content (ref: the reference's
    plugins send actual buffers; payload bytes live host-side in the
    payload pool / stream store, payload.c:17-30). Blocks until >0
    bytes are accepted, returns that count; resend data[count:] for
    the remainder."""
    return Sys("send_data", (fd, data))


def recv_data(fd, maxbytes=1 << 30):
    """TCP stream receive returning actual bytes. Blocks until data
    (returns non-empty bytes) or EOF (returns b"")."""
    return Sys("recv_data", (fd, maxbytes))


def sendto_data(fd, ip, port, data: bytes):
    """UDP datagram send with real content: bytes go into the payload
    pool, the device packet carries the pool ref (W_PAYREF,
    packetfmt.py; mirrors Payload sharing, payload.c:17-30).
    Non-blocking, returns True if queued."""
    return Sys("sendto_data", (fd, ip, port, data))


def recvfrom_data(fd):
    """UDP receive with content; blocks until a datagram arrives,
    returns (src_ip, src_port, data). Datagrams sent without content
    (sendto) yield zero bytes of the advertised length."""
    return Sys("recvfrom_data", (fd,))


def close(fd):
    return Sys("close", (fd,))


SHUT_RD, SHUT_WR, SHUT_RDWR = 0, 1, 2


def shutdown(fd, how=SHUT_WR):
    """shutdown(2) analog (ref: process_emu_shutdown). SHUT_WR sends
    FIN behind any queued data while the fd stays readable — the
    half-close the reference's shutdown/ test exercises. SHUT_RD is a
    local no-op (arriving data is still buffered, like Linux);
    SHUT_RDWR behaves as SHUT_WR."""
    return Sys("shutdown", (fd, how))


def sleep(ns):
    """nanosleep (ref: process_emu_nanosleep -> pth_nanosleep,
    process.c:3141-3148); wakes at the first window boundary >= the
    deadline."""
    return Sys("sleep", (ns,))


def gettime():
    """gettimeofday/clock_gettime analog: the current sim time in ns
    (ref: worker_getEmulatedTime, worker.c:385-390)."""
    return Sys("gettime", ())


def gethostbyname(name: str):
    """Runtime name resolution through the simulation's DNS registry
    (ref: process_emu_gethostbyname family, process.h:237-250, backed
    by dns_resolveNameToAddress, dns.c). Returns the host's network IP
    as an int, or -1 when the name is not registered — so configs can
    address peers by hostname instead of IP hint, exactly as reference
    plugins do."""
    return Sys("gethostbyname", (name,))


def getaddrinfo(name: str):
    """Alias of gethostbyname for the modern-API spelling the
    reference also interposes (process_emu_getaddrinfo)."""
    return Sys("gethostbyname", (name,))


TIMER_FD_BASE = 1 << 19   # timerfd handles above the pipe space


def timerfd_create():
    """timerfd_create() analog: allocates one of the host's
    cfg.timers_per_host timer slots (ref: timer.c / host_createDescriptor
    DT_TIMER). Returns a timer fd, or -1 when slots are exhausted."""
    return Sys("timerfd_create", ())


def timerfd_settime(tfd, expire_ns, interval_ns=0):
    """Arm to fire at ABSOLUTE sim time expire_ns, then every
    interval_ns (0 = one-shot); expire_ns 0 disarms (ref:
    timer_setTime, timer.c:201-...)."""
    return Sys("timerfd_settime", (tfd, expire_ns, interval_ns))


def timerfd_read(tfd):
    """Blocking timerfd read: waits until >=1 expiration, returns the
    expiration count since the last read (ref: timer read semantics,
    timer.c)."""
    return Sys("timerfd_read", (tfd,))


class SO:
    """setsockopt/getsockopt option names (the SOL_SOCKET subset the
    reference's sockbuf test exercises, test_sockbuf.c:57-88)."""

    SNDBUF = 7   # Linux SO_SNDBUF
    RCVBUF = 8   # Linux SO_RCVBUF


def setsockopt(fd, opt, value):
    """Set SO_SNDBUF/SO_RCVBUF. Like the reference, pinning a buffer
    size disables that direction's TCP autotuning (the user-override
    rule, master.c:355-364 / tcp.c:407-592)."""
    return Sys("setsockopt", (fd, opt, value))


def getsockopt(fd, opt):
    return Sys("getsockopt", (fd, opt))


def ioctl_inq(fd):
    """ioctl(FIONREAD/SIOCINQ): bytes available to read (TCP: in-order
    stream bytes awaiting recv; UDP: buffered datagram bytes)."""
    return Sys("ioctl_inq", (fd,))


def ioctl_outq(fd):
    """ioctl(SIOCOUTQ/TIOCOUTQ): unsent+unacked output bytes (TCP) or
    queued datagram bytes (UDP)."""
    return Sys("ioctl_outq", (fd,))


def wait_readable(fds):
    """Convenience: blocks until one of `fds` is readable, returns the
    list of readable fds (a level-triggered EPOLLIN wait without an
    explicit epoll object)."""
    return Sys("wait_readable", (tuple(fds),))


def poll_fds(fds, timeout_ns: int = -1):
    """poll(2) (ref: host_poll, host.c:949-1009): fds is a sequence of
    (fd, events) with events an EPOLL.IN|OUT mask (POLLIN/POLLOUT).
    Returns [(fd, revents), ...] for ready fds — empty list on
    timeout. timeout_ns < 0 blocks until ready; 0 polls without
    blocking (may return [])."""
    return Sys("poll", (tuple(tuple(x) for x in fds), int(timeout_ns)))


def select_fds(rfds, wfds, timeout_ns: int = -1):
    """select(2) (ref: host_select, host.c:852-947): returns
    (readable, writable) fd lists; ([], []) on timeout. Same timeout
    semantics as poll_fds."""
    return Sys("select", (tuple(rfds), tuple(wfds), int(timeout_ns)))


# ---------------------------------------------------------------------
# epoll: the readiness engine (ref: descriptor/epoll.c)
# ---------------------------------------------------------------------
#
# The reference's epoll is the app-wakeup spine: descriptor status
# changes notify EpollWatches, which schedule a task that re-enters
# process_continue (epoll.c:583-680). Here the *status* half lives on
# device (SocketFlags.READABLE/WRITABLE maintained by the netstack —
# udp_deliver/udp_recv, tcp data/ACK paths, sk_enqueue_out, NIC drain)
# and the *watch* half is host-side per-process state polled at
# window-boundary resumption. Level/edge/oneshot flag algebra follows
# epoll.c:24-67; an epoll is itself watchable (nesting, epoll.c:96-98)
# — its readiness is "has at least one ready watch".
#
# Edge-trigger granularity — an explicit deviation: edges are detected
# between consecutive polls of the same watch (readiness transitions
# within one conservative window collapse), consistent with the
# window-batched scheduling model described in the module docstring.

class EPOLL:
    IN = 1        # maps to SocketFlags.READABLE
    OUT = 2       # maps to SocketFlags.WRITABLE
    ET = 4        # edge-triggered
    ONESHOT = 8   # disarm after first report (re-arm via MOD)
    CTL_ADD = 1
    CTL_MOD = 2
    CTL_DEL = 3


EPOLL_FD_BASE = 1 << 16   # epoll fds live above the socket-slot space
PIPE_FD_BASE = 1 << 17    # pipe/socketpair fds above the epoll space
FILE_FD_BASE = 1 << 18    # virtual-filesystem fds above the pipe space


# ---------------------------------------------------------------------
# r5 surface breadth (VERDICT r4 #4): files, random, signals, threads
# (ref: process.h:103-437 — the process_emu_{open,read,write,rand,
# kill,sigaction,...} families, and rpth's pthread layer,
# src/external/rpth/pthread.c)
# ---------------------------------------------------------------------

# signal numbers the reference tests exercise (src/test/signal,
# src/test/unistd)
SIGUSR1 = 10
SIGSEGV = 11
SIGUSR2 = 12

SEEK_SET, SEEK_CUR, SEEK_END = 0, 1, 2


def fopen(path: str, mode: str = "r"):
    """open/fopen analog on the host's virtual filesystem (ref:
    process_emu_open/fopen; the reference redirects relative paths
    into the host's data directory, process.c). Returns fd or -1
    (ENOENT for "r" on a missing file). Files are per-HOST like
    channels (the fork-inherited-descriptor analog)."""
    return Sys("fopen", (path, mode))


def funlink(path: str):
    """unlink(2) analog; returns 0 or -1 (ENOENT)."""
    return Sys("funlink", (path,))


def fseek(fd, off: int, whence: int = SEEK_SET):
    """lseek(2) analog; returns the new offset or -1."""
    return Sys("fseek", (fd, off, whence))


def fstat_size(fd):
    """fstat(2) st_size; returns the size or -1 (EBADF)."""
    return Sys("fstat_size", (fd,))


def getrandom(n: int):
    """getrandom(2) / read of /dev/urandom: n bytes from the host's
    deterministic random source (ref: the reference seeds each host's
    random from the master seed hierarchy, host.c random; two runs of
    one seed return identical streams)."""
    return Sys("getrandom", (n,))


def c_rand():
    """rand(3) analog from the same per-host source: [0, 2**31)."""
    return Sys("c_rand", ())


def getpid():
    """Returns the virtual pid (spawn order, 1-based — the reference
    hands plugins their per-process id the same way)."""
    return Sys("getpid", ())


def gethostname():
    """Returns the host's configured name (ref:
    process_emu_gethostname reads the Host's name, process.c)."""
    return Sys("gethostname", ())


def sigaction(sig: int, handler):
    """Install `handler(signum)` for sig (ref: process_emu_sigaction;
    handlers run host-side at delivery, the pth-dispatched handler
    analog). Returns 0."""
    return Sys("sigaction", (sig, handler))


def raise_sig(sig: int):
    """raise(3): deliver sig to the calling process — the installed
    handler runs before this returns. An unhandled signal kills the
    process (the plugin-error path, slave.c:468-473). Returns 0 if
    handled."""
    return Sys("raise_sig", (sig,))


def kill(pid: int, sig: int):
    """kill(2) to a virtual pid on the SAME host (ref:
    process_emu_kill; cross-host signals don't exist). Returns 0, or
    -1 (ESRCH) for an unknown/foreign pid."""
    return Sys("kill", (pid, sig))


def thread_create(fn):
    """pthread_create analog: start `fn(host)` — a generator yielding
    vproc syscalls — as another coroutine of the SAME process context
    (shared host fds/channels/files; ref: rpth pthread_create spawns
    a green thread in the process's pth scheduler). Returns its tid."""
    return Sys("thread_create", (fn,))


def thread_join(tid: int):
    """pthread_join analog: blocks until the thread's coroutine
    completes; returns its StopIteration value (or None)."""
    return Sys("thread_join", (tid,))


def mutex_init():
    """pthread_mutex_init analog (host-scoped like fds); returns a
    mutex id."""
    return Sys("mutex_init", ())


def mutex_lock(mid: int):
    """Blocks until acquired (ref: rpth pth_mutex_acquire — green
    threads interleave only at yield points, so the lock serializes
    critical sections across this host's coroutines)."""
    return Sys("mutex_lock", (mid,))


def mutex_trylock(mid: int):
    """Returns True if acquired, False if held (EBUSY)."""
    return Sys("mutex_trylock", (mid,))


def mutex_unlock(mid: int):
    return Sys("mutex_unlock", (mid,))


def cond_init():
    """pthread_cond_init analog (host-scoped like mutexes); returns a
    condition id (ref: rpth pth_cond_init, src/external/rpth
    pthread.c cond family)."""
    return Sys("cond_init", ())


def cond_wait(cid: int, mid: int):
    """pthread_cond_wait analog with rpth semantics (rpth pthread.c:
    pthread_cond_wait -> pth_cond_await with the bound mutex):
    atomically releases the HELD mutex `mid`, blocks until signaled,
    then re-acquires the mutex before returning 0. Calling without
    owning the mutex returns -1 (EPERM)."""
    return Sys("cond_wait", (cid, mid))


def cond_signal(cid: int):
    """Wake the oldest waiter (FIFO, the deterministic analog of
    pth_cond_notify's single-wake); a signal with no waiters is lost,
    like the real thing. Returns 0."""
    return Sys("cond_signal", (cid,))


def cond_broadcast(cid: int):
    """Wake ALL current waiters (pth_cond_notify broadcast=TRUE).
    Each re-acquires the mutex in turn. Returns 0."""
    return Sys("cond_broadcast", (cid,))


# errno values the emulated surface reports (the subset the
# reference's process_emu_* stubs return, process.h:103-437 — calls
# whose mechanism shadow cannot virtualize set ENOSYS and return -1
# via the process_undefined.h stub path)
ENOENT = 2
ESRCH = 3
ECHILD = 10
EAGAIN = 11
ENOSYS = 38


def fork():
    """fork(2): the reference cannot fork a plugin (a forked child
    would escape the simulation — the interposed call warns and
    returns -1/ENOSYS, the process_undefined stub behavior). Returns
    -1; get_errno() reports ENOSYS."""
    return Sys("fork", ())


def execv(path: str, argv=()):
    """execve(2) family: same unsupported-call contract as fork —
    returns -1/ENOSYS instead of raising (a real exec would replace
    the worker process image)."""
    return Sys("exec", (path, tuple(argv)))


def system(cmd: str):
    """system(3) is fork+exec+wait; unsupported the same way. Returns
    -1; get_errno() reports ENOSYS."""
    return Sys("system", (cmd,))


def get_errno():
    """The calling process's last emulated errno (the
    __errno_location analog the reference resolves per plugin,
    process.c:88-106); 0 when no failed call has set one."""
    return Sys("errno", ())


def pipe():
    """Unidirectional intra-host byte conduit; returns (rfd, wfd)
    (ref: Channel, channel.c:22-60 — two linked descriptors over a
    ByteQueue). Fds are per-HOST: another process on the same host may
    use them (the fork-inherited-descriptor analog)."""
    return Sys("pipe", ())


def socketpair():
    """Bidirectional intra-host conduit; returns (fd1, fd2) — two
    cross-linked channels (ref: channel_new CT_NONE pair +
    channel_setLinkedChannel, channel.c:147-180)."""
    return Sys("socketpair", ())


def write(fd, data: bytes):
    """Write bytes to a pipe/socketpair fd; blocks while the channel
    buffer is full, returns the count accepted (partial writes
    happen); returns -1 when the read side is closed (EPIPE)."""
    return Sys("write", (fd, data))


def read(fd, maxbytes=1 << 30):
    """Read from a pipe/socketpair fd; blocks until data (returns
    bytes) or writer-closed EOF (returns b"")."""
    return Sys("read", (fd, maxbytes))


def epoll_create():
    """Returns an epoll fd (ref: epoll_new, epoll.c)."""
    return Sys("epoll_create", ())


def epoll_ctl(epfd, op, fd, events=0):
    """op in {EPOLL.CTL_ADD, CTL_MOD, CTL_DEL}; events is a mask of
    EPOLL.IN|OUT plus EPOLL.ET/ONESHOT behavior flags
    (ref: epoll_control, epoll.c)."""
    return Sys("epoll_ctl", (epfd, op, fd, events))


def epoll_wait(epfd):
    """Blocks until at least one watch reports; returns a list of
    (fd, ready_mask) pairs (ref: epoll_getEvents + the notify ->
    process_continue chain, epoll.c:344-366,638-680)."""
    return Sys("epoll_wait", (epfd,))


@dataclass
class _EpollWatch:
    interest: int         # EPOLL.IN|OUT
    flags: int            # EPOLL.ET|ONESHOT
    # Edge bases: the readiness generations consumed by the previous
    # poll. -1 = never polled, so readiness present at ADD time is
    # reported once (Linux's ep_insert queues an initial event for a
    # ready fd). New arrivals bump the device-side generation, so an
    # already-readable socket still edges on each arrival.
    prev_in_gen: int = -1
    prev_out_gen: int = -1
    armed: bool = True    # oneshot disarm state


@dataclass
class _Epoll:
    watches: "dict[int, _EpollWatch]" = field(default_factory=dict)


# ---------------------------------------------------------------------
# channels: pipe / socketpair (ref: descriptor/channel.c)
# ---------------------------------------------------------------------

CHANNEL_CAP = 65536   # per-direction buffer limit (ref: the ByteQueue
                      # capacity channels enforce, channel.c:22-60)


@dataclass
class _ByteQ:
    """One direction of a channel — the ByteQueue the two linked
    descriptors share (ref: channel.c:22-60). Host-side only: channel
    traffic never touches the simulated network, matching the
    reference where Channel bypasses the NIC entirely."""
    buf: bytearray = field(default_factory=bytearray)
    cap: int = CHANNEL_CAP
    writers: int = 1
    readers: int = 1
    in_gen: int = 0    # bumped on write/writer-close (readability edge)
    out_gen: int = 0   # bumped on read/reader-close (writability edge)


@dataclass
class _ChanEnd:
    """What one pipe/socketpair fd can do: read from recv_q, write to
    send_q (pipe ends have one of the two, socketpair ends both)."""
    recv_q: "Optional[_ByteQ]" = None
    send_q: "Optional[_ByteQ]" = None


# ---------------------------------------------------------------------
# shared op table: backend-independent host-side kernel state
# ---------------------------------------------------------------------
#
# These syscalls never touch the device OR the real kernel — files,
# the deterministic random source, pids, hostnames, signals, and the
# unsupported-call stubs. The simulation backend (ProcessRuntime) and
# the real-host-kernel backend (hostrun.executor.HostKernelExecutor)
# dispatch them through ONE table, so the two backends cannot drift on
# this surface — the conformance subsystem (docs/7-conformance.md)
# then only has to validate the ops that genuinely differ per backend.


@dataclass
class HostSideState:
    """Per-run state behind the shared ops (the host-side half of the
    reference's Host: data-dir files, the per-host Random, per-process
    stdout/stderr — host.c / process.c)."""

    seed: int
    host_names: list
    data_dir: Optional[str] = None
    fs: dict = field(default_factory=dict)          # (host, path) -> bytearray
    file_fds: dict = field(default_factory=dict)    # (host, fd) -> cursor
    next_file_fd: dict = field(default_factory=dict)
    rand: dict = field(default_factory=dict)        # host -> np Generator
    stdio: dict = field(default_factory=dict)       # (host, pid, fd)


def host_rand(st: HostSideState, h: int) -> "np.random.Generator":
    """The host's deterministic random source (ref: each Host gets
    its own Random seeded from the master seed, host.c) — derived
    from (seed, host), so runs of one seed are bit-identical, hosts
    are independent, and BOTH backends draw the same stream."""
    g = st.rand.get(h)
    if g is None:
        g = np.random.default_rng(
            np.random.SeedSequence([int(st.seed), 0x5EED, h]))
        st.rand[h] = g
    return g


def file_open(st: HostSideState, h: int, path: str, mode: str) -> int:
    exists = (h, path) in st.fs
    if mode.startswith("r") and not exists:
        return -1                 # ENOENT ("r" and "r+" both
                                  # require the file to exist)
    if mode in ("w", "w+") or not exists:
        st.fs[(h, path)] = bytearray()
    fd = st.next_file_fd.get(h, FILE_FD_BASE)
    st.next_file_fd[h] = fd + 1
    st.file_fds[(h, fd)] = {
        "path": path, "pos": 0,
        "rd": mode in ("r", "r+", "w+", "a+"),
        "wr": mode not in ("r",)}
    if mode in ("a", "a+"):
        st.file_fds[(h, fd)]["pos"] = len(st.fs[(h, path)])
    return fd


def file_write(st: HostSideState, h: int, fd: int, data: bytes) -> int:
    ent = st.file_fds.get((h, fd))
    if ent is None or not ent["wr"]:
        return -1                      # EBADF
    buf = st.fs.setdefault((h, ent["path"]), bytearray())
    pos = ent["pos"]
    if pos > len(buf):
        buf.extend(b"\0" * (pos - len(buf)))
    buf[pos:pos + len(data)] = data
    ent["pos"] = pos + len(data)
    return len(data)


def file_read(st: HostSideState, h: int, fd: int, maxb: int):
    ent = st.file_fds.get((h, fd))
    if ent is None or not ent["rd"]:
        return -1                      # EBADF
    buf = st.fs.get((h, ent["path"]), b"")
    pos = ent["pos"]
    out = bytes(buf[pos:pos + maxb])
    ent["pos"] = pos + len(out)
    return out


def stdio_write(st: HostSideState, host_name: str, host: int, pid: int,
                fd: int, data: bytes) -> int:
    """Per-process stdout/stderr (ref: process.c's per-process
    <data>/hosts/<name>/*.stdout|stderr files): buffered in memory,
    appended to real files when data_dir is set."""
    key = (host, pid, fd)
    st.stdio.setdefault(key, bytearray()).extend(data)
    if st.data_dir is not None:
        import os

        d = os.path.join(st.data_dir, "hosts", host_name)
        os.makedirs(d, exist_ok=True)
        suffix = "stdout" if fd == 1 else "stderr"
        with open(os.path.join(d, f"proc{pid}.{suffix}"), "ab") as f:
            f.write(data)
    return len(data)


def _op_fopen(st, rt, p, a):
    return True, file_open(st, p.host, a[0], a[1])


def _op_funlink(st, rt, p, a):
    if st.fs.pop((p.host, a[0]), None) is not None:
        return True, 0
    p.last_errno = ENOENT
    return True, -1


def _op_fseek(st, rt, p, a):
    ent = st.file_fds.get((p.host, a[0]))
    if ent is None:
        return True, -1           # EBADF
    off, whence = a[1], a[2]
    size = len(st.fs.get((p.host, ent["path"]), b""))
    base = (0 if whence == SEEK_SET
            else ent["pos"] if whence == SEEK_CUR else size)
    if base + off < 0:
        return True, -1           # EINVAL
    ent["pos"] = base + off
    return True, ent["pos"]


def _op_fstat_size(st, rt, p, a):
    ent = st.file_fds.get((p.host, a[0]))
    if ent is None:
        return True, -1
    return True, len(st.fs.get((p.host, ent["path"]), b""))


def _op_getrandom(st, rt, p, a):
    return True, host_rand(st, p.host).bytes(a[0])


def _op_c_rand(st, rt, p, a):
    return True, int(host_rand(st, p.host).integers(0, 1 << 31))


def _op_getpid(st, rt, p, a):
    return True, p.pid


def _op_gethostname(st, rt, p, a):
    return True, st.host_names[p.host]


def _op_sigaction(st, rt, p, a):
    p.sig_handlers[a[0]] = a[1]
    return True, 0


def _op_raise_sig(st, rt, p, a):
    return True, rt._deliver_signal(p, a[0])


def _op_kill(st, rt, p, a):
    pid, sig = a
    tgt = next((q for q in rt.procs
                if q.pid == pid and q.host == p.host and not q.done),
               None)
    if tgt is None:
        p.last_errno = ESRCH
        return True, -1           # ESRCH
    return True, rt._deliver_signal(tgt, sig)


def _op_unsupported(st, rt, p, a):
    """fork/exec/system: the reference interposes these and fails
    them with ENOSYS rather than letting a plugin escape the
    simulation (the process_undefined.h stub contract,
    process.h:103-437) — return the errno instead of raising."""
    p.last_errno = ENOSYS
    return True, -1


def _op_errno(st, rt, p, a):
    return True, p.last_errno


# the shared table: op -> fn(state, runtime, proc, args). `runtime`
# is duck-typed (.procs, ._deliver_signal) so both backends qualify.
SHARED_OPS = {
    "fopen": _op_fopen,
    "funlink": _op_funlink,
    "fseek": _op_fseek,
    "fstat_size": _op_fstat_size,
    "getrandom": _op_getrandom,
    "c_rand": _op_c_rand,
    "getpid": _op_getpid,
    "gethostname": _op_gethostname,
    "sigaction": _op_sigaction,
    "raise_sig": _op_raise_sig,
    "kill": _op_kill,
    "fork": _op_unsupported,
    "exec": _op_unsupported,
    "system": _op_unsupported,
    "errno": _op_errno,
}


# ---------------------------------------------------------------------
# runtime
# ---------------------------------------------------------------------

ProcFn = Callable[..., Generator]  # called as proc_fn(host_id) -> generator


def _checked(p, call):
    """A coroutine's yield, held to this module's Sys (None ends the
    process, as in the reference). A Sys of another package — a plugin
    that imported the reference's vproc — is refused by name rather
    than run."""
    if call is None or isinstance(call, Sys):
        return call
    raise TypeError(
        f"virtual process {p.pid} on host {p.host} yielded "
        f"{type(call).__module__}.{type(call).__name__}, not a "
        f"shadow_tpu_torch.process.vproc.Sys (plugins import "
        f"shadow_tpu_torch.process.vproc)")


@dataclass
class _Proc:
    host: int
    gen: Generator
    start_time: int = 0
    stop_time: int = -1            # -1 = run until completion
    started: bool = False
    done: bool = False
    # blocking state
    block: Optional[Sys] = None
    pending: Optional[Sys] = None  # next syscall to execute
    wake_time: int = -1            # for sleep
    # per-process epoll instances (epfd -> _Epoll)
    epolls: "dict[int, _Epoll]" = field(default_factory=dict)
    next_epfd: int = EPOLL_FD_BASE
    # r5 surface breadth: virtual pid, installed signal handlers,
    # and the generator's return value (pthread_join's result)
    pid: int = 0
    sig_handlers: dict = field(default_factory=dict)
    result: object = None
    # last failing syscall's errno (the process_emu errno cell,
    # process.h; read back via get_errno())
    last_errno: int = 0


class ProcessRuntime:
    """Runs virtual processes over a SimBundle (the master/slave loop
    of the reference, slave.c:413-466, with coroutine continuation in
    place of pth scheduling)."""

    def __init__(self, bundle, app_handlers=(), mesh=None, device=None):
        """Runs on `device` (None -> "cuda"; raises when CUDA is
        missing or the bundle was built on another device), as every
        runner of the port does.

        `mesh` (this rank's parallel.shard.Mesh) runs the window loop
        sharded over the ranks (make_sharded_window: the exchange and
        the min barrier), every rank holding the GLOBAL Sim between
        windows. Each rank owns the coroutines of its own hosts
        (spawn() on another rank's host only reserves the pid) and
        applies their syscalls to its own rows; a window cuts each
        rank's rows from its Sim, sums the scalar counters' deltas, and
        reassembles the global state after it. What the hosts share
        crosses the ranks in lockstep rounds: the payload pool's puts
        and unrefs in the single-device order (so pool ids, which ride
        packet words, are allocated exactly as there), the TCP stream
        FIFOs' appends, thread pids, and the decisions to go on."""
        from shadow_tpu_torch.net.build import (
            _check_sim_device,
            _runner_device,
        )

        if mesh is not None and device is not None \
                and torch.device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh rank's "
                             f"{mesh.device}")
        self.mesh = mesh
        if mesh is not None:
            device = mesh.device
        self.device = _runner_device(bundle, device)
        _check_sim_device(bundle.sim, self.device)
        self.bundle = bundle
        self.cfg: NetConfig = bundle.cfg
        self.sim = bundle.sim
        self.procs: list[_Proc] = []
        # per-host timerfd slot allocator (timerfd_create) and
        # per-(host,slot) read counter (keeps the ET edge base
        # monotone: tm_expirations resets on read, so fires alone
        # would repeat old values)
        self._timer_alloc: dict = {}
        self._timer_reads: dict = {}
        self._step = make_step_fn(self.cfg, app_handlers)
        # the next window start as step_window returned it; None once a
        # syscall has emitted events since (then run() reads the queues)
        self._next_min = None
        # host-side snapshots of sk_flags / tcp.st, fetched at most
        # once between state mutations (readiness polls and blocked-
        # syscall retries would otherwise do one device->host transfer
        # per process per window)
        self._flags_cache = None
        self._tcp_st_cache = None
        # --- payload content (ref: payload.c) -------------------------
        # UDP datagram bytes live in the refcounted pool; the device
        # packet carries the pool id (W_PAYREF). TCP stream bytes live
        # in per-direction FIFOs keyed by (srcHost, srcPort, dstHost,
        # dstPort) — the device models timing/windows/retransmission
        # and tells us how many in-order bytes each recv delivered, so
        # content follows by popping that many bytes off the FIFO.
        from shadow_tpu_torch import native
        from shadow_tpu_torch.native.pool import PayloadPool

        if self.device.type == "cuda":
            # on the card the C++ pool is required: no quiet fallback
            # to the dict-based pool
            native.require()
        self.pool = PayloadPool()
        self._streams: dict[tuple, bytearray] = {}
        # channels (pipe/socketpair) are per-HOST like the device
        # socket table: keyed (host, fd) so same-host processes share
        # them (the fork-inherited-descriptor analog, channel.c)
        self._channels: dict[tuple, _ChanEnd] = {}
        self._next_pipe_fd: dict[int, int] = {}
        # r5 surface breadth (VERDICT r4 #4) ---------------------------
        # backend-independent host-side kernel state (virtual
        # filesystem, deterministic per-host random, per-process
        # stdio) lives in HostSideState so the SHARED_OPS table can
        # serve both this runtime and hostrun's real-kernel executor;
        # the _fs/_file_fds/... names alias into it for compat
        self.host_state = HostSideState(
            seed=int(self.cfg.seed), host_names=list(bundle.host_names))
        self._fs = self.host_state.fs                  # (host, path)
        self._file_fds = self.host_state.file_fds      # (host, fd)
        self._next_file_fd = self.host_state.next_file_fd
        self._rand = self.host_state.rand
        self._stdio = self.host_state.stdio            # (host,pid,fd)
        # pids, host mutexes + condition variables
        self._next_pid = 1
        self._mutexes: dict[tuple, int] = {}           # (host,mid)->pid|0
        self._next_mutex: dict[int, int] = {}
        # cond vars (rpth pthread.c): (host,cid) -> OrderedDict of
        # pid -> signaled flag, insertion order = FIFO wakeup order
        self._conds: dict[tuple, dict] = {}
        self._next_cond: dict[int, int] = {}
        # set by _exec when a syscall unblocks OTHER processes without
        # itself being in chan_ops (cond_wait's mutex release);
        # _resume_all folds it into chan_activity
        self._chan_kick = False
        # optional TraceRecorder (hostrun.trace): when set, every
        # completed syscall + process exit is recorded for the
        # dual-mode differential checker (docs/7-conformance.md)
        self.trace = None
        # host-side copy of the (static) IP tables for addr -> host id
        self._ip_sorted = _np(self.sim.net.ip_sorted)
        self._host_of_ip_sorted = _np(self.sim.net.host_of_ip_sorted)
        # dispatch accounting (SURVEY §7.4.4 batching evidence): one
        # "dispatch" = one fused device op (_apply); one "syscall" =
        # one coroutine request executed. Batched, dispatches grow
        # ~per-window-per-op-kind, not per syscall.
        self.stat_device_dispatches = 0
        self.stat_syscalls = 0
        self._sharded_window = None
        self._own = range(self.cfg.num_hosts)
        if mesh is not None:
            from shadow_tpu_torch.parallel.shard import (
                _check_mesh_sim,
                make_sharded_window,
            )

            Hl = _check_mesh_sim(bundle.sim, mesh)
            self._own = range(mesh.rank * Hl, (mesh.rank + 1) * Hl)
            self._sharded_window = make_sharded_window(
                mesh, mesh.axis, bundle.sim, self.cfg, self._step)
            # the last state every rank holds alike: the scalar
            # counters' deltas since it are summed before each window
            self._synced = bundle.sim
        # thread pids planned for this round's creators (a mesh)
        self._thread_pids: dict = {}

    @property
    def _multi(self) -> bool:
        return self.mesh is not None and self.mesh.size > 1

    def _gather(self, obj) -> list:
        """Every rank's `obj` in rank order ([obj] without a mesh)."""
        return self.mesh.all_gather_object(obj) if self._multi else [obj]

    @property
    def data_dir(self):
        """Host data directory for per-process stdout/stderr files
        (ref: process.c maintains <data>/hosts/<name>/*.stdout);
        None = keep in memory only (stdio_of reads either way)."""
        return self.host_state.data_dir

    @data_dir.setter
    def data_dir(self, value):
        self.host_state.data_dir = value

    # -- process registration -----------------------------------------

    def spawn(self, host: int, proc_fn: ProcFn, start_time: int = 0,
              stop_time: int = -1):
        """Register proc_fn(host) to start at sim time start_time
        (ref: <process starttime>, configuration.h:96-101). A
        non-negative stop_time kills the coroutine at that sim time
        (GeneratorExit at its blocked yield — the analog of
        process_stop aborting the plugin main thread,
        process.c:1286-1324; use try/finally in the coroutine for
        cleanup)."""
        if host not in self._own:
            # another rank's host: it runs the coroutine; the pid is
            # reserved here so pids stay the single-device ones
            self.procs.append(_Proc(host=host, gen=None,
                                    start_time=start_time,
                                    stop_time=stop_time, started=True,
                                    done=True, pid=self._next_pid))
            self._next_pid += 1
            return
        gen = proc_fn(host)
        # fail loudly here, not as an opaque AttributeError deep in the
        # window loop: the contract is a generator yielding syscalls
        if not hasattr(gen, "send") or not hasattr(gen, "close"):
            raise TypeError(
                f"virtual process for host {host} returned "
                f"{type(gen).__name__}, not a generator (its main/"
                f"proc_fn must be or return a generator yielding vproc "
                f"syscalls)")
        self.procs.append(_Proc(host=host, gen=gen,
                                start_time=start_time,
                                stop_time=stop_time,
                                pid=self._next_pid))
        self._next_pid += 1

    # -- device side ----------------------------------------------------

    def _window(self, sim, wstart, wend):
        if self.mesh is not None:
            return self._mesh_window(sim, wstart, wend)
        stats = EngineStats.create(device=self.device)
        sim, stats, next_min = step_window(
            sim, stats, self._step, wend,
            emit_capacity=self.cfg.emit_capacity,
            lane_id=sim.net.lane_id,
        )
        return sim, stats, next_min

    def _sync_global(self, sim):
        """The rank's rows of `sim` with the scalar counters' deltas
        since the last global state summed over the ranks (a syscall
        may have bumped one on its own rank)."""
        from shadow_tpu_torch.parallel.shard import (
            _replicate_scalars,
            shard_sim,
        )

        local = shard_sim(sim, self.mesh)
        local, _ = _replicate_scalars(
            local, shard_sim(self._synced, self.mesh),
            EngineStats.create(device=self.device), self.mesh)
        return local

    def _mesh_window(self, sim, wstart, wend):
        from shadow_tpu_torch.parallel.shard import unshard_sim

        out, stats, next_min = self._sharded_window(
            self._sync_global(sim), wstart, wend)
        self._synced = unshard_sim(out, self.mesh)
        return self._synced, stats, next_min

    # -- state the hosts share, across the ranks of a mesh ---------------

    def _pool_put_all(self, items) -> dict:
        """Put (host, bytes) items, this rank's in batch order, into the
        payload pool: on a mesh every rank puts every rank's items in
        rank order (the single-device host order), so every pool holds
        the same ids. Returns {host: pool id}."""
        out = {}
        for part in self._gather(list(items)):
            for h, data in part:
                out[h] = self.pool.put(data)
        return out

    def _pool_unref_all(self, ids) -> None:
        """Unref pool ids, this rank's in batch order; on a mesh every
        rank unrefs every rank's, in rank order."""
        for part in self._gather(list(ids)):
            for pid in part:
                self.pool.unref(pid)

    def _stream_share(self, appends) -> None:
        """On a mesh, the TCP stream bytes this rank's senders appended
        (already in its own FIFOs) reach the rank that owns each
        stream's receiving host; a FIFO this rank never reads is
        dropped."""
        if not self._multi:
            return
        for r, part in enumerate(self._gather(list(appends))):
            if r == self.mesh.rank:
                continue
            for key, data in part:
                if key[2] in self._own:
                    self._streams.setdefault(key, bytearray()).extend(data)
        for key, _ in appends:
            if key[2] not in self._own:
                self._streams.pop(key, None)

    # -- syscall execution ---------------------------------------------

    def _lane(self, host):
        m = np.zeros(self.cfg.num_hosts, bool)
        m[host] = True
        return torch.from_numpy(m).to(self.device)

    def _full(self, value):
        """[H] i32 of one value (the reference's jnp.full_like(mask, v,
        I32) slot and argument vectors)."""
        return torch.full((self.cfg.num_hosts,), int(value), dtype=I32,
                          device=self.device)

    def _apply(self, fn, now=0):
        """Run a state-op that may emit events, then fold the emissions
        into the queues exactly like a device micro-step does. Any
        nic_send_now bits the op set are converted into NIC_SEND
        events — no pipeline send drain runs out here."""
        self.stat_device_dispatches += 1
        buf = EmitBuffer.create(self.cfg.num_hosts, self.cfg.emit_capacity,
                                nwords=self.cfg.words_width,
                                device=self.device)
        sim, buf = fn(self.sim, buf)
        sim, buf = nic.flush_wants_send(sim, buf, now)
        q, out = apply_emissions(sim.events, sim.outbox, buf,
                                 sim.net.lane_id)
        self.sim = sim.replace(events=q, outbox=out)
        self._flags_cache = None
        self._tcp_st_cache = None
        self._next_min = None

    # -- payload content helpers ----------------------------------------

    def _host_of(self, ip: int, default: int) -> int:
        """Map an IP to its host index host-side (the np mirror of
        net.host_of_ip); loopback / unknown falls back to `default`
        (the caller's own host)."""
        if (ip >> 24) == 127:
            return default
        i = int(np.searchsorted(self._ip_sorted, ip))
        if i < len(self._ip_sorted) and int(self._ip_sorted[i]) == ip:
            return int(self._host_of_ip_sorted[i])
        return default

    def _stream_key(self, p: _Proc, fd: int, sending: bool) -> tuple:
        """Direction key of the TCP content FIFO for (p.host, fd)."""
        net = self.sim.net
        h = p.host
        my_port = int(net.sk_bound_port[h, fd])
        peer_ip = int(net.sk_peer_ip[h, fd])
        peer_port = int(net.sk_peer_port[h, fd])
        peer_h = self._host_of(peer_ip, default=h)
        if sending:
            return (h, my_port, peer_h, peer_port)
        return (peer_h, peer_port, h, my_port)

    # -- readiness (the epoll.c status engine, host side) ---------------

    def _net_rows(self):
        if self._flags_cache is None:
            net = self.sim.net
            self._flags_cache = (
                _np(net.sk_flags),
                _np(net.sk_in_gen),
                _np(net.sk_out_gen),
            )
        return self._flags_cache

    def _flags_row(self, host):
        return self._net_rows()[0][host]

    def _tcp_st(self, host, fd) -> int:
        """TCP state read through the per-window host-side cache (one
        device fetch per invalidation instead of one per blocked
        connect per window)."""
        if self._tcp_st_cache is None:
            self._tcp_st_cache = _np(self.sim.tcp.st)
        return int(self._tcp_st_cache[host, fd])

    def _sk_flag(self, host, fd, bit) -> bool:
        return bool(int(self._flags_row(host)[fd]) & bit)

    def _fd_gens(self, p: _Proc, fd: int, _depth: int = 0):
        """(in_gen, out_gen) of a socket fd; for a nested epoll, the
        sum of its watches' generations (monotonic — any child edge
        advances the parent's)."""
        if fd >= TIMER_FD_BASE:
            # monotone edge base: pending fires + 2x completed reads
            # (a read consumes at least one fire, so the sum never
            # revisits a previous value) + re-arms
            ts = fd - TIMER_FD_BASE
            n = int(self.sim.net.tm_expirations[p.host, ts])
            g = int(self.sim.net.tm_gen[p.host, ts])
            r = self._timer_reads.get((p.host, ts), 0)
            return (n + 2 * r + g, 0)
        if fd >= PIPE_FD_BASE:
            ep = self._channels.get((p.host, fd))
            if ep is None:
                return (0, 0)
            return (ep.recv_q.in_gen if ep.recv_q else 0,
                    ep.send_q.out_gen if ep.send_q else 0)
        if fd >= EPOLL_FD_BASE:
            ep = p.epolls.get(fd)
            if ep is None or _depth > 8:
                return (0, 0)
            gi = go = 0
            for wfd in ep.watches:
                a, b = self._fd_gens(p, wfd, _depth + 1)
                gi += a
                go += b
            return (gi, go)
        _, ig, og = self._net_rows()
        return (int(ig[p.host][fd]), int(og[p.host][fd]))

    def _watch_report(self, p: _Proc, wfd: int, w: _EpollWatch,
                      _depth: int = 0) -> int:
        """What this watch would report NOW (non-destructive)."""
        cur = self._fd_ready(p, wfd, _depth) & w.interest
        if not (w.flags & EPOLL.ET):
            return cur
        gin, gout = self._fd_gens(p, wfd, _depth)
        report = 0
        if (cur & EPOLL.IN) and gin != w.prev_in_gen:
            report |= EPOLL.IN
        if (cur & EPOLL.OUT) and gout != w.prev_out_gen:
            report |= EPOLL.OUT
        return report

    def _fd_ready(self, p: _Proc, fd: int, _depth: int = 0) -> int:
        """Current EPOLL.IN|OUT readiness of a socket fd, pipe fd, or
        a nested epoll fd (an epoll is readable when it would report
        at least one event — epoll-as-descriptor, ref: epoll.c:96-98)."""
        if fd >= TIMER_FD_BASE:
            # a timerfd is readable while unread expirations exist
            # (ref: timer readiness drives epoll, timer.c + epoll.c)
            ts = fd - TIMER_FD_BASE
            n = int(self.sim.net.tm_expirations[p.host, ts])
            return EPOLL.IN if n > 0 else 0
        if fd >= PIPE_FD_BASE:
            # channel status bits (ref: channel.c:22-60,147-180 flips)
            ep = self._channels.get((p.host, fd))
            if ep is None:
                return 0
            m = 0
            if ep.recv_q and (ep.recv_q.buf or ep.recv_q.writers == 0):
                m |= EPOLL.IN
            if ep.send_q and (len(ep.send_q.buf) < ep.send_q.cap
                              or ep.send_q.readers == 0):
                m |= EPOLL.OUT
            return m
        if fd >= EPOLL_FD_BASE:
            if _depth > 8:       # nesting depth guard (cycles)
                return 0
            ep = p.epolls.get(fd)
            if ep is None:
                return 0
            for wfd, w in ep.watches.items():
                if w.armed and self._watch_report(p, wfd, w, _depth + 1):
                    return EPOLL.IN
            return 0
        flags = int(self._flags_row(p.host)[fd])
        m = 0
        if flags & SocketFlags.READABLE:
            m |= EPOLL.IN
        if flags & SocketFlags.WRITABLE:
            m |= EPOLL.OUT
        return m

    def _exec(self, p: _Proc, call: Sys, now: int):
        """Execute one non-blocking syscall (or the completion of a
        blocking one). Blocking decisions come from the live device
        state / the op's own result — never from a snapshot, which
        would go stale the moment an earlier syscall in the same pass
        mutated state. Returns (ready, result).

        Ops in BATCH_OPS have exactly ONE implementation — the batched
        one; a lone call is a singleton batch (no second copy of the
        semantics to drift)."""
        if call.op in self.BATCH_OPS:
            # _exec_batch reads each proc's pending call (p.pending);
            # a caller handing us any OTHER call would silently execute
            # the wrong args — fail loudly instead
            assert call is p.pending, "BATCH_OPS delegation requires " \
                "call is p.pending (args are read from there)"
            return self._exec_batch(call.op, [p], now)[p.host]
        h = p.host
        mask = self._lane(h)
        op, a = call.op, call.args

        if op == "epoll_create":
            epfd = p.next_epfd
            p.next_epfd += 1
            p.epolls[epfd] = _Epoll()
            return True, epfd
        if op == "epoll_ctl":
            epfd, ctl, fd, events = a
            ep = p.epolls.get(epfd)
            if ep is None:
                return True, -1
            if ctl in (EPOLL.CTL_ADD, EPOLL.CTL_MOD):
                if ctl == EPOLL.CTL_ADD and fd in ep.watches:
                    return True, -1       # EEXIST
                if ctl == EPOLL.CTL_MOD and fd not in ep.watches:
                    return True, -1       # ENOENT
                # MOD resets the edge base and re-arms oneshot
                # (ref: epoll.c watch flag algebra, epoll.c:24-67)
                ep.watches[fd] = _EpollWatch(
                    interest=events & (EPOLL.IN | EPOLL.OUT),
                    flags=events & (EPOLL.ET | EPOLL.ONESHOT),
                )
            elif ctl == EPOLL.CTL_DEL:
                if ep.watches.pop(fd, None) is None:
                    return True, -1       # ENOENT
            return True, 0
        if op == "epoll_wait":
            ep = p.epolls.get(a[0])
            if ep is None:
                return True, []
            events = []
            for wfd, w in ep.watches.items():
                if not w.armed:
                    continue
                report = self._watch_report(p, wfd, w)
                # consume the edge base whether or not it reported
                w.prev_in_gen, w.prev_out_gen = self._fd_gens(p, wfd)
                if report:
                    events.append((wfd, report))
                    if w.flags & EPOLL.ONESHOT:
                        w.armed = False
            if events:
                return True, events
            return False, None
        if op == "listen":
            self.sim = tcpmod.tcp_listen(self.sim, mask, self._full(a[0]))
            self._flags_cache = None
            self._tcp_st_cache = None
            return True, 0
        if op == "gettime":
            return True, now
        if op == "gethostbyname":
            addr = self.bundle.dns.resolve_name(a[0])
            return True, (addr.ip if addr is not None else -1)
        if op == "setsockopt":
            fd, opt, val = a
            net = self.sim.net
            slot = self._full(fd)
            v = self._full(val)
            if opt == SO.SNDBUF:
                net = net.replace(
                    sk_sndbuf=set_hs(net.sk_sndbuf, mask, slot, v),
                    autotune_snd=net.autotune_snd & ~mask)
            elif opt == SO.RCVBUF:
                net = net.replace(
                    sk_rcvbuf=set_hs(net.sk_rcvbuf, mask, slot, v),
                    autotune_rcv=net.autotune_rcv & ~mask)
            else:
                return True, -1
            self.sim = self.sim.replace(net=net)
            return True, 0
        if op == "getsockopt":
            fd, opt = a
            net = self.sim.net
            if opt == SO.SNDBUF:
                return True, int(net.sk_sndbuf[h, fd])
            if opt == SO.RCVBUF:
                return True, int(net.sk_rcvbuf[h, fd])
            return True, -1
        if op == "ioctl_inq":
            fd = a[0]
            net = self.sim.net
            if (int(net.sk_type[h, fd]) == SocketType.TCP
                    and self.sim.tcp is not None):
                return True, int(self.sim.tcp.app_rbytes[h, fd])
            return True, int(net.in_bytes[h, fd])
        if op == "ioctl_outq":
            fd = a[0]
            net = self.sim.net
            if (int(net.sk_type[h, fd]) == SocketType.TCP
                    and self.sim.tcp is not None):
                t = self.sim.tcp
                return True, int(t.snd_end[h, fd]) - int(t.snd_una[h, fd])
            return True, int(net.out_bytes[h, fd])
        # Blocking-syscall retries are gated on host-side cached
        # readiness, so a blocked process costs NO device dispatch per
        # window unless its call can actually progress (the batching
        # SURVEY.md §7.4.4 requires; the readiness bits are exactly
        # what the reference's epoll notify would check before
        # process_continue, epoll.c:583-680).
        if op == "connect":
            fd, ip, port = a
            st = self._tcp_st(h, fd)
            if p.block is None:
                # issue the SYN, then block until established
                self._apply(lambda sim, buf: tcpmod.tcp_connect(
                    self.cfg, sim, mask, self._full(fd), ip, port, now,
                    buf), now)
                return False, None
            if st == tcpmod.TcpSt.ESTABLISHED or st >= tcpmod.TcpSt.FIN_WAIT_1:
                return True, 0
            if st == tcpmod.TcpSt.CLOSED:
                return True, -1       # connection refused/reset
            return False, None
        if op == "accept":
            fd = a[0]
            # listener readable iff children are queued (tcp_accept
            # maintains the bit) — skip the device pop otherwise
            if not self._sk_flag(h, fd, SocketFlags.READABLE):
                return False, None
            child = None

            def do(sim, buf):
                nonlocal child
                sim, got, ch = tcpmod.tcp_accept(sim, mask, self._full(fd))
                child = int(ch[h])
                return sim, buf

            self._apply(do, now)
            if child is not None and child >= 0:
                return True, child
            return False, None
        # ---- r5 surface breadth: files / random / signals ------------
        # (backend-independent, dispatched through the shared table so
        # the real-host-kernel executor runs the identical code —
        # hostrun/executor.py, docs/7-conformance.md)
        if op in SHARED_OPS:
            return SHARED_OPS[op](self.host_state, self, p, a)
        if op == "thread_create":
            gen = a[0](h)
            pid = self._thread_pids.pop(p.pid, None)
            if pid is None:
                pid = self._next_pid
                self._next_pid += 1
            t = _Proc(host=h, gen=gen, start_time=now, pid=pid)
            self.procs.append(t)
            return True, t.pid
        if op == "thread_join":
            tgt = next((q for q in self.procs if q.pid == a[0]
                        and q.host == h), None)
            if tgt is None:
                return True, None         # ESRCH -> join returns
            if not tgt.done:
                return False, None        # block until it completes
            return True, tgt.result
        if op == "mutex_init":
            mid = self._next_mutex.get(h, 1)
            self._next_mutex[h] = mid + 1
            self._mutexes[(h, mid)] = 0
            return True, mid
        if op == "mutex_lock":
            owner = self._mutexes.get((h, a[0]))
            if owner is None:
                return True, -1           # EINVAL
            if owner and owner != p.pid:
                return False, None        # block until released
            self._mutexes[(h, a[0])] = p.pid
            return True, 0
        if op == "mutex_trylock":
            owner = self._mutexes.get((h, a[0]))
            if owner is None:
                return True, -1
            if owner and owner != p.pid:
                return True, False        # EBUSY
            self._mutexes[(h, a[0])] = p.pid
            return True, True
        if op == "mutex_unlock":
            if self._mutexes.get((h, a[0])) != p.pid:
                return True, -1            # EPERM
            self._mutexes[(h, a[0])] = 0
            return True, 0
        if op == "cond_init":
            cid = self._next_cond.get(h, 1)
            self._next_cond[h] = cid + 1
            # OrderedDict-by-construction: pid -> signaled flag,
            # insertion order = FIFO wakeup order (rpth pth_cond_await
            # enqueues waiters and pth_cond_notify releases them
            # oldest-first, pth_high.c)
            self._conds[(h, cid)] = {}
            return True, cid
        if op == "cond_wait":
            cid, mid = a
            waiters = self._conds.get((h, cid))
            if waiters is None:
                return True, -1            # EINVAL
            if p.block is None:
                # first entry: atomically release the mutex and join
                # the wait queue (pthread_cond_wait contract; EPERM if
                # the caller does not hold the mutex)
                if self._mutexes.get((h, mid)) != p.pid:
                    return True, -1        # EPERM
                self._mutexes[(h, mid)] = 0
                # the release may unblock a parked mutex_lock even
                # though cond_wait itself returns blocked — make sure
                # _resume_all re-sweeps (see _chan_kick)
                self._chan_kick = True
                waiters[p.pid] = False
                return False, None
            if not waiters.get(p.pid, False):
                return False, None         # not signaled yet
            # signaled: re-acquire the mutex before returning (the
            # second half of pthread_cond_wait); stay blocked while
            # another thread holds it
            owner = self._mutexes.get((h, mid))
            if owner and owner != p.pid:
                return False, None
            self._mutexes[(h, mid)] = p.pid
            del waiters[p.pid]
            return True, 0
        if op == "cond_signal":
            waiters = self._conds.get((h, a[0]))
            if waiters is None:
                return True, -1            # EINVAL
            for pid, sig in waiters.items():
                if not sig:               # oldest unsignaled waiter
                    waiters[pid] = True
                    break
            return True, 0
        if op == "cond_broadcast":
            waiters = self._conds.get((h, a[0]))
            if waiters is None:
                return True, -1            # EINVAL
            for pid in waiters:
                waiters[pid] = True
            return True, 0
        if op == "pipe":
            base = self._next_pipe_fd.setdefault(h, PIPE_FD_BASE)
            rfd, wfd = base, base + 1
            self._next_pipe_fd[h] = base + 2
            q = _ByteQ()
            self._channels[(h, rfd)] = _ChanEnd(recv_q=q)
            self._channels[(h, wfd)] = _ChanEnd(send_q=q)
            return True, (rfd, wfd)
        if op == "socketpair":
            base = self._next_pipe_fd.setdefault(h, PIPE_FD_BASE)
            fd1, fd2 = base, base + 1
            self._next_pipe_fd[h] = base + 2
            qa, qb = _ByteQ(), _ByteQ()
            self._channels[(h, fd1)] = _ChanEnd(recv_q=qa, send_q=qb)
            self._channels[(h, fd2)] = _ChanEnd(recv_q=qb, send_q=qa)
            return True, (fd1, fd2)
        if op == "write":
            fd, data = a
            if fd in (1, 2):
                # per-process stdout/stderr (ref: process.c's
                # <data>/hosts/<name>/<plugin>.stdout files)
                return True, stdio_write(self.host_state,
                                         self.bundle.host_names[h],
                                         h, p.pid, fd, data)
            if FILE_FD_BASE <= fd < TIMER_FD_BASE:
                return True, file_write(self.host_state, h, fd, data)
            ep = self._channels.get((h, fd))
            if ep is None or ep.send_q is None:
                return True, -1          # EBADF
            q = ep.send_q
            if q.readers == 0:
                return True, -1          # EPIPE (ref: channel write to
                                         # a closed read end)
            space = q.cap - len(q.buf)
            if space <= 0:
                return False, None       # block until a reader drains
            n = min(space, len(data))
            q.buf.extend(data[:n])
            q.in_gen += 1
            return True, n
        if op == "read":
            fd, maxb = a
            if FILE_FD_BASE <= fd < TIMER_FD_BASE:
                return True, file_read(self.host_state, h, fd, maxb)
            ep = self._channels.get((h, fd))
            if ep is None or ep.recv_q is None:
                return True, b""         # EBADF-ish: nothing to read
            q = ep.recv_q
            if q.buf:
                n = min(maxb, len(q.buf))
                out = bytes(q.buf[:n])
                del q.buf[:n]
                q.out_gen += 1
                return True, out
            if q.writers == 0:
                return True, b""         # EOF: all write ends closed
            return False, None
        if op == "timerfd_create":
            nxt = self._timer_alloc.get(h, 0)
            if nxt >= self.cfg.timers_per_host:
                return True, -1
            self._timer_alloc[h] = nxt + 1
            return True, TIMER_FD_BASE + nxt
        if op == "timerfd_settime":
            tfd, expire, interval = a
            slot = self._full(tfd - TIMER_FD_BASE)
            if expire == 0:
                self.sim = timermod.timer_disarm(self.sim, mask, slot)
                return True, 0
            # timerfd(2) default semantics: it_value is RELATIVE to
            # now (no TFD_TIMER_ABSTIME on the surface — the
            # reference's timer_setTime converts the same way,
            # timer.c); timer_set itself takes an absolute deadline
            self._apply(lambda sim, buf: timermod.timer_set(
                sim, buf, mask, slot, now + expire, interval), now)
            return True, 0
        if op == "timerfd_read":
            tfd = a[0]
            ts = tfd - TIMER_FD_BASE
            n = int(self.sim.net.tm_expirations[h, ts])
            if n == 0:
                return False, None
            slot = self._full(ts)
            sim2, cnt = timermod.timer_read(self.sim, mask, slot)
            self.sim = sim2
            self._timer_reads[(h, ts)] = \
                self._timer_reads.get((h, ts), 0) + 1
            return True, int(cnt[h])
        if op == "shutdown":
            fd, how = a
            if how in (SHUT_WR, SHUT_RDWR) \
                    and int(self.sim.net.sk_type[h, fd]) == SocketType.TCP:
                self._apply(lambda sim, buf: tcpmod.tcp_close(
                    self.cfg, sim, mask, self._full(fd), now, buf), now)
            return True, 0
        if op == "sleep":
            if p.block is None:
                p.wake_time = now + int(a[0])
                return False, None
            if now >= p.wake_time:
                return True, 0
            return False, None
        if op == "wait_readable":
            ready = [fd for fd in a[0] if self._fd_ready(p, fd) & EPOLL.IN]
            if ready:
                return True, ready
            return False, None
        if op in ("poll", "select"):
            # level-triggered readiness scans over the same status
            # engine epoll uses (ref: host_select/host_poll,
            # host.c:852-1009 — both walk the descriptor table and
            # test READABLE/WRITABLE). Timeout rides the sleep
            # machinery: wake_time is armed on first block and a
            # timed-out wait returns the empty result.
            if op == "poll":
                revs = [(fd, self._fd_ready(p, fd) & ev)
                        for fd, ev in a[0]]
                result = [(fd, r) for fd, r in revs if r]
                got = bool(result)
                empty = []
            else:
                r = [fd for fd in a[0]
                     if self._fd_ready(p, fd) & EPOLL.IN]
                w = [fd for fd in a[1]
                     if self._fd_ready(p, fd) & EPOLL.OUT]
                result = (r, w)
                got = bool(r or w)
                empty = ([], [])
            timo = a[-1]
            if got:
                return True, result
            if timo == 0:
                return True, empty
            if timo > 0:
                if p.block is None:
                    p.wake_time = now + timo
                elif now >= p.wake_time:
                    return True, empty
            return False, None
        raise ValueError(f"unknown syscall {op}")

    # -- batched syscall execution (SURVEY §7.4.4) ----------------------
    # Data-plane ops whose device kernel is a masked [H] batch update:
    # N processes on N distinct hosts issuing the same op in the same
    # scheduler round execute as ONE fused device op with a multi-hot
    # mask and per-host argument vectors — the per-window syscall
    # batching the reference gets for free from shared memory and we
    # need to amortize device dispatch latency (VERDICT r2 weak #6:
    # O(procs x syscalls) dispatches walled any 1000-vproc config).

    BATCH_OPS = frozenset((
        "sendto", "sendto_data", "recvfrom", "recvfrom_data",
        "recv", "recv_data", "send", "send_data",
        "socket", "bind", "close",
    ))
    # batches whose host-side work crosses the ranks of a mesh (the
    # payload pool, the stream FIFOs): every rank runs them, with or
    # without a process of its own in them
    SHARED_BATCH_OPS = frozenset((
        "sendto_data", "recvfrom", "recvfrom_data", "recv", "send_data"))

    def _batch_arrays(self, group, cols, dtypes=None):
        """mask + [H] arg arrays from a {host: args-tuple} group.
        `cols` = indices into each args tuple to vectorize; `dtypes`
        per column (default i32, matching the serial path's _full
        slots; IPs need i64). One host-to-device copy per array."""
        H = self.cfg.num_hosts
        m = np.zeros(H, bool)
        dts = dtypes or [np.int32] * len(cols)
        out = [np.zeros(H, dt) for dt in dts]
        for h, a in group.items():
            m[h] = True
            for i, c in enumerate(cols):
                out[i][h] = a[c]
        dev = self.device
        return (torch.from_numpy(m).to(dev),) + tuple(
            torch.from_numpy(x).to(dev) for x in out)

    def _exec_batch(self, op: str, procs: list, now: int) -> dict:
        """Execute one op kind for processes on DISTINCT hosts as one
        fused device op. Returns {host: (ready, result)} with results
        identical to per-host _exec (same kernels, multi-hot mask).
        Host-side work (payload pool, stream FIFOs) runs per host in
        the caller's batch order, which the scheduler builds by sorted
        host id — PER-HOST ordering is exactly the serial path's, but
        CROSS-host side-effect order (e.g. pool-ref assignment) is
        host-sorted rather than global spawn order. Deterministic
        either way; per-host state is bitwise unaffected."""
        res: dict = {}
        if not procs and op not in self.SHARED_BATCH_OPS:
            return res   # a mesh rank with no process in this batch

        if op in ("sendto", "sendto_data"):
            # non-blocking datagram sends; pool puts first (spawn order)
            group = {}
            prefs = {}
            if op == "sendto_data":
                prefs = self._pool_put_all(
                    (p.host, bytes(p.pending.args[3])) for p in procs)
            for p in procs:
                fd, ip, port, last = p.pending.args
                if op == "sendto_data":
                    group[p.host] = (fd, ip, port, len(last),
                                     prefs[p.host])
                else:
                    group[p.host] = (fd, ip, port, last, -1)
            drop = []
            if group:
                mask, fd, ip, port, n, pref = self._batch_arrays(
                    group, (0, 1, 2, 3, 4),
                    dtypes=(np.int32, np.int64, np.int32, np.int32,
                            np.int32))
                ok = None

                def do(sim, buf):
                    nonlocal ok
                    net, okk = udpmod.udp_enqueue_send(
                        sim.net, mask, fd, ip, port, n, pref)
                    ok = okk
                    return nic.notify_wants_send(
                        sim.replace(net=net), buf, okk, now)

                self._apply(do, now)
                ok = _np(ok)
                for p in procs:
                    queued = bool(ok[p.host])
                    if op == "sendto_data" and not queued:
                        drop.append(prefs[p.host])  # EWOULDBLOCK
                    res[p.host] = (True, queued)
            if op == "sendto_data":
                self._pool_unref_all(drop)
            return res

        if op in ("recvfrom", "recvfrom_data", "recv", "recv_data"):
            # blocked unless READABLE (host-side cache, no dispatch)
            ready_procs = []
            for p in procs:
                fd = p.pending.args[0]
                if self._sk_flag(p.host, fd, SocketFlags.READABLE):
                    ready_procs.append(p)
                else:
                    res[p.host] = (False, None)
            # split TCP stream reads from UDP datagram reads ("recv"
            # on a TCP fd is a stream read; "recv_data" is stream-only
            # by contract — both exactly as serial _exec routes them).
            # ONE sk_type snapshot for the whole batch, not a device
            # indexing read per process.
            tcp_grp, udp_grp = [], []
            sktype = (_np(self.sim.net.sk_type)
                      if ready_procs and op == "recv" else None)
            for p in ready_procs:
                fd = p.pending.args[0]
                is_tcp = op == "recv_data" or (
                    op == "recv" and self.sim.tcp is not None and (
                        int(sktype[p.host, fd]) == SocketType.TCP
                        or self._tcp_st(p.host, fd) != 0))
                (tcp_grp if is_tcp else udp_grp).append(p)

            if tcp_grp:
                group = {p.host: (p.pending.args[0],
                                  p.pending.args[1] if
                                  len(p.pending.args) > 1 else 1 << 30)
                         for p in tcp_grp}
                mask, fd, maxb = self._batch_arrays(group, (0, 1))
                got = {}

                def dot(sim, buf):
                    sim, buf, nr, ef = tcpmod.tcp_recv(
                        sim, mask, fd, maxb, now, buf)
                    got["nr"], got["ef"] = nr, ef
                    return sim, buf

                self._apply(dot, now)
                nr, ef = _np(got["nr"]), _np(got["ef"])
                for p in tcp_grp:
                    h = p.host
                    nread, eof = int(nr[h]), bool(ef[h])
                    if nread > 0:
                        if op == "recv":
                            res[h] = (True, nread)
                        else:
                            key = self._stream_key(
                                p, p.pending.args[0], sending=False)
                            fifo = self._streams.get(key)
                            if fifo is None or len(fifo) < nread:
                                have = bytes(fifo[:nread]) if fifo else b""
                                out = have + b"\x00" * (nread - len(have))
                                if fifo:
                                    del fifo[:len(have)]
                            else:
                                out = bytes(fifo[:nread])
                                del fifo[:nread]
                            res[h] = (True, out)
                    elif eof:
                        res[h] = (True, 0 if op == "recv" else b"")
                    else:
                        res[h] = (False, None)

            drop = []       # pool ids to unref, in host order
            if udp_grp:
                group = {p.host: (p.pending.args[0],) for p in udp_grp}
                mask, fd = self._batch_arrays(group, (0,))
                got = {}

                def dou(sim, buf):
                    net, g, sip, spt, ln, pr = udpmod.udp_recv(
                        sim.net, mask, fd)
                    got.update(g=g, sip=sip, spt=spt, ln=ln, pr=pr)
                    return sim.replace(net=net), buf

                self._apply(dou, now)
                g, sip, spt, ln, pr = (_np(got[k]) for k in
                                       ("g", "sip", "spt", "ln", "pr"))
                for p in udp_grp:
                    h = p.host
                    if not bool(g[h]):
                        res[h] = (False, None)
                        continue
                    pref = int(pr[h])
                    if op == "recvfrom_data":
                        if pref >= 0:
                            data = self.pool.get(pref)
                            drop.append(pref)
                        else:
                            data = b"\x00" * int(ln[h])
                        res[h] = (True, (int(sip[h]), int(spt[h]), data))
                    else:
                        if pref >= 0:
                            drop.append(pref)  # length-only API
                        if op == "recvfrom":
                            res[h] = (True, (int(sip[h]), int(spt[h]),
                                             int(ln[h])))
                        else:          # "recv" on a UDP fd
                            res[h] = (True, int(ln[h]))
            if op != "recv_data":
                self._pool_unref_all(drop)
            return res

        if op in ("send", "send_data"):
            ready_procs = []
            appends = []
            for p in procs:
                fd = p.pending.args[0]
                if self._sk_flag(p.host, fd, SocketFlags.WRITABLE):
                    ready_procs.append(p)
                else:
                    res[p.host] = (False, None)
            if ready_procs:
                group = {}
                for p in ready_procs:
                    fd, last = p.pending.args
                    n = len(last) if op == "send_data" else last
                    group[p.host] = (fd, n)
                mask, fd, n = self._batch_arrays(group, (0, 1))
                got = {}

                def dos(sim, buf):
                    sim, buf, accepted = tcpmod.tcp_send(
                        self.cfg, sim, mask, fd, n, now, buf)
                    got["acc"] = accepted
                    return sim, buf

                self._apply(dos, now)
                acc = _np(got["acc"])
                for p in ready_procs:
                    h = p.host
                    a = int(acc[h])
                    if a > 0:
                        if op == "send_data":
                            key = self._stream_key(
                                p, p.pending.args[0], sending=True)
                            data = p.pending.args[1][:a]
                            self._streams.setdefault(
                                key, bytearray()).extend(data)
                            appends.append((key, bytes(data)))
                        res[h] = (True, a)
                    else:
                        res[h] = (False, None)
            if op == "send_data":
                self._stream_share(appends)
            return res

        if op == "socket":
            group = {p.host: (p.pending.args[0],) for p in procs}
            mask, stype = self._batch_arrays(group, (0,))
            self.stat_device_dispatches += 1
            net, slot = sk_create(self.sim.net, mask, stype)
            self.sim = self.sim.replace(net=net)
            self._flags_cache = None
            self._tcp_st_cache = None
            s = _np(slot)
            return {p.host: (True, int(s[p.host])) for p in procs}

        if op == "bind":
            # host-side EINVAL / EADDRINUSE checks from ONE snapshot
            # (the serial path's per-bind int() reads cost one device
            # sync each — ADVICE r2 #4), then one fused sk_bind
            net = self.sim.net
            bound = _np(net.sk_bound_port)
            sktype = _np(net.sk_type)
            S = bound.shape[1]
            group = {}
            ok_procs = []
            for p in procs:
                fd, want = p.pending.args[0], int(p.pending.args[1])
                h = p.host
                if int(bound[h, fd]) != 0:
                    res[h] = (True, -1)        # EINVAL: already bound
                    continue
                if want != 0:
                    proto = int(sktype[h, fd])
                    taken = bool(np.any(
                        (sktype[h] == proto) & (bound[h] == want)
                        & (np.arange(S) != fd)))
                    if taken:
                        res[h] = (True, -1)    # EADDRINUSE
                        continue
                group[h] = (fd, want)
                ok_procs.append(p)
            if group:
                mask, fd, want = self._batch_arrays(group, (0, 1))
                self.stat_device_dispatches += 1
                net2, port = sk_bind(net, mask, fd, 0, want)
                self.sim = self.sim.replace(net=net2)
                self._flags_cache = None
                self._tcp_st_cache = None
                prt = _np(port)
                for p in ok_procs:
                    res[p.host] = (True, int(prt[p.host]))
            return res

        if op == "close":
            # pipe/timer/epoll closes are pure host-side bookkeeping
            # (no device dispatch); socket closes split into one
            # tcp_close and one fused UDP slot clear
            tcp_grp, udp_grp = [], []
            sktype = _np(self.sim.net.sk_type)
            for p in procs:
                fd = p.pending.args[0]
                if fd >= EPOLL_FD_BASE:        # pipes/timers/epolls too
                    res[p.host] = self._close_special(p, fd)
                    continue
                for ep in p.epolls.values():
                    ep.watches.pop(fd, None)
                if int(sktype[p.host, fd]) == SocketType.TCP:
                    tcp_grp.append(p)
                else:
                    udp_grp.append(p)
            if tcp_grp:
                group = {p.host: (p.pending.args[0],) for p in tcp_grp}
                mask, fd = self._batch_arrays(group, (0,))
                self._apply(lambda sim, buf: tcpmod.tcp_close(
                    self.cfg, sim, mask, fd, now, buf), now)
                for p in tcp_grp:
                    res[p.host] = (True, 0)
            if udp_grp:
                group = {p.host: (p.pending.args[0],) for p in udp_grp}
                sel, slot = self._batch_arrays(group, (0,))
                self.stat_device_dispatches += 1
                net = self.sim.net
                was_live = sel & (gather_hs(net.sk_type, slot)
                                  != SocketType.NONE)
                net = net.replace(
                    sk_type=set_hs(net.sk_type, sel, slot,
                                   torch.zeros_like(slot)),
                    sk_flags=set_hs(net.sk_flags, sel, slot,
                                    torch.zeros_like(slot)),
                    sk_bound_port=set_hs(net.sk_bound_port, sel, slot,
                                         torch.zeros_like(slot)),
                    ctr_sk_free=net.ctr_sk_free + was_live.to(I64),
                )
                self.sim = self.sim.replace(net=net)
                self._flags_cache = None
                self._tcp_st_cache = None
                for p in udp_grp:
                    res[p.host] = (True, 0)
            return res

        raise ValueError(f"op {op} is not batchable")

    # -- r5 surface-breadth helpers -------------------------------------
    # (files / random / stdio moved to module level — file_open,
    # file_write, file_read, stdio_write, host_rand — so hostrun's
    # real-kernel executor shares them via SHARED_OPS)

    def _deliver_signal(self, p: _Proc, sig: int) -> int:
        """Run the installed handler host-side (the pth-dispatched
        handler analog); an unhandled signal kills the process like a
        plugin fault (slave.c:468-473)."""
        handler = p.sig_handlers.get(sig)
        if handler is None:
            p.gen.close()
            p.done = True
            p.pending = None
            p.block = None
            if self.trace is not None:
                self.trace.record_exit(p.host, p.pid, ("killed", sig))
            return -1
        handler(sig)
        return 0

    def stdio_of(self, host: int, pid: int, fd: int = 1) -> bytes:
        return bytes(self._stdio.get((host, pid, fd), b""))

    def _close_special(self, p: _Proc, fd: int):
        """close() of a non-socket fd: pipe/socketpair ends (status
        flips for the peer — last writer gone -> reader sees EOF,
        last reader gone -> writer sees EPIPE, ref: channel.c
        close/free), an epoll descriptor, or a virtual file. Pure
        host-side."""
        h = p.host
        if FILE_FD_BASE <= fd < TIMER_FD_BASE:
            return (True,
                    0 if self._file_fds.pop((h, fd), None) is not None
                    else -1)
        if fd >= PIPE_FD_BASE:
            ep = self._channels.pop((h, fd), None)
            for epl in p.epolls.values():
                epl.watches.pop(fd, None)
            if ep is not None:
                if ep.recv_q is not None:
                    ep.recv_q.readers -= 1
                    ep.recv_q.out_gen += 1
                if ep.send_q is not None:
                    ep.send_q.writers -= 1
                    ep.send_q.in_gen += 1
            return True, 0
        p.epolls.pop(fd, None)
        return True, 0

    # -- scheduler ------------------------------------------------------

    def _resume_all(self, now: int) -> None:
        """Advance every runnable coroutine until all are blocked
        (the pth_yield loop, process.c:1227-1229), in breadth-first
        ROUNDS so data-plane syscalls from distinct hosts fuse into
        one device op each (_exec_batch; SURVEY §7.4.4). Each round
        claims the earliest runnable process per host (per-host spawn
        order — one host's syscalls stay strictly serialized, the
        per-host determinism contract), executes non-batchable ops in
        spawn order, then each batchable op kind as one fused masked
        op. A process that blocks is parked for the rest of the sweep
        (the serial loop visited each process once per sweep too).

        Sweeps repeat while channel activity occurred: a pipe
        write/read/close by a later process can unblock an earlier
        one at the same instant (the reference's status-change notify
        re-enters process_continue within the same sim time,
        epoll.c:583-680). Only channels need this — every other
        cross-process path rides device events, which land in a
        later window."""
        # ops whose completion can UNBLOCK another parked coroutine on
        # the same host (channel byte movement, mutex handover) — they
        # trigger another sweep, exactly like pth's scheduler re-runs
        # ready green threads until quiescence
        chan_ops = ("pipe", "socketpair", "write", "read",
                    "mutex_unlock", "thread_create",
                    # cond_signal/broadcast wake parked cond_waits;
                    # cond_wait's completion re-acquires (and its first
                    # entry releases — see _chan_kick) the mutex
                    "cond_signal", "cond_broadcast", "cond_wait",
                    # an unhandled signal kills its target directly
                    # (_deliver_signal), which can complete a proc a
                    # parked thread_join is waiting on
                    "kill", "raise_sig")
        # syscalls whose blocking state channel activity can change;
        # later sweeps retry ONLY processes blocked on these (cheap,
        # host-side) — re-running device-side blocked ops (tcp_send,
        # accept, ...) every sweep would cost a device dispatch per
        # blocked process per sweep for state that cannot have changed
        retry_ops = ("read", "write", "wait_readable", "epoll_wait",
                     "poll", "select", "thread_join", "mutex_lock",
                     "cond_wait")

        def advance(p, idx, ready, result, parked):
            """Feed one syscall result back into its coroutine."""
            call = p.pending
            if not ready:
                p.block = call
                parked.add(idx)
                return False
            if call.op in chan_ops or (
                    call.op == "close" and call.args
                    and call.args[0] >= PIPE_FD_BASE):
                advance.chan_activity = True
            if self.trace is not None:
                # conformance hook: every COMPLETED syscall (blocked
                # retries are invisible, matching the host backend
                # where a blocking call is one real syscall)
                self.trace.record(p.host, p.pid, call.op, call.args,
                                  result)
            p.block = None
            try:
                p.pending = _checked(p, p.gen.send(result))
            except StopIteration as e:
                p.done = True
                p.pending = None
                p.result = e.value
                if self.trace is not None:
                    self.trace.record_exit(p.host, p.pid, p.result)
                # a completed coroutine unblocks thread_join waiters —
                # that's sweep-worthy activity
                advance.chan_activity = True
            return True

        sweep = 0
        while True:
            advance.chan_activity = False
            parked: set = set()           # proc indices blocked this sweep
            went_on = True                # the last round progressed
            while True:                   # rounds
                claimed: dict = {}        # host -> (idx, proc)
                for idx, p in enumerate(self.procs):
                    if p.done or now < p.start_time or idx in parked:
                        continue
                    if sweep > 0 and p.block is not None \
                            and p.block.op not in retry_ops:
                        continue
                    if p.host in claimed:
                        continue
                    claimed[p.host] = (idx, p)
                if self._multi:
                    # lockstep: a round runs while any rank claims a
                    # process and the last one went on somewhere
                    votes = self._gather((bool(claimed), went_on))
                    if not any(c for c, _ in votes) \
                            or not any(w for _, w in votes):
                        break
                elif not claimed:
                    break
                progress = False
                parked_before = len(parked)
                batches: dict = {}
                serial = []
                for h in sorted(claimed):
                    idx, p = claimed[h]
                    if not p.started:
                        p.started = True
                        try:
                            p.pending = _checked(p, next(p.gen))
                        except StopIteration as e:
                            p.done = True
                            p.result = e.value
                            if self.trace is not None:
                                self.trace.record_exit(p.host, p.pid,
                                                       p.result)
                            # a finished process IS progress: its host
                            # is claimable by a successor next round —
                            # and sweep-worthy activity (a same-host
                            # thread_join parked earlier this sweep
                            # must see the completion)
                            progress = True
                            advance.chan_activity = True
                            continue
                        p.block = None
                    if p.pending is None:
                        p.done = True
                        progress = True
                        continue
                    if p.pending.op in self.BATCH_OPS:
                        batches.setdefault(p.pending.op, []).append((idx, p))
                    else:
                        serial.append((idx, p))
                ops = sorted(batches)
                if self._multi:
                    ops, tail = self._plan_round(batches, serial)
                for idx, p in sorted(serial):
                    ready, result = self._exec(p, p.pending, now)
                    self.stat_syscalls += 1
                    progress |= advance(p, idx, ready, result, parked)
                if self._multi:
                    self._place_threads(*tail)
                for op in ops:
                    lst = batches.get(op, [])
                    results = self._exec_batch(op, [p for _, p in lst], now)
                    self.stat_syscalls += len(lst)
                    for idx, p in lst:
                        ready, result = results[p.host]
                        progress |= advance(p, idx, ready, result, parked)
                # a newly-parked process changes the next round's
                # claims (a same-host successor becomes claimable), so
                # parking counts as progress for loop continuation
                went_on = progress or len(parked) != parked_before
                if not went_on and not self._multi:
                    break
            sweep += 1
            # cond_wait's first entry releases its mutex but itself
            # returns blocked — advance() never sees a ready result,
            # so fold the _exec-side kick in here
            if self._chan_kick:
                advance.chan_activity = True
                self._chan_kick = False
            if self._multi:
                advance.chan_activity = any(
                    self._gather(bool(advance.chan_activity)))
            if not advance.chan_activity:
                break

    def _plan_round(self, batches, serial):
        """A mesh round's plan, one gather: the batch kinds any rank
        runs (every rank runs each, for the shared host-side work) and
        the thread pids of the round's thread_create calls, numbered
        in the single-device order (by process index over all ranks).
        Returns (ops, (first index, global creators, own creators))."""
        mine = sorted(idx for idx, p in serial
                      if p.pending.op == "thread_create")
        votes = self._gather((sorted(batches), mine))
        ops = sorted({op for b, _ in votes for op in b})
        creators = sorted(idx for _, m in votes for idx in m)
        base, own = self._next_pid, set(mine)
        self._thread_pids = {self.procs[idx].pid: base + k
                             for k, idx in enumerate(creators)
                             if idx in own}
        self._next_pid = base + len(creators)
        return ops, (len(self.procs), creators, set(mine))

    def _place_threads(self, n0, creators, mine):
        """Put the threads this round created at their single-device
        indices, with a placeholder for each another rank created."""
        new = iter(self.procs[n0:])
        base = self._next_pid - len(creators)
        self.procs[n0:] = [
            next(new) if idx in mine else
            _Proc(host=-1, gen=None, started=True, done=True, pid=base + k)
            for k, idx in enumerate(creators)]
        self._thread_pids = {}

    def gc_pool(self) -> int:
        """Mark-sweep the payload pool against the device state: a
        pool entry is live iff its id appears in any in-flight packet
        location (event queue words, outbox words, router ring, socket
        output rings, or input rings). Entries dropped inside the
        simulated network (reliability/CoDel/no-socket/rcvbuf drops
        destroy the packet on device, where the host cannot observe
        the unref — the reference unrefs in packet_unref, packet.c)
        are collected here. Returns the number of entries released."""
        from shadow_tpu_torch.net import packetfmt as pfm

        sim = self.sim
        live: set[int] = set()

        def ring_live(payref, head, count):
            """payrefs at live ring positions [head, head+count)."""
            B = payref.shape[-1]
            idx = np.arange(B)
            mask = ((idx - head[..., None]) % B) < count[..., None]
            return payref[mask]

        def mark(vals):
            live.update(int(x) for x in np.unique(vals) if x >= 0)

        mark(_np(sim.events.words[..., pfm.W_PAYREF][
            sim.events.time != simtime.INVALID]))
        mark(_np(sim.outbox.words[..., pfm.W_PAYREF][sim.outbox.dst >= 0]))
        net = sim.net
        mark(ring_live(_np(net.rq_words[..., pfm.W_PAYREF]),
                       _np(net.rq_head), _np(net.rq_count)))
        mark(ring_live(_np(net.out_words[..., pfm.W_PAYREF]),
                       _np(net.out_head), _np(net.out_count)))
        mark(ring_live(_np(net.in_payref), _np(net.in_head),
                       _np(net.in_count)))
        freed = 0
        for pid in self.pool.live_ids():
            if pid not in live:
                while self.pool.unref(pid) > 0:
                    pass
                freed += 1
        return freed

    def run(self, end_time: int | None = None, on_window=None):
        """The master window loop (ref: master.c:450-480 +
        slave.c:413-466) with coroutine continuation between windows.
        `on_window(sim, wend)` runs after every device window — pcap
        drains, heartbeats, progress hooks (mirrors
        checkpoint.run_windows)."""
        end = end_time if end_time is not None else self.cfg.end_time
        min_jump = max(int(self.bundle.min_jump), 1)
        # host-side twin of the record-time wend clamp (engine.make_wend_fn
        # / checkpoint.run_windows): fault records take effect exactly at
        # their timestamps, never early because a window crossed one.
        from shadow_tpu_torch.net.build import plan_times

        _pt = plan_times(self.bundle)

        total = EngineStats.create(device=self.device)
        now = 0
        while now <= end:
            # stoptime enforcement (ref: process_stop,
            # process.c:1286-1324): kill before resuming, so a
            # stopped process never runs at or past its stop time
            for p in self.procs:
                if not p.done and 0 <= p.stop_time <= now:
                    p.gen.close()
                    p.done = True
                    p.pending = None
                    p.block = None
            self._resume_all(now)

            # next window start: earliest of device events, sleep
            # deadlines, not-yet-started process start times, and
            # pending stop deadlines
            if self._next_min is None or self._multi:
                # the rows this rank owns (on a mesh another rank's rows
                # here are as the last window left them, and another
                # rank's syscalls may have changed its own since)
                own = self.sim.events.min_time()[
                    self._own.start:self._own.stop]
                self._next_min = int(own.amin())
            cands = [self._next_min]
            cands += [p.wake_time for p in self.procs
                      if not p.done and p.block is not None
                      and (p.block.op == "sleep"
                           or (p.block.op in ("poll", "select")
                               and p.block.args[-1] > 0))]
            cands += [p.start_time for p in self.procs
                      if not p.done and not p.started]
            cands += [p.stop_time for p in self.procs
                      if not p.done and p.stop_time >= 0]
            # never step backward: a (buggy or already-fired) event
            # timestamped before `now` must not rewind the clock —
            # the engine's own advance rule clamps the same way
            # (engine.run: first = max(min, start_time))
            wstart = min(c for c in cands if c >= 0)
            if self._multi:
                wstart = self.mesh.all_reduce_ints([wstart], "min")[0]
            wstart = max(wstart, now)
            if wstart > end or wstart >= simtime.INVALID:
                break
            if wstart > now:
                # jump to the next deadline and resume THERE, before
                # running any device window: process starts, sleep
                # wakes, and stop kills happen at their exact sim
                # times (the reference schedules each as an event at
                # that time — process.c:1326-1360; a window-end
                # resume would make every one late by min_jump)
                now = int(wstart)
                continue
            wend = min(wstart + min_jump, end + 1)
            if _pt is not None:
                i = int(np.searchsorted(_pt, wstart, side="right"))
                if i < len(_pt):
                    wend = min(wend, int(_pt[i]))
            self.sim, stats, next_min = self._window(self.sim, wstart, wend)
            # step_window's next start is the queues' minimum: it
            # stands until a syscall emits (staged injection would join
            # it, and the queues alone decide here)
            self._next_min = (next_min if getattr(self.sim, "inject", None)
                              is None else None)
            # the device window mutated readiness state (flags/gens):
            # drop the host-side snapshot or blocked epoll_wait /
            # wait_readable polls read stale readiness forever
            self._flags_cache = None
            self._tcp_st_cache = None
            if on_window is not None:
                on_window(self.sim, wend)
            total = total.replace(
                events_processed=total.events_processed
                + stats.events_processed,
                micro_steps=total.micro_steps + stats.micro_steps,
                windows=total.windows + 1,
                fastpath_hit=total.fastpath_hit + stats.fastpath_hit,
                fastpath_miss=total.fastpath_miss + stats.fastpath_miss,
            )
            now = int(wend)
        if self.mesh is not None:
            # the syscalls since the last window changed only their own
            # rows: reassemble the global state on every rank
            from shadow_tpu_torch.parallel.shard import unshard_sim

            self.sim = self._synced = unshard_sim(
                self._sync_global(self.sim), self.mesh)
        # collect payload-pool entries whose packets died on device
        # (drops destroy packets where the host cannot unref —
        # the packet_unref analog, packet.c)
        self.gc_pool()
        return self.sim, total
