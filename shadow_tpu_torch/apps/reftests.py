"""The reference's syscall-semantics test plugins, as virtual
processes (the port's copy of shadow_tpu/apps/reftests.py, over its own
vproc) — so the reference's OWN shadow configs (src/test/{bind,
epoll,poll,sockbuf,timerfd,sleep,shutdown}/*.test.shadow.config.xml)
run verbatim through the CLI/loader, exercising the same simulated-
kernel surface their C plugins exercise (ref: SURVEY.md §4's
dual-mode test pattern; the native-executable mode is the part with
no TPU analog).

Each generator mirrors the C test's syscall sequence and assertions
(cited per function). Deviations are noted inline: sub-tests touching
the plugin's REAL file system (creat/fwrite) or glibc internals have
no analog in the virtual-process surface and are skipped — the
reference runs those same sub-tests primarily in its native mode.

A failed assertion raises, which the ProcessRuntime surfaces exactly
like the reference's nonzero plugin exit (slave_incrementPluginError,
slave.c:468-473).
"""

from __future__ import annotations

from shadow_tpu_torch.net.state import SocketType
from shadow_tpu_torch.process import vproc

S_TO_NS = 1_000_000_000


def bind_main(env):
    """test_bind.c:79-115 (_test_explicit_bind, run for TCP then UDP,
    main:244-252): re-bind of a bound socket fails (EINVAL), binding a
    second socket to a taken port fails (EADDRINUSE) for specific and
    ANY addresses alike, and a different port succeeds. The
    getsockname/getpeername sub-test (test_bind.c:117-180) has no
    analog surface and is skipped."""
    port = 11111
    for stype in (SocketType.TCP, SocketType.UDP):
        fd1 = yield vproc.socket(stype)
        fd2 = yield vproc.socket(stype)
        assert fd1 >= 0 and fd2 >= 0
        r = yield vproc.bind(fd1, port)
        assert r != -1, "first bind must succeed"
        r = yield vproc.bind(fd1, port + 1)
        assert r == -1, "re-bind must fail (EINVAL, test_bind.c:93-95)"
        r = yield vproc.bind(fd2, port)
        assert r == -1, "bind to taken port must fail (EADDRINUSE)"
        r = yield vproc.bind(fd2, port + 2)
        assert r != -1, "bind to a free port must succeed"
        yield vproc.close(fd1)
        yield vproc.close(fd2)
        port += 10


def epoll_main(env):
    """test_epoll.c:54-130 (_test_pipe_helper, level + oneshot): an
    empty pipe must NOT report readable (verified here by racing a
    100 ms timer against the pipe — the C test uses epoll_wait's
    timeout, test_epoll.c:75-83); after a write it must; EPOLLONESHOT
    reports exactly once until re-armed."""
    for oneshot in (False, True):
        rfd, wfd = yield vproc.pipe()
        efd = yield vproc.epoll_create()
        tfd = yield vproc.timerfd_create()
        flags = vproc.EPOLL.IN | (vproc.EPOLL.ONESHOT if oneshot else 0)
        yield vproc.epoll_ctl(efd, vproc.EPOLL.CTL_ADD, rfd, flags)
        yield vproc.epoll_ctl(efd, vproc.EPOLL.CTL_ADD, tfd, vproc.EPOLL.IN)
        yield vproc.timerfd_settime(tfd, 100_000_000)  # 100ms
        events = yield vproc.epoll_wait(efd)
        fds = [fd for fd, _ in events]
        assert rfd not in fds, "empty pipe must not be readable"
        assert tfd in fds, "the timer must have fired instead"
        yield vproc.timerfd_read(tfd)

        yield vproc.write(wfd, b"test")
        events = yield vproc.epoll_wait(efd)
        fds = [fd for fd, _ in events]
        assert rfd in fds, "pipe with data must be readable"
        if oneshot:
            # consumed notification: a second wait must NOT re-report
            # the pipe until re-armed (test_epoll.c:103-127)
            yield vproc.timerfd_settime(tfd, 100_000_000)
            events = yield vproc.epoll_wait(efd)
            fds = [fd for fd, _ in events]
            assert rfd not in fds, "oneshot must report only once"
            assert tfd in fds
            yield vproc.timerfd_read(tfd)
            yield vproc.epoll_ctl(efd, vproc.EPOLL.CTL_MOD, rfd, flags)
            events = yield vproc.epoll_wait(efd)
            assert rfd in [fd for fd, _ in events], "re-arm must re-report"
        data = yield vproc.read(rfd)
        assert data == b"test", data
        yield vproc.close(rfd)
        yield vproc.close(wfd)


def poll_main(env):
    """test_poll.c:28-96 (_test_pipe): an empty pipe polls not-ready
    (raced against a 100 ms timer, standing in for poll's timeout);
    after writing 'test' it polls readable and reads back the same
    bytes. The creat/file sub-test (test_poll.c:98-160) touches the
    plugin's real filesystem and is skipped."""
    rfd, wfd = yield vproc.pipe()
    tfd = yield vproc.timerfd_create()
    yield vproc.timerfd_settime(tfd, 100_000_000)
    ready = yield vproc.wait_readable([rfd, tfd])
    assert rfd not in ready, "empty pipe must not poll readable"
    yield vproc.timerfd_read(tfd)

    yield vproc.write(wfd, b"test")
    ready = yield vproc.wait_readable([rfd])
    assert rfd in ready
    data = yield vproc.read(rfd)
    assert data == b"test", data
    yield vproc.close(rfd)
    yield vproc.close(wfd)


def sockbuf_main(env):
    """test_sockbuf.c:57-88: SO_SNDBUF/SO_RCVBUF set then get must
    round-trip through the simulated socket (pinning them also
    disables that direction's autotuning, the property the
    reference's sockbuf config exercises end-to-end)."""
    fd = yield vproc.socket(SocketType.TCP)
    r = yield vproc.setsockopt(fd, vproc.SO.SNDBUF, 100_000)
    assert r == 0
    r = yield vproc.setsockopt(fd, vproc.SO.RCVBUF, 200_000)
    assert r == 0
    snd = yield vproc.getsockopt(fd, vproc.SO.SNDBUF)
    rcv = yield vproc.getsockopt(fd, vproc.SO.RCVBUF)
    assert snd == 100_000, snd
    assert rcv == 200_000, rcv
    yield vproc.close(fd)


def timerfd_main(env):
    """test_timerfd.c: arm 1 s, epoll-wait for expiry, read must
    return 1 expiration (:60-120); a disarmed timer (settime 0,
    :176-210) must NOT fire — raced against a live 2 s timer."""
    efd = yield vproc.epoll_create()
    tfd = yield vproc.timerfd_create()
    yield vproc.epoll_ctl(efd, vproc.EPOLL.CTL_ADD, tfd, vproc.EPOLL.IN)
    yield vproc.timerfd_settime(tfd, 1 * S_TO_NS)
    events = yield vproc.epoll_wait(efd)
    assert tfd in [fd for fd, _ in events]
    n = yield vproc.timerfd_read(tfd)
    assert n == 1, n

    # disarm: arm 3s then settime(0); a second timer at 2s must win
    tfd2 = yield vproc.timerfd_create()
    yield vproc.epoll_ctl(efd, vproc.EPOLL.CTL_ADD, tfd2, vproc.EPOLL.IN)
    yield vproc.timerfd_settime(tfd, 3 * S_TO_NS)
    yield vproc.timerfd_settime(tfd, 0)          # disarm
    yield vproc.timerfd_settime(tfd2, 2 * S_TO_NS)
    events = yield vproc.epoll_wait(efd)
    fds = [fd for fd, _ in events]
    assert tfd not in fds, "disarmed timer must not fire"
    assert tfd2 in fds
    n = yield vproc.timerfd_read(tfd2)
    assert n == 1


def sleep_main(env):
    """test_sleep.c:41-70 (_sleep_run_test for sleep/usleep/nanosleep
    — one simulated surface): sleep 1 s, clock delta must be 1 s
    within the reference's 10 ms tolerance (simulated time is exact,
    so this asserts equality)."""
    for _ in range(3):   # the reference runs 3 sleep variants
        t0 = yield vproc.gettime()
        yield vproc.sleep(1 * S_TO_NS)
        t1 = yield vproc.gettime()
        assert t1 - t0 == 1 * S_TO_NS, (t0, t1)


def shutdown_main(env):
    """test_shutdown.c, condensed to the half-close contract the
    reference verifies over a SINGLE node's loopback (its config runs
    one process owning both ends, test_shutdown.c:447 main ->
    _test_read/write_after_shutdown): after the client side's
    shutdown(SHUT_WR) the accepted child reads the in-flight bytes
    then EOF, the child->client direction STILL delivers, and the
    client sees EOF once the child closes. The listener spawns the
    child during connect's handshake, so one coroutine can drive both
    ends (the reference uses nonblocking sockets the same way)."""
    port = 13131
    self_ip = env["resolve"](env["host"])
    lfd = yield vproc.socket(SocketType.TCP)
    yield vproc.bind(lfd, port)
    yield vproc.listen(lfd)
    cfd = yield vproc.socket(SocketType.TCP)
    r = yield vproc.connect(cfd, self_ip, port)
    assert r == 0, "loopback connect must succeed"
    child = yield vproc.accept(lfd)
    assert child >= 0

    n = yield vproc.send_data(cfd, b"ping")
    assert n == 4
    yield vproc.shutdown(cfd, vproc.SHUT_WR)
    data = yield vproc.recv_data(child)
    assert data == b"ping", data
    eof = yield vproc.recv(child)
    assert eof == 0, "shutdown(WR) must read as EOF on the peer"

    n = yield vproc.send_data(child, b"pong")
    assert n == 4, "the un-shut direction must still deliver"
    data = yield vproc.recv_data(cfd)
    assert data == b"pong", data
    yield vproc.close(child)
    eof = yield vproc.recv(cfd)
    assert eof == 0, "peer close must read as EOF"
    yield vproc.close(cfd)
    yield vproc.close(lfd)


def epoll_writeable_main(env):
    """test_epoll_writeable.c: the server accepts, registers EPOLLOUT
    on the child, and pushes 30 x 16 KiB driven purely by writability
    wakeups (:95-160); the client (starting 9 s later per the config)
    drains the full 480 KiB (:25-57)."""
    WRITE_SZ = 16384
    TOTAL = 30 * WRITE_SZ
    port = 22222
    if env["args"] and env["args"][0] == "server":
        fd = yield vproc.socket(SocketType.TCP)
        yield vproc.bind(fd, port)
        yield vproc.listen(fd)
        child = yield vproc.accept(fd)
        efd = yield vproc.epoll_create()
        yield vproc.epoll_ctl(efd, vproc.EPOLL.CTL_ADD, child,
                              vproc.EPOLL.OUT)
        sent = 0
        while sent < TOTAL:
            events = yield vproc.epoll_wait(efd)
            assert events, "EPOLLOUT wait returned no events"
            assert events[0][0] == child
            n = yield vproc.send(child, min(WRITE_SZ, TOTAL - sent))
            assert n > 0
            sent += n
        yield vproc.close(child)
        yield vproc.close(fd)
    else:
        if len(env["args"]) > 1:
            server_name = env["args"][1]
        elif "testnode" in env["hosts"]:
            # the reference's epoll-writeable config names its server
            # host "testnode"; honor that default only when it exists
            server_name = "testnode"
        else:
            raise ValueError(
                "epoll_writeable client needs the server hostname as its "
                "second process argument (no host named 'testnode' in "
                "this config)")
        server_ip = env["resolve"](server_name)
        fd = yield vproc.socket(SocketType.TCP)
        r = yield vproc.connect(fd, server_ip, port)
        assert r == 0
        recvd = 0
        while recvd < TOTAL:
            n = yield vproc.recv(fd)
            if n == 0:
                break
            recvd += n
        assert recvd == TOTAL, recvd
        yield vproc.close(fd)


# ---------------------------------------------------------------------
# r5 surface breadth (VERDICT r4 #4): file / random / signal /
# pthreads / unistd — the five syscall dirs r4 could not run verbatim
# ---------------------------------------------------------------------

def file_main(env):
    """test_file.c: _test_newfile (:40-45), _test_write (:47-58),
    _test_read (:60-74), _test_fwrite/_test_fread (:76-100 — the
    stdio forms reduce to the same read/write surface), plus the
    unlink/ENOENT and lseek/fstat semantics those helpers rely on
    (tmpfile_make/tmpfile_delete). The iovec sub-test
    (_test_iov, :101-160) exercises readv/writev argument validation
    against glibc internals — no analog surface, skipped (the
    reference runs it primarily in native mode)."""
    # _test_newfile: create, close, unlink
    fd = yield vproc.fopen("testfile", "w")
    assert fd >= 0, "fopen(w) must create"
    yield vproc.close(fd)
    r = yield vproc.funlink("testfile")
    assert r == 0
    r = yield vproc.fopen("missing", "r")
    assert r == -1, "fopen(r) on a missing file must fail (ENOENT)"

    # tmpfile_make("testfile", "test") + _test_write
    fd = yield vproc.fopen("testfile", "w")
    n = yield vproc.write(fd, b"test")
    assert n == 4
    yield vproc.close(fd)
    fd = yield vproc.fopen("testfile", "r+")
    assert fd >= 0
    n = yield vproc.write(fd, b"test")
    assert n == 4
    yield vproc.close(fd)

    # _test_read / _test_fread
    fd = yield vproc.fopen("testfile", "r")
    data = yield vproc.read(fd, 4)
    assert data == b"test", data
    # lseek + re-read (the rewind fread depends on)
    pos = yield vproc.fseek(fd, 0, vproc.SEEK_SET)
    assert pos == 0
    data = yield vproc.read(fd, 4)
    assert data == b"test", data
    size = yield vproc.fstat_size(fd)
    assert size == 4, size
    yield vproc.close(fd)

    # write via a bad fd is EBADF
    n = yield vproc.write(1923 + vproc.FILE_FD_BASE, b"x")
    assert n == -1, "EBADF write must fail (test_file.c:124)"
    r = yield vproc.funlink("testfile")
    assert r == 0


def random_main(env):
    """test_random.c: _test_dev_urandom (:17-50 — 100 4-byte draws
    from the host random source; both distribution tails must be
    seen) and _test_rand (:52-60 — 100 rand() draws in
    [0, RAND_MAX])."""
    yield vproc.write(1, b"########## random test starting ##########\n")
    num_low = num_high = 0
    for _ in range(100):
        data = yield vproc.getrandom(4)
        assert len(data) == 4
        v = int.from_bytes(data, "little")
        frac = v / 0xFFFFFFFF
        if frac < 0.1:
            num_low += 1
        elif frac > 0.9:
            num_high += 1
    assert num_low > 0 and num_high > 0, (num_low, num_high)
    for _ in range(100):
        v = yield vproc.c_rand()
        assert 0 <= v < (1 << 31)
    # the C test's stdout banner rides the per-process stdout file
    # (ref: process.c's <data>/hosts/<name>/*.stdout)
    yield vproc.write(1, b"########## random test passed! ##########\n")


def signal_main(env):
    """test_signal.c: install a SIGSEGV handler via sigaction
    (main:28-34), trigger the signal (:37-39 — the null-call fault
    becomes an explicit raise on this surface), and succeed from the
    handler exactly once (signal_handled_func:12-24)."""
    yield vproc.write(1, b"########## signal test starting ##########\n")
    handled = []
    yield vproc.sigaction(vproc.SIGSEGV, lambda sig: handled.append(sig))
    r = yield vproc.raise_sig(vproc.SIGSEGV)
    assert r == 0, "installed handler must run"
    assert handled == [vproc.SIGSEGV], handled
    yield vproc.write(1, b"########## signal test passed! ##########\n")


def pthreads_main(env):
    """test_pthreads.c: _test_thread_returnOne joined through
    _test_joinThreads (:27-31,106-123 — join returns the thread's
    value), and the mutex lock/trylock protocol
    (_test_mutex_lock:162-216, _test_mutex_trylock:218-278): a held
    mutex fails trylock and blocks lock until the holder releases."""
    def t_return_one(host):
        yield vproc.gettime()
        return 1

    tids = []
    for _ in range(4):    # NUM_THREADS join loop (:106-123)
        tids.append((yield vproc.thread_create(t_return_one)))
    for tid in tids:
        r = yield vproc.thread_join(tid)
        assert r == 1, r

    mid = yield vproc.mutex_init()
    r = yield vproc.mutex_lock(mid)
    assert r == 0
    state = {"thread_got_lock": False}

    def t_contender(host):
        got = yield vproc.mutex_trylock(mid)
        assert got is False, "trylock of a held mutex must fail (EBUSY)"
        yield vproc.mutex_lock(mid)       # blocks until main unlocks
        state["thread_got_lock"] = True
        yield vproc.mutex_unlock(mid)

    tid = yield vproc.thread_create(t_contender)
    yield vproc.sleep(1 * S_TO_NS)        # let the contender hit the lock
    assert not state["thread_got_lock"]
    yield vproc.mutex_unlock(mid)
    yield vproc.thread_join(tid)
    assert state["thread_got_lock"]


def unistd_main(env):
    """test_unistd.c: _test_getpid_nodeps (:13-17 — positive and
    stable), _test_getpid_kill (:27-36 — kill(getpid(), SIGUSR1)
    runs the installed handler exactly once; the reference skips
    this under shadow pending kill support, main:100-104 — this
    surface has it), and _test_gethostname (:38-70 — matches the
    configured node name passed as argv nodename). uname is skipped
    like the reference's TODO (main:110-113)."""
    pid = yield vproc.getpid()
    assert pid > 0
    pid2 = yield vproc.getpid()
    assert pid2 == pid

    counts = [0]

    def inc(sig):
        counts[0] += 1

    yield vproc.sigaction(vproc.SIGUSR1, inc)
    r = yield vproc.kill(pid, vproc.SIGUSR1)
    assert r == 0
    assert counts[0] == 1, counts

    name = yield vproc.gethostname()
    expected = env["args"][1] if len(env["args"]) > 1 else env["host"]
    assert name == expected, (name, expected)


# the tgen traffic model's dual-mode twin lives with its compiler
# (apps/tgen.py); re-exported here because the hostrun catalog
# resolves workload programs from this module by name
from shadow_tpu_torch.apps.tgen import tgen_main  # noqa: E402,F401
