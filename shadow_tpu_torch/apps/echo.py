"""On-device TCP echo application (PyTorch port of
shadow_tpu/apps/echo.py) — the workload of the reference's dual-mode
tcp tests (ref: src/test/tcp/test_tcp.c) and the app behind the
`testtcp` plugin of config/loader.py: the client connects, streams
BUFFERSIZE (20,000) bytes, then receives the same number of bytes back
and closes; the server accepts, drains the full message, echoes it,
and closes (test_tcp.c:713-806 _run_client/_run_server).

The reference builds one binary in four io modes (blocking /
nonblocking-poll / nonblocking-epoll / nonblocking-select); the io mode
changes how the plugin waits, not what crosses the wire, so one device
model covers all four. Content equality (the reference's memcmp) is
byte-count equality here.

Servers handle children concurrently like apps/bulk.py: one accept
plus one child operation (drain and/or echo-send) per wakeup,
cyclic-fair.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from shadow_tpu_torch.core.events import EventKind, _Replace
from shadow_tpu_torch.net import tcp
from shadow_tpu_torch.net.rings import gather_hs
from shadow_tpu_torch.net.sockets import sk_bind, sk_create
from shadow_tpu_torch.net.state import NetConfig, SocketFlags, SocketType

I32 = torch.int32
I64 = torch.int64

BUFFERSIZE = 20_000   # ref: test_tcp.c:30
CHUNK = 1 << 20


@dataclass
class EchoApp(_Replace):
    is_client: torch.Tensor     # [H] bool
    is_server: torch.Tensor     # [H] bool
    lsock: torch.Tensor         # [H] i64 listener slot (-1)
    csock: torch.Tensor         # [H] i64 client connection slot (-1)
    server_ip: torch.Tensor     # [H] i64
    server_port: torch.Tensor   # [H] i32
    nbytes: torch.Tensor        # [H] i32 message size each direction
    # client side
    to_send: torch.Tensor       # [H] i32 bytes not yet submitted
    connected: torch.Tensor     # [H] bool
    c_rcvd: torch.Tensor        # [H] i64 echoed bytes received back
    c_closed: torch.Tensor      # [H] bool
    done_at: torch.Tensor       # [H] i64 client completion time (-1)
    # server side (per accepted child)
    children: torch.Tensor      # [H,S] bool
    ch_rcvd: torch.Tensor       # [H,S] i32 bytes drained from this child
    ch_to_echo: torch.Tensor    # [H,S] i32 echo bytes not yet submitted
    ch_armed: torch.Tensor      # [H,S] bool echo phase started
    child_rr: torch.Tensor      # [H] i32 fairness cursor
    s_rcvd: torch.Tensor        # [H] i64 total server bytes drained
    s_echoed: torch.Tensor      # [H] i64 total echo bytes submitted


def setup(sim, *, client_mask, server_mask, server_ip, server_port: int,
          nbytes: int = BUFFERSIZE):
    H = sim.net.host_ip.shape[0]
    S = sim.net.sk_type.shape[1]
    dev = sim.net.host_ip.device
    client_mask = torch.as_tensor(client_mask, device=dev)
    server_mask = torch.as_tensor(server_mask, device=dev)
    net, lsock = sk_create(sim.net, server_mask, SocketType.TCP)
    net, _ = sk_bind(net, server_mask, lsock, 0, server_port)
    sim = tcp.tcp_listen(sim.replace(net=net), server_mask, lsock)
    net, csock = sk_create(sim.net, client_mask, SocketType.TCP)
    sim = sim.replace(net=net)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    app = EchoApp(
        is_client=client_mask,
        is_server=server_mask,
        lsock=torch.where(server_mask, lsock, -1),
        csock=torch.where(client_mask, csock, -1),
        server_ip=torch.broadcast_to(
            torch.as_tensor(server_ip, dtype=I64, device=dev), (H,)).clone(),
        server_port=torch.full((H,), server_port, dtype=I32, device=dev),
        nbytes=torch.full((H,), nbytes, dtype=I32, device=dev),
        to_send=torch.where(client_mask, nbytes, 0).to(I32),
        connected=zeros((H,), torch.bool),
        c_rcvd=zeros((H,), I64),
        c_closed=zeros((H,), torch.bool),
        done_at=torch.full((H,), -1, dtype=I64, device=dev),
        children=zeros((H, S), torch.bool),
        ch_rcvd=zeros((H, S), I32),
        ch_to_echo=zeros((H, S), I32),
        ch_armed=zeros((H, S), torch.bool),
        child_rr=zeros((H,), I32),
        s_rcvd=zeros((H,), I64),
        s_echoed=zeros((H,), I64),
    )
    return sim.replace(app=app)


def _set_child(arr, mask, slot, val):
    """arr[H,S] with (lane, slot) set to val ([H] or a scalar) on masked
    lanes."""
    S = arr.shape[1]
    sel = mask[:, None] & (torch.arange(S, device=arr.device)[None, :]
                           == slot[:, None])
    val = torch.as_tensor(val, dtype=arr.dtype, device=arr.device)
    return torch.where(sel, val[:, None] if val.ndim == 1 else val, arr)


def handler(cfg: NetConfig, sim, popped, buf):
    app = sim.app
    now = popped.time
    woke = popped.valid
    S = sim.net.sk_type.shape[1]
    H = woke.shape[0]
    dev = woke.device
    chunk = torch.full((H,), CHUNK, dtype=I32, device=dev)

    # ---- client: connect at PROC_START -------------------------------
    start = woke & (popped.kind == EventKind.PROC_START) \
        & app.is_client & ~app.connected
    sim, buf = tcp.tcp_connect(cfg, sim, start, app.csock,
                               app.server_ip, app.server_port, now, buf)
    app = app.replace(connected=app.connected | start)
    sim = sim.replace(app=app)

    # ---- client: stream the outbound message -------------------------
    feeding = woke & app.is_client & app.connected & (app.to_send > 0)
    sim, buf, accepted = tcp.tcp_send(cfg, sim, feeding, app.csock,
                                      app.to_send.clamp(max=CHUNK), now, buf)
    app = app.replace(to_send=app.to_send - accepted)
    sim = sim.replace(app=app)

    # ---- client: drain the echo, close when complete -----------------
    # (ref: _run_client recv-then-close, test_tcp.c:744-764)
    cready = (gather_hs(sim.net.sk_flags, app.csock)
              & SocketFlags.READABLE) != 0
    cdrain = woke & app.is_client & app.connected & cready & ~app.c_closed
    sim, buf, nread, _eof = tcp.tcp_recv(sim, cdrain, app.csock, chunk,
                                         now, buf)
    app = sim.app.replace(c_rcvd=sim.app.c_rcvd + nread.to(I64))
    sim = sim.replace(app=app)
    finish = woke & app.is_client & ~app.c_closed \
        & (app.c_rcvd >= app.nbytes.to(I64)) & (app.to_send == 0)
    sim, buf = tcp.tcp_close(cfg, sim, finish, app.csock, now, buf)
    app = app.replace(c_closed=app.c_closed | finish,
                      done_at=torch.where(finish, now, app.done_at))
    sim = sim.replace(app=app)

    # ---- server: accept one pending child per wakeup -----------------
    cols = torch.arange(S, device=dev)[None, :]
    lready = (gather_hs(sim.net.sk_flags, app.lsock)
              & SocketFlags.READABLE) != 0
    acc = woke & app.is_server & lready
    sim, got, child = tcp.tcp_accept(sim, acc, app.lsock)
    sel = got[:, None] & (cols == child[:, None])
    app = app.replace(
        children=app.children | sel,
        ch_rcvd=torch.where(sel, 0, app.ch_rcvd),
        ch_to_echo=torch.where(sel, 0, app.ch_to_echo),
        ch_armed=torch.where(sel, False, app.ch_armed),
    )
    sim = sim.replace(app=app)

    # ---- server: operate one child (drain and/or echo), cyclic-fair --
    readable = (sim.net.sk_flags & SocketFlags.READABLE) != 0
    cand = app.children & (readable | (app.ch_to_echo > 0))
    key = (cols - app.child_rr[:, None]) % S
    key = torch.where(cand, key, S + 1)
    slot = key.argmin(dim=1).to(I32)
    have = cand.any(dim=1)
    act = woke & app.is_server & have
    slot = torch.where(act, slot, -1)

    # drain (ref: _run_server _do_recv, test_tcp.c:790-794)
    sim, buf, nread, _eof2 = tcp.tcp_recv(sim, act, slot, chunk, now, buf)
    app = sim.app
    rc = gather_hs(app.ch_rcvd, slot) + nread
    app = app.replace(
        ch_rcvd=_set_child(app.ch_rcvd, act, slot, rc),
        s_rcvd=app.s_rcvd + nread.to(I64),
    )
    # arm the echo once the whole message arrived
    # (ref: _do_recv returns only at BUFFERSIZE, then _do_send)
    arm = act & ~gather_hs(app.ch_armed, slot) \
        & (gather_hs(app.ch_rcvd, slot) >= app.nbytes)
    app = app.replace(
        ch_armed=_set_child(app.ch_armed, arm, slot, torch.ones_like(arm)),
        ch_to_echo=_set_child(app.ch_to_echo, arm, slot, app.nbytes),
    )
    sim = sim.replace(app=app)

    # echo-send
    te = gather_hs(app.ch_to_echo, slot)
    sending = act & (te > 0)
    sim, buf, sent = tcp.tcp_send(cfg, sim, sending, slot,
                                  te.clamp(max=CHUNK), now, buf)
    app = sim.app
    app = app.replace(
        ch_to_echo=_set_child(app.ch_to_echo, sending, slot, te - sent),
        s_echoed=app.s_echoed + sent.to(I64),
        child_rr=torch.where(act, (slot + 1) % S, app.child_rr),
    )
    sim = sim.replace(app=app)

    # close the child once the echo is fully submitted — the reference
    # server closes right after _do_send, without waiting for the
    # client's FIN (test_tcp.c:797-806); the FIN rides behind the
    # queued echo data exactly like its close() does
    done = act & gather_hs(app.ch_armed, slot) \
        & (gather_hs(app.ch_to_echo, slot) == 0)
    sim, buf = tcp.tcp_close(cfg, sim, done, slot, now, buf)
    clear = done[:, None] & (cols == slot[:, None])
    app = sim.app.replace(children=sim.app.children & ~clear)
    return sim.replace(app=app), buf
