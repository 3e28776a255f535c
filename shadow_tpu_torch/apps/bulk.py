"""On-device TCP bulk-transfer application (PyTorch port of
shadow_tpu/apps/bulk.py) — the tgen bulk-download analog (BASELINE.json
config #2; ref: examples.c:10-30 "1000 clients downloading") and the
app behind the `bulk`, `tgen-bulk` and `filetransfer` plugins of
config/loader.py, the built-in `--test` example among them.

Client: at PROC_START, connects to its assigned server and streams
`total_bytes`; when everything has been submitted it closes (the FIN
rides out behind the data). Server: accepts children off the listener
and drains them until EOF, counting received bytes.

Servers handle children concurrently, like the reference's
epoll-driven bulk server: every wakeup accepts one queued connection
(if any) and drains one readable child, cyclic-fair across the
accepted set. Concurrency is bounded by the socket table
(sockets_per_host); beyond that, SYN-retry backpressure applies.
`rcvd` accumulates across children; `eof` is sticky ("saw at least
one EOF") and `done_at` tracks the latest EOF time.
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

CHUNK = 1 << 20  # max bytes submitted to the socket per app wakeup


@dataclass
class BulkApp(_Replace):
    is_client: torch.Tensor    # [H] bool
    is_server: torch.Tensor    # [H] bool
    lsock: torch.Tensor        # [H] i64 server listener slot (-1)
    csock: torch.Tensor        # [H] i64 client connection slot (-1)
    children: torch.Tensor     # [H,S] bool accepted children in flight
    child_rr: torch.Tensor     # [H] i32 drain-fairness cursor
    server_ip: torch.Tensor    # [H] i64
    server_port: torch.Tensor  # [H] i32
    to_send: torch.Tensor      # [H] i32 bytes not yet submitted
    connected: torch.Tensor    # [H] bool client connect() issued
    closed: torch.Tensor       # [H] bool client close() issued
    rcvd: torch.Tensor         # [H] i64 server bytes received
    eof: torch.Tensor          # [H] bool server saw EOF
    done_at: torch.Tensor      # [H] i64 sim time of server EOF (-1)
    recv_chunk: torch.Tensor   # [H] i32 max bytes drained per wakeup
    drain_after: torch.Tensor  # [H] i64 server drains only at/after
                               # this sim time (a stalled reader)


def setup(sim, *, client_mask, server_mask, server_ip, server_port: int,
          total_bytes: int, server_recv_chunk: int = CHUNK,
          server_drain_after: int = 0):
    """Create sockets (listener bound and listening; client socket made
    but not connected) and the app state, on the sim's device."""
    H = sim.net.host_ip.shape[0]
    dev = sim.net.host_ip.device
    client_mask = torch.as_tensor(client_mask, device=dev)
    server_mask = torch.as_tensor(server_mask, device=dev)
    net, lsock = sk_create(sim.net, server_mask, SocketType.TCP)
    net, _ = sk_bind(net, server_mask, lsock, 0, server_port)
    sim = tcp.tcp_listen(sim.replace(net=net), server_mask, lsock)
    net, csock = sk_create(sim.net, client_mask, SocketType.TCP)
    sim = sim.replace(net=net)
    S = sim.net.sk_type.shape[1]
    app = BulkApp(
        is_client=client_mask,
        is_server=server_mask,
        lsock=torch.where(server_mask, lsock, -1),
        csock=torch.where(client_mask, csock, -1),
        children=torch.zeros((H, S), dtype=torch.bool, device=dev),
        child_rr=torch.zeros((H,), dtype=I32, device=dev),
        server_ip=torch.broadcast_to(
            torch.as_tensor(server_ip, dtype=I64, device=dev), (H,)).clone(),
        server_port=torch.full((H,), server_port, dtype=I32, device=dev),
        to_send=torch.where(client_mask, total_bytes, 0).to(I32),
        connected=torch.zeros((H,), dtype=torch.bool, device=dev),
        closed=torch.zeros((H,), dtype=torch.bool, device=dev),
        rcvd=torch.zeros((H,), dtype=I64, device=dev),
        eof=torch.zeros((H,), dtype=torch.bool, device=dev),
        done_at=torch.full((H,), -1, dtype=I64, device=dev),
        recv_chunk=torch.full((H,), server_recv_chunk, dtype=I32, device=dev),
        drain_after=torch.full((H,), server_drain_after, dtype=I64,
                               device=dev),
    )
    return sim.replace(app=app)


def handler(cfg: NetConfig, sim, popped, buf):
    app = sim.app
    now = popped.time
    woke = popped.valid  # react to any event on this host

    # ---- client: connect once at PROC_START --------------------------
    start = woke & (popped.kind == EventKind.PROC_START) \
        & app.is_client & ~app.connected
    sim, buf = tcp.tcp_connect(cfg, sim, start, app.csock,
                               app.server_ip, app.server_port, now, buf)
    app = app.replace(connected=app.connected | start)
    sim = sim.replace(app=app)

    # ---- client: keep the send buffer full ---------------------------
    feeding = woke & app.is_client & app.connected & (app.to_send > 0)
    sim, buf, accepted = tcp.tcp_send(cfg, sim, feeding, app.csock,
                                      app.to_send.clamp(max=CHUNK), now, buf)
    app = app.replace(to_send=app.to_send - accepted)
    sim = sim.replace(app=app)

    # ---- client: close once everything is submitted ------------------
    finish = woke & app.is_client & app.connected & (app.to_send == 0) \
        & ~app.closed
    sim, buf = tcp.tcp_close(cfg, sim, finish, app.csock, now, buf)
    app = app.replace(closed=app.closed | finish)
    sim = sim.replace(app=app)

    # ---- server: accept one pending child per wakeup -----------------
    S = sim.net.sk_type.shape[1]
    cols = torch.arange(S, device=now.device)[None, :]
    lready = (gather_hs(sim.net.sk_flags, app.lsock)
              & SocketFlags.READABLE) != 0
    acc = woke & app.is_server & lready
    sim, got, child = tcp.tcp_accept(sim, acc, app.lsock)
    sel = got[:, None] & (cols == child[:, None])
    app = app.replace(children=app.children | sel)
    sim = sim.replace(app=app)

    # ---- server: drain one readable child, cyclic-fair ---------------
    readable = (sim.net.sk_flags & SocketFlags.READABLE) != 0
    cand = app.children & readable
    key = (cols - app.child_rr[:, None]) % S
    key = torch.where(cand, key, S + 1)
    slot = key.argmin(dim=1).to(I32)
    have = cand.any(dim=1)
    drain = woke & app.is_server & have
    slot = torch.where(drain, slot, -1)
    chunk = torch.where(now >= app.drain_after, app.recv_chunk, 0)
    sim, buf, nread, eof = tcp.tcp_recv(sim, drain, slot, chunk, now, buf)
    app = app.replace(
        rcvd=app.rcvd + nread.to(I64),
        eof=app.eof | eof,
        done_at=torch.where(eof, now, app.done_at),
        child_rr=torch.where(drain, (slot + 1) % S, app.child_rr),
    )
    sim = sim.replace(app=app)
    # close our side in response to EOF (server-side passive close)
    # and release the child from the accepted set
    sim, buf = tcp.tcp_close(cfg, sim, eof, slot, now, buf)
    clear = eof[:, None] & (cols == slot[:, None])
    app = sim.app.replace(children=sim.app.children & ~clear)
    return sim.replace(app=app), buf
