"""Tor-relay-shaped application model (PyTorch port of
shadow_tpu/apps/relay.py: the serial form, setup and handler;
BASELINE.json config #3, "10k-host Tor").

Fixed circuits of TCP hops (client -> relays -> server) where every
relay stream-forwards bytes between an upstream and a downstream TCP
connection, as an on-device state machine. Circuits are disjoint host
chains, so 10,240 hosts = 2,048 five-hop circuits running concurrently.
Each hop connects downstream at PROC_START; data rides behind the
handshakes (send-before-established buffering in net/tcp.py). Relays
apply store-and-forward backpressure: bytes read upstream but not yet
accepted downstream are held in `fwd_pending`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from shadow_tpu_torch.core.events import EventKind, _Replace
from shadow_tpu_torch.net import tcp
from shadow_tpu_torch.net.rings import gather_hs
from shadow_tpu_torch.net.sockets import sk_bind, sk_create
from shadow_tpu_torch.net.state import NetConfig, SocketFlags, SocketType

I32 = torch.int32
I64 = torch.int64

PORT = 9001
CHUNK = 1 << 20

ROLE_NONE = 0
ROLE_CLIENT = 1
ROLE_RELAY = 2
ROLE_SERVER = 3


@dataclass
class RelayApp(_Replace):
    role: torch.Tensor         # [H] i32
    lsock: torch.Tensor        # [H] i64 listener (relay/server; -1)
    up_conn: torch.Tensor      # [H] i32 accepted upstream child (-1)
    down_sock: torch.Tensor    # [H] i64 downstream connection (-1)
    next_ip: torch.Tensor      # [H] i64 downstream hop IP (0 none)
    connected: torch.Tensor    # [H] bool downstream connect issued
    to_send: torch.Tensor      # [H] i32 client payload left to submit
    fwd_pending: torch.Tensor  # [H] i32 relay bytes read, not yet sent
    up_eof: torch.Tensor       # [H] bool upstream finished
    closed_down: torch.Tensor  # [H] bool downstream closed
    rcvd: torch.Tensor         # [H] i64 server bytes received
    done_at: torch.Tensor      # [H] i64 server EOF time (-1)


def setup(sim, *, circuits: list[list[int]], total_bytes: int):
    """circuits: each a host-index chain [client, r1, ..., server]. The
    client streams total_bytes through the chain. Tensors are built on
    the sim's device."""
    H = sim.net.host_ip.shape[0]
    dev = sim.net.host_ip.device
    role = np.zeros(H, np.int32)
    next_hop = np.full(H, -1, np.int64)
    for chain in circuits:
        role[chain[0]] = ROLE_CLIENT
        role[chain[-1]] = ROLE_SERVER
        for r in chain[1:-1]:
            role[r] = ROLE_RELAY
        for a, b in zip(chain, chain[1:]):
            next_hop[a] = b

    host_ips = sim.net.host_ip.cpu().numpy()
    next_ip = np.where(next_hop >= 0, host_ips[np.maximum(next_hop, 0)], 0)

    def t(a):
        return torch.as_tensor(a, device=dev)

    is_listener = t((role == ROLE_RELAY) | (role == ROLE_SERVER))
    has_down = t(next_hop >= 0)

    net, lsock = sk_create(sim.net, is_listener, SocketType.TCP)
    net, _ = sk_bind(net, is_listener, lsock, 0, PORT)
    sim = tcp.tcp_listen(sim.replace(net=net), is_listener, lsock)
    net, down = sk_create(sim.net, has_down, SocketType.TCP)
    sim = sim.replace(net=net)

    app = RelayApp(
        role=t(role),
        lsock=torch.where(is_listener, lsock, -1),
        up_conn=torch.full((H,), -1, dtype=I32, device=dev),
        down_sock=torch.where(has_down, down, -1),
        next_ip=t(next_ip.astype(np.int64)),
        connected=torch.zeros((H,), dtype=torch.bool, device=dev),
        to_send=t(np.where(role == ROLE_CLIENT, total_bytes, 0)
                  .astype(np.int32)),
        fwd_pending=torch.zeros((H,), dtype=I32, device=dev),
        up_eof=torch.zeros((H,), dtype=torch.bool, device=dev),
        closed_down=torch.zeros((H,), dtype=torch.bool, device=dev),
        rcvd=torch.zeros((H,), dtype=I64, device=dev),
        done_at=torch.full((H,), -1, dtype=I64, device=dev),
    )
    return sim.replace(app=app)


def handler(cfg: NetConfig, sim, popped, buf):
    app = sim.app
    now = popped.time
    woke = popped.valid
    port = torch.full_like(app.role, PORT)

    # ---- connect downstream at PROC_START ----------------------------
    start = woke & (popped.kind == EventKind.PROC_START) \
        & (app.down_sock >= 0) & ~app.connected
    sim, buf = tcp.tcp_connect(cfg, sim, start, app.down_sock, app.next_ip,
                               port, now, buf)
    app = app.replace(connected=app.connected | start)
    sim = sim.replace(app=app)

    # ---- accept one upstream child -----------------------------------
    lready = (gather_hs(sim.net.sk_flags, app.lsock)
              & SocketFlags.READABLE) != 0
    acc = woke & (app.lsock >= 0) & (app.up_conn < 0) & lready
    sim, got, child = tcp.tcp_accept(sim, acc, app.lsock)
    app = app.replace(up_conn=torch.where(got, child, app.up_conn))
    sim = sim.replace(app=app)

    # ---- client: feed the stream -------------------------------------
    feeding = woke & (app.role == ROLE_CLIENT) & app.connected \
        & (app.to_send > 0)
    sim, buf, accepted = tcp.tcp_send(cfg, sim, feeding, app.down_sock,
                                      app.to_send.clamp(max=CHUNK), now, buf)
    app = app.replace(to_send=app.to_send - accepted)
    sim = sim.replace(app=app)
    fin_client = woke & (app.role == ROLE_CLIENT) & app.connected \
        & (app.to_send == 0) & ~app.closed_down
    sim, buf = tcp.tcp_close(cfg, sim, fin_client, app.down_sock, now, buf)
    app = app.replace(closed_down=app.closed_down | fin_client)
    sim = sim.replace(app=app)

    # ---- relay/server: drain upstream --------------------------------
    drain = woke & (app.up_conn >= 0) & ~app.up_eof
    sim, buf, nread, eof = tcp.tcp_recv(
        sim, drain, app.up_conn, torch.full_like(app.role, CHUNK), now, buf)
    is_srv = app.role == ROLE_SERVER
    app = app.replace(
        fwd_pending=app.fwd_pending + torch.where(is_srv, 0, nread).to(I32),
        rcvd=app.rcvd + torch.where(is_srv, nread, 0).to(I64),
        up_eof=app.up_eof | eof,
        done_at=torch.where(eof & is_srv & (app.done_at < 0), now,
                            app.done_at),
    )
    sim = sim.replace(app=app)
    # server closes its side on EOF
    sim, buf = tcp.tcp_close(cfg, sim, eof & is_srv, app.up_conn, now, buf)

    # ---- relay: forward downstream -----------------------------------
    app = sim.app
    fwd = woke & (app.role == ROLE_RELAY) & (app.fwd_pending > 0) \
        & app.connected
    sim, buf, fsent = tcp.tcp_send(cfg, sim, fwd, app.down_sock,
                                   app.fwd_pending, now, buf)
    app = app.replace(fwd_pending=app.fwd_pending - fsent)
    sim = sim.replace(app=app)
    # relay propagates EOF once everything has been forwarded
    relay_fin = woke & (app.role == ROLE_RELAY) & app.up_eof \
        & (app.fwd_pending == 0) & ~app.closed_down
    sim, buf = tcp.tcp_close(cfg, sim, relay_fin, app.down_sock, now, buf)
    app = sim.app.replace(closed_down=sim.app.closed_down | relay_fin)
    # ... and closes its upstream side
    sim = sim.replace(app=app)
    return tcp.tcp_close(cfg, sim, relay_fin, app.up_conn, now, buf)
