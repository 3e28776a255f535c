"""Tor-relay-shaped application model (PyTorch port of
shadow_tpu/apps/relay.py: setup, handler, and RelayTcpBulk / TCP_BULK
for the TCP bulk window pass; BASELINE.json config #3, "10k-host
Tor").

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


class RelayTcpBulk:
    """TCP bulk-pass contract (net/tcp_bulk.TcpAppBulk) for the relay
    model: in the steady state every delivery is read in full from
    up_conn and (for relays) immediately forwarded downstream — the
    per-micro-step behavior of handler() above, minus the
    accept/feed/close phases, which precheck routes to the serial
    path."""

    def precheck(self, cfg, sim):
        app = sim.app
        client = app.role == ROLE_CLIENT
        relay = app.role == ROLE_RELAY
        listener = app.lsock >= 0
        ok = torch.where(listener, app.up_conn >= 0, True)
        # clients must be past the feed + close calls (pure draining)
        ok = ok & torch.where(client, (app.to_send == 0) & app.closed_down,
                              True)
        ok = ok & (app.fwd_pending == 0)
        ok = ok & torch.where(relay | client, app.connected, True)
        # past-EOF hosts are fine once their close calls were issued:
        # relays must have propagated (closed_down); servers must have
        # taken up_conn out of the readable states (a closed or freed
        # slot; pre-ESTABLISHED states cannot occur past EOF)
        S = sim.tcp.st.shape[1]
        up = app.up_conn.clamp(0, S - 1).to(I64)
        up_st = sim.tcp.st[torch.arange(up.shape[0], device=up.device), up]
        up_done = (up_st != tcp.TcpSt.ESTABLISHED) \
            & (up_st != tcp.TcpSt.CLOSE_WAIT)
        return ok & torch.where(
            app.up_eof, torch.where(relay, app.closed_down, up_done), True)

    def on_data(self, cfg, app, mask, slot, nread, now):
        # the app only reads up_conn; data on any other socket is out
        # of the model, as is a delivery larger than one CHUNK read
        ok = ~mask | ((slot == app.up_conn) & (nread <= CHUNK))
        m = mask & (slot == app.up_conn)
        server = app.role == ROLE_SERVER
        relay = app.role == ROLE_RELAY
        app = app.replace(
            rcvd=app.rcvd + torch.where(m & server, nread, 0).to(I64))
        fwd_mask = m & relay
        return app, ok, fwd_mask, app.down_sock, torch.where(
            fwd_mask, nread, 0)

    def on_eof(self, cfg, app, mask, slot, now):
        """EOF on up_conn: the server closes it; a fully-forwarded
        relay closes down_sock then up_conn (handler()'s relay_fin). A
        FIN on any other socket needs no app action."""
        m = mask & (slot == app.up_conn) & ~app.up_eof
        server = m & (app.role == ROLE_SERVER)
        relay = m & (app.role == ROLE_RELAY)
        # a relay with unforwarded bytes would defer its closes to a
        # later wake — out of model
        ok = ~(relay & ((app.fwd_pending > 0) | ~app.connected
                        | app.closed_down))
        app = app.replace(
            up_eof=app.up_eof | m,
            done_at=torch.where(server & (app.done_at < 0), now,
                                app.done_at),
        )
        c1_mask = server | relay
        c1_slot = torch.where(server, app.up_conn, app.down_sock)
        c2_mask = relay
        c2_slot = app.up_conn
        app = app.replace(closed_down=app.closed_down | relay)
        return app, ok, c1_mask & ok, c1_slot, c2_mask & ok, c2_slot


TCP_BULK = RelayTcpBulk()
