"""Tor-relay-shaped application model (PyTorch port of
shadow_tpu/apps/relay.py; BASELINE.json config #3, "10k-host Tor"):
the disjoint model (setup, handler, RelayTcpBulk / TCP_BULK) and the
shared-relay model (setup_shared, mux_handler, RelayMuxTcpBulk /
MUX_TCP_BULK, consensus_circuits), each with its contract for the TCP
bulk window pass.

Fixed circuits of TCP hops (client -> relays -> server) where every
relay stream-forwards bytes between an upstream and a downstream TCP
connection, as an on-device state machine. In the disjoint model the
circuits are disjoint host chains, so 10,240 hosts = 2,048 five-hop
circuits running concurrently; in the shared-relay model (the
`tools/scale_run.py --workload tor` shape) relays and servers carry up
to C circuits each, drawn by consensus weight.
Each hop connects downstream at PROC_START; data rides behind the
handshakes (send-before-established buffering in net/tcp.py). Relays
apply store-and-forward backpressure: bytes read upstream but not yet
accepted downstream are held in `fwd_pending`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from shadow_tpu_torch.core.events import EventKind, _Replace, census_mask
from shadow_tpu_torch.net import tcp
from shadow_tpu_torch.net.rings import gather_hs, set_col
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


# ---------------------------------------------------------------------
# shared-relay (multiplexed) model
# ---------------------------------------------------------------------
# Real Tor-in-Shadow relays carry many circuits over many sockets per
# host (the reference's server-child socket multiplexing,
# tcp.c:91-113,260-321, exists for exactly this). The multiplexed
# model gives every host C circuit slots: slot arrays are [H, C], a
# relay stream-forwards each slot's upstream child onto that slot's
# downstream connection, and accepted children are matched to slots by
# the circuit's expected previous-hop IP (first free slot among those
# with the same previous hop; all circuits carry equal bytes, so any
# permutation within a group delivers identical totals).


@dataclass
class RelayMuxApp(_Replace):
    """Multiplexed relay state: [H, C] per-circuit-slot columns plus
    [H] host-level fields."""

    lsock: torch.Tensor        # [H] i64 listener (-1 none)
    nslots: torch.Tensor       # [H] i32 live circuit slots this host
    s_role: torch.Tensor       # [H,C] i32 slot role at this host
    up_conn: torch.Tensor      # [H,C] i32 accepted upstream child (-1)
    exp_prev_ip: torch.Tensor  # [H,C] i64 expected prev-hop ip (0 none)
    down_sock: torch.Tensor    # [H,C] i32 downstream connection (-1)
    next_ip: torch.Tensor      # [H,C] i64 downstream hop ip (0 none)
    connected: torch.Tensor    # [H,C] bool downstream connect issued
    to_send: torch.Tensor      # [H,C] i32 client payload left to submit
    fwd_pending: torch.Tensor  # [H,C] i32 relay bytes read, unsent
    up_eof: torch.Tensor       # [H,C] bool upstream finished
    closed_down: torch.Tensor  # [H,C] bool downstream closed
    rcvd: torch.Tensor         # [H,C] i64 server bytes received
    done_at: torch.Tensor      # [H,C] i64 server EOF time (-1)


def setup_shared(sim, *, circuits: list[list[int]], total_bytes: int,
                 max_slots: int):
    """circuits: host-index chains [client, r1, ..., server] that may
    share relay and server hosts (a host may appear in many circuits,
    in different positions). Each host gets one slot per appearance;
    `max_slots` bounds C (sockets_per_host must be >= 1 + 2*C). The
    tables are built in numpy, as the reference builds them."""
    H = sim.net.host_ip.shape[0]
    dev = sim.net.host_ip.device
    host_ips = sim.net.host_ip.cpu().numpy()
    C = max_slots
    s_role = np.zeros((H, C), np.int32)
    exp_prev = np.zeros((H, C), np.int64)
    next_ip = np.zeros((H, C), np.int64)
    to_send = np.zeros((H, C), np.int32)
    nslots = np.zeros(H, np.int32)

    def add_slot(h, role, prev_h, next_h):
        c = nslots[h]
        if c >= C:
            raise ValueError(
                f"host {h} exceeds max_slots={C}; raise max_slots")
        s_role[h, c] = role
        if prev_h is not None:
            exp_prev[h, c] = host_ips[prev_h]
        if next_h is not None:
            next_ip[h, c] = host_ips[next_h]
        if role == ROLE_CLIENT:
            to_send[h, c] = total_bytes
        nslots[h] = c + 1

    for chain in circuits:
        add_slot(chain[0], ROLE_CLIENT, None, chain[1])
        for i, r in enumerate(chain[1:-1], start=1):
            add_slot(r, ROLE_RELAY, chain[i - 1], chain[i + 1])
        add_slot(chain[-1], ROLE_SERVER, chain[-2], None)

    def t(a):
        return torch.as_tensor(a, device=dev)

    is_listener = t(np.any(
        (s_role == ROLE_RELAY) | (s_role == ROLE_SERVER), axis=1))
    net, lsock = sk_create(sim.net, is_listener, SocketType.TCP)
    net, _ = sk_bind(net, is_listener, lsock, 0, PORT)
    sim = tcp.tcp_listen(sim.replace(net=net), is_listener, lsock)
    down = np.full((H, C), -1, np.int32)
    for c in range(C):
        has_down = next_ip[:, c] != 0
        net, d = sk_create(sim.net, t(has_down), SocketType.TCP)
        sim = sim.replace(net=net)
        down[:, c] = np.where(has_down, d.cpu().numpy(), -1)

    app = RelayMuxApp(
        lsock=torch.where(is_listener, lsock, -1),
        nslots=t(nslots),
        s_role=t(s_role),
        up_conn=torch.full((H, C), -1, dtype=I32, device=dev),
        exp_prev_ip=t(exp_prev),
        down_sock=t(down),
        next_ip=t(next_ip),
        connected=torch.zeros((H, C), dtype=torch.bool, device=dev),
        to_send=t(to_send),
        fwd_pending=torch.zeros((H, C), dtype=I32, device=dev),
        up_eof=torch.zeros((H, C), dtype=torch.bool, device=dev),
        closed_down=torch.zeros((H, C), dtype=torch.bool, device=dev),
        rcvd=torch.zeros((H, C), dtype=I64, device=dev),
        done_at=torch.full((H, C), -1, dtype=I64, device=dev),
    )
    return sim.replace(app=app)


def _mux_cols(app):
    return app.s_role.shape[1]


_START_KINDS = census_mask((EventKind.PROC_START,))


def mux_handler(cfg: NetConfig, sim, popped, buf, kinds=None):
    """Serial per-micro-step handler for the multiplexed model: the
    disjoint handler's phases, per circuit slot. The reference's two
    lax.fori_loops over the C slots are Python loops here; each slot's
    phases see the state the previous slot left.

    Gates, each value-identical because a TCP call whose mask is all
    false changes nothing: the connects run only when `kinds` (the
    engine's bitmask of the popped kinds; None = unknown) holds
    PROC_START; after the accept, one host read takes, per slot, the
    any() of a superset of the client phases' masks (feed, close), of
    the drain's mask (which the server's close is a subset of) and of
    the relay phases' masks (forward, two closes), and a slot phase
    whose superset is empty is skipped. Slot c's columns are written
    only in its own iteration, so the supersets taken before the loop
    hold through it."""
    now = popped.time
    woke = popped.valid
    H = woke.shape[0]
    dev = woke.device
    C = _mux_cols(sim.app)
    port = torch.full((H,), PORT, dtype=I32, device=dev)

    # ---- connect downstreams at PROC_START ---------------------------
    if kinds is None or kinds & _START_KINDS:
        for c in range(C):
            app = sim.app
            start = woke & (popped.kind == EventKind.PROC_START) \
                & (app.down_sock[:, c] >= 0) & ~app.connected[:, c]
            sim, buf = tcp.tcp_connect(cfg, sim, start, app.down_sock[:, c],
                                       app.next_ip[:, c], port, now, buf)
            app = sim.app
            sim = sim.replace(app=app.replace(connected=set_col(
                app.connected, c, app.connected[:, c] | start)))

    # ---- accept one upstream child, match it to a slot ---------------
    app = sim.app
    lready = (gather_hs(sim.net.sk_flags, app.lsock)
              & SocketFlags.READABLE) != 0
    any_free = ((app.s_role != ROLE_CLIENT) & (app.s_role != ROLE_NONE)
                & (app.up_conn < 0)).any(dim=1)
    acc = woke & (app.lsock >= 0) & any_free & lready
    sim, got, child = tcp.tcp_accept(sim, acc, app.lsock)
    app = sim.app
    peer = gather_hs(sim.net.sk_peer_ip, child.clamp(min=0))
    # first free slot whose expected prev-hop matches the child's peer
    cand = (app.up_conn < 0) & (app.exp_prev_ip == peer[:, None]) \
        & ((app.s_role == ROLE_RELAY) | (app.s_role == ROLE_SERVER))
    pick = cand.to(torch.uint8).argmax(dim=1)
    matched = got & cand.any(dim=1)
    sel = matched[:, None] & (torch.arange(C, device=dev)[None, :]
                              == pick[:, None])
    app = app.replace(up_conn=torch.where(sel, child[:, None], app.up_conn))
    sim = sim.replace(app=app)

    # ---- per-slot phases ---------------------------------------------
    w = woke[:, None]
    drain_all = w & (app.up_conn >= 0) & ~app.up_eof
    gates = torch.stack([
        (w & (app.s_role == ROLE_CLIENT) & app.connected).any(dim=0),
        drain_all.any(dim=0),
        (w & (app.s_role == ROLE_RELAY)
         & (((app.fwd_pending > 0) & app.connected) | drain_all
            | (app.up_eof & ~app.closed_down))).any(dim=0),
    ]).tolist()
    chunk = torch.full((H,), CHUNK, dtype=I32, device=dev)
    for c in range(C):
        g_client, g_drain, g_relay = (g[c] for g in gates)
        app = sim.app
        role = app.s_role[:, c]
        up = app.up_conn[:, c]
        down = app.down_sock[:, c]
        if g_client:
            # client: feed the stream
            feeding = woke & (role == ROLE_CLIENT) & app.connected[:, c] \
                & (app.to_send[:, c] > 0)
            sim, buf, accepted = tcp.tcp_send(
                cfg, sim, feeding, down, app.to_send[:, c].clamp(max=CHUNK),
                now, buf)
            app = sim.app
            app = app.replace(to_send=set_col(
                app.to_send, c, app.to_send[:, c] - accepted))
            sim = sim.replace(app=app)
            fin_client = woke & (role == ROLE_CLIENT) \
                & app.connected[:, c] & (app.to_send[:, c] == 0) \
                & ~app.closed_down[:, c]
            sim, buf = tcp.tcp_close(cfg, sim, fin_client, down, now, buf)
            app = sim.app
            sim = sim.replace(app=app.replace(closed_down=set_col(
                app.closed_down, c, app.closed_down[:, c] | fin_client)))

        if g_drain:
            # relay/server: drain upstream
            app = sim.app
            drain = woke & (up >= 0) & ~app.up_eof[:, c]
            sim, buf, nread, eof = tcp.tcp_recv(sim, drain, up, chunk, now,
                                                buf)
            app = sim.app
            is_srv = role == ROLE_SERVER
            app = app.replace(
                fwd_pending=set_col(
                    app.fwd_pending, c, app.fwd_pending[:, c]
                    + torch.where(is_srv, 0, nread).to(I32)),
                rcvd=set_col(app.rcvd, c, app.rcvd[:, c]
                              + torch.where(is_srv, nread, 0).to(I64)),
                up_eof=set_col(app.up_eof, c, app.up_eof[:, c] | eof),
                done_at=set_col(app.done_at, c, torch.where(
                    eof & is_srv & (app.done_at[:, c] < 0), now,
                    app.done_at[:, c])),
            )
            sim = sim.replace(app=app)
            sim, buf = tcp.tcp_close(cfg, sim, eof & is_srv, up, now, buf)

        if g_relay:
            # relay: forward downstream
            app = sim.app
            fwd = woke & (role == ROLE_RELAY) & (app.fwd_pending[:, c] > 0) \
                & app.connected[:, c]
            sim, buf, fsent = tcp.tcp_send(cfg, sim, fwd, down,
                                           app.fwd_pending[:, c], now, buf)
            app = sim.app
            app = app.replace(fwd_pending=set_col(
                app.fwd_pending, c, app.fwd_pending[:, c] - fsent))
            sim = sim.replace(app=app)
            relay_fin = woke & (role == ROLE_RELAY) & app.up_eof[:, c] \
                & (app.fwd_pending[:, c] == 0) & ~app.closed_down[:, c]
            sim, buf = tcp.tcp_close(cfg, sim, relay_fin, down, now, buf)
            app = sim.app
            sim = sim.replace(app=app.replace(closed_down=set_col(
                app.closed_down, c, app.closed_down[:, c] | relay_fin)))
            sim, buf = tcp.tcp_close(cfg, sim, relay_fin, up, now, buf)
    return sim, buf


class RelayMuxTcpBulk:
    """TcpAppBulk contract for the multiplexed model: the same
    steady-state semantics per circuit slot; the delivered socket is
    located across the [H, C] slot axis. No app tensor is written in
    place (the pass reverts by object identity)."""

    def precheck(self, cfg, sim):
        app = sim.app
        live = app.s_role != ROLE_NONE
        client = app.s_role == ROLE_CLIENT
        rel = app.s_role == ROLE_RELAY
        listener = rel | (app.s_role == ROLE_SERVER)
        ok2 = torch.where(live & listener, app.up_conn >= 0, True)
        ok2 = ok2 & torch.where(live & client,
                                (app.to_send == 0) & app.closed_down, True)
        ok2 = ok2 & (app.fwd_pending == 0)
        ok2 = ok2 & torch.where(live & (rel | client), app.connected, True)
        S = sim.tcp.st.shape[1]
        up = app.up_conn.clamp(0, S - 1).to(I64)
        rows = torch.arange(up.shape[0], device=up.device)[:, None]
        up_st = sim.tcp.st[rows, up]
        up_done = (up_st != tcp.TcpSt.ESTABLISHED) \
            & (up_st != tcp.TcpSt.CLOSE_WAIT)
        ok2 = ok2 & torch.where(
            live & app.up_eof, torch.where(rel, app.closed_down, up_done),
            True)
        return ok2.all(dim=1)

    @staticmethod
    def _locate(app, slot):
        """(hit [H,C], any hit [H], rows, first hit column [H])."""
        hit = app.up_conn == slot[:, None]
        rows = torch.arange(hit.shape[0], device=hit.device)
        return hit, hit.any(dim=1), rows, hit.to(torch.uint8).argmax(dim=1)

    def on_data(self, cfg, app, mask, slot, nread, now):
        hit, any_hit, rows, pick = self._locate(app, slot)
        ok = ~mask | (any_hit & (nread <= CHUNK))
        m = mask & any_hit
        C = _mux_cols(app)
        sel = m[:, None] & (torch.arange(C, device=m.device)[None, :]
                            == pick[:, None])
        role_c = app.s_role[rows, pick]
        server = m & (role_c == ROLE_SERVER)
        rel = m & (role_c == ROLE_RELAY)
        app = app.replace(rcvd=torch.where(
            sel & server[:, None], app.rcvd + nread[:, None].to(I64),
            app.rcvd))
        fwd_slot = app.down_sock[rows, pick]
        return app, ok, rel, fwd_slot, torch.where(rel, nread, 0)

    def on_eof(self, cfg, app, mask, slot, now):
        hit, any_hit, rows, pick = self._locate(app, slot)
        C = _mux_cols(app)
        sel_c = torch.arange(C, device=mask.device)[None, :] == pick[:, None]
        m = mask & any_hit & ~app.up_eof[rows, pick]
        role_c = app.s_role[rows, pick]
        server = m & (role_c == ROLE_SERVER)
        rel = m & (role_c == ROLE_RELAY)
        # a relay with unforwarded bytes would defer its closes to a
        # later wake — out of model
        ok = ~(rel & ((app.fwd_pending[rows, pick] > 0)
                      | ~app.connected[rows, pick]
                      | app.closed_down[rows, pick]))
        sel = m[:, None] & sel_c
        app = app.replace(
            up_eof=app.up_eof | sel,
            done_at=torch.where(sel & server[:, None] & (app.done_at < 0),
                                now[:, None], app.done_at),
        )
        c1_mask = server | rel
        c1_slot = torch.where(server, slot, app.down_sock[rows, pick])
        app = app.replace(closed_down=app.closed_down
                          | (sel & rel[:, None]))
        return app, ok, c1_mask & ok, c1_slot, rel & ok, slot


MUX_TCP_BULK = RelayMuxTcpBulk()


def consensus_circuits(rng, n_circuits: int, clients, relays, servers,
                       hops: int = 3, max_slots: int = 8):
    """Sample circuit chains the way Tor clients build paths (a copy of
    the reference's numpy draw: the same chains from the same
    np.random.Generator state). Relays are drawn by consensus weight
    (Zipf-ish: weight is capacity in the consensus, so heavy relays
    legitimately carry many circuits), distinct within one circuit,
    shared across circuits up to each host's `max_slots` capacity
    (rejection keeps the draw feasible while preserving the skew).
    Returns host-index chains [client, r1..r_hops, server]."""
    relays = list(relays)
    w = np.asarray([1.0 / (i + 1) ** 0.5 for i in range(len(relays))])
    w = w / w.sum()
    used: dict[int, int] = {}
    chains = []
    clients = list(clients)
    servers = list(servers)
    # weighted draws come in vectorized batches: one rng.choice call
    # per 64k picks instead of one O(len(relays)) call per pick
    batch: list[int] = []

    def draw_relay() -> int:
        if not batch:
            batch.extend(
                rng.choice(len(relays), size=65536, p=w).tolist())
        return relays[batch.pop()]

    for k in range(n_circuits):
        cl = clients[k % len(clients)]
        sv = None
        for _ in range(64):
            cand_sv = servers[int(rng.integers(len(servers)))]
            if used.get(cand_sv, 0) < max_slots:
                sv = cand_sv
                break
        if sv is None:
            break  # server capacity exhausted: fewer circuits
        rs: list[int] = []
        tries = 0
        while len(rs) < hops and tries < 256:
            tries += 1
            r = draw_relay()
            if r not in rs and used.get(r, 0) + 1 <= max_slots:
                rs.append(r)
        if len(rs) < hops:
            break  # relay capacity exhausted
        for h in rs:
            used[h] = used.get(h, 0) + 1
        used[sv] = used.get(sv, 0) + 1
        chains.append([cl] + rs + [sv])
    return chains
