"""Bitcoin-gossip-shaped application model (PyTorch port of
shadow_tpu/apps/gossip.py; BASELINE.json config #4, "5k-node
Bitcoin"): block flooding over a static random peer graph with dedup,
as an on-device state machine — over UDP datagrams (setup, handler)
or over persistent TCP peer connections (setup_tcp, tcp_handler).

UDP protocol: block b is mined by host (b * miner_stride) % H at time
b * block_interval and pushed to the miner's K peers, one datagram per
micro-step, whose payref word carries the block id (synthetic payloads
reuse it as an opaque app tag). A host seeing a block id above its tip
relays it to all K peers once (inv/getdata collapse into a direct
push; blocks arrive in mining order on every path, so the tip counter
subsumes a seen-set).

Metrics: the tip per host, duplicate receptions, relays sent.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from shadow_tpu_torch.core import simtime
from shadow_tpu_torch.core.events import (
    EventKind, _Replace, census_mask, emit, emit_words, push_rows)
from shadow_tpu_torch.net import nic, tcp, udp
from shadow_tpu_torch.net.rings import gather_hs, set_col
from shadow_tpu_torch.net.sockets import sk_bind, sk_create
from shadow_tpu_torch.net.state import (
    NetConfig, SocketFlags, SocketType, ip_of_hosts)

I32 = torch.int32
I64 = torch.int64

KIND_MINE = EventKind.USER + 1
KIND_RELAY = EventKind.USER + 2  # self-chained per-peer block push
BLOCK_BYTES = 20_000             # fits one datagram (< 65507)
PORT = 8333

_MINE_KINDS = census_mask((KIND_MINE,))
_RELAY_KINDS = census_mask((KIND_RELAY,))
_RECV_KINDS = census_mask((EventKind.PACKET, EventKind.NIC_RECV,
                           EventKind.PACKET_LOCAL))
_START_KINDS = census_mask((EventKind.PROC_START,))


def _has(kinds, mask) -> bool:
    """Whether a phase gated on `mask` may run (kinds None = unknown)."""
    return kinds is None or bool(kinds & mask)


@dataclass
class GossipApp(_Replace):
    peers: torch.Tensor         # [H, K] i32 static peer graph (undirected)
    sock: torch.Tensor          # [H] i64
    tip: torch.Tensor           # [H] i32 highest block id seen (-1 none)
    relay_block: torch.Tensor   # [H] i32 block id being relayed (-1 idle)
    relay_next: torch.Tensor    # [H] i32 next peer index to push to
    next_block: torch.Tensor    # [H] i32 next block id this host mines
    blocks_mined: torch.Tensor  # [H] i64
    dup_rx: torch.Tensor        # [H] i64 duplicate receptions
    relays: torch.Tensor        # [H] i64 datagrams pushed
    block_interval: torch.Tensor  # [] i64 ns between blocks (global)
    max_blocks: torch.Tensor    # [] i32
    mine_stride: torch.Tensor   # [] i32 block-id stride per mining slot
                                # (hosts sharing the chain: H, or the
                                # replica size in ensemble mode)


def make_peer_graph(num_hosts: int, k: int, seed: int) -> np.ndarray:
    """Static undirected k-regular-ish random peer graph (a copy of the
    reference's numpy draw): each host gets >= k peers; the union of k
    out-choices symmetrized, then truncated back to K columns; the ring
    base guarantees connectivity."""
    rng = np.random.default_rng(seed)
    peers = [[((i + 1) % num_hosts), ((i - 1) % num_hosts)]
             for i in range(num_hosts)]  # ring base: connected
    for i in range(num_hosts):
        for p in rng.choice(num_hosts, size=k, replace=False):
            p = int(p)
            if p != i and p not in peers[i] and len(peers[i]) < k:
                peers[i].append(p)
                if i not in peers[p] and len(peers[p]) < k:
                    peers[p].append(i)
    out = np.full((num_hosts, k), -1, np.int32)
    for i, ps in enumerate(peers):
        out[i, :len(ps[:k])] = ps[:k]
    return out


def _seed_mine_events(sim, have: np.ndarray, t: np.ndarray):
    """Push each `have` host's first MINE event at time `t` (the
    reference's push_rows with seq 0, then next_seq += 1)."""
    H = have.shape[0]
    dev = sim.net.host_ip.device
    m = torch.as_tensor(have, device=dev)
    q = push_rows(
        sim.events, m, torch.as_tensor(t.astype(np.int64), device=dev),
        torch.full((H,), KIND_MINE, dtype=I32, device=dev),
        torch.arange(H, dtype=I32, device=dev),
        torch.zeros((H,), dtype=I32, device=dev),
        emit_words(0, num_hosts=H, device=dev))
    q = q.replace(next_seq=q.next_seq + m.to(I32))
    return sim.replace(events=q)


def setup(sim, *, peers_per_host: int = 8,
          block_interval=10 * simtime.ONE_SECOND, max_blocks: int = 100,
          miner_stride: int = 1, graph_seed: int = 42,
          replica_size: int | None = None):
    """Bind sockets, build the peer graph, seed each host's first MINE
    event. Block b is mined by host (b * miner_stride) % H.

    `replica_size` partitions hosts into independent replicas: each
    gets its own peer graph (block-diagonal, seeded graph_seed + r)
    and mines its own chain 0..max_blocks."""
    H = sim.net.host_ip.shape[0]
    dev = sim.net.host_ip.device
    rs = H if replica_size is None else replica_size
    if rs < 3 or H % rs != 0:
        raise ValueError(f"replica_size={rs} must divide H={H}, be >= 3")
    if peers_per_host >= rs:
        raise ValueError(
            f"peers_per_host={peers_per_host} must be < the peer-graph "
            f"size {rs} (each host needs that many distinct non-self "
            f"peers)")
    R = H // rs
    every = torch.ones((H,), dtype=torch.bool, device=dev)
    net, sock = sk_create(sim.net, every, SocketType.UDP)
    net, _ = sk_bind(net, every, sock, 0, PORT)
    sim = sim.replace(net=net)

    if R == 1:
        peers = make_peer_graph(H, peers_per_host, graph_seed)
    else:
        def block(r):
            g = make_peer_graph(rs, peers_per_host, graph_seed + r)
            return np.where(g < 0, -1, g + r * rs)  # keep -1 padding
        peers = np.concatenate([block(r) for r in range(R)], axis=0)
    # first block id mined by host h (within its replica): smallest
    # b >= 0 with (b * stride) % rs == local index
    first = np.full(H, -1, np.int64)
    for r in range(R):
        for b in range(rs):
            m = r * rs + (b * miner_stride) % rs
            if first[m] < 0:
                first[m] = b

    def scalar(v, dtype):
        return torch.tensor(int(v), dtype=dtype, device=dev)

    app = GossipApp(
        peers=torch.as_tensor(peers, device=dev),
        sock=sock,
        tip=torch.full((H,), -1, dtype=I32, device=dev),
        relay_block=torch.full((H,), -1, dtype=I32, device=dev),
        relay_next=torch.zeros((H,), dtype=I32, device=dev),
        next_block=torch.as_tensor(first.astype(np.int32), device=dev),
        blocks_mined=torch.zeros((H,), dtype=I64, device=dev),
        dup_rx=torch.zeros((H,), dtype=I64, device=dev),
        relays=torch.zeros((H,), dtype=I64, device=dev),
        block_interval=scalar(block_interval, I64),
        max_blocks=scalar(max_blocks, I32),
        mine_stride=scalar(rs, I32),
    )
    sim = sim.replace(app=app)
    # seed each miner's first MINE event
    return _seed_mine_events(sim, first >= 0,
                             np.maximum(first, 0) * int(block_interval))


def _start_relay(app, mask, block):
    """Begin pushing `block` to all peers (one datagram per micro-step
    via the KIND_RELAY self-chain)."""
    return app.replace(
        relay_block=torch.where(mask, block, app.relay_block),
        relay_next=torch.where(mask, 0, app.relay_next),
    )


def _words(H, device):
    return emit_words(0, num_hosts=H, device=device)


def _relay_step(cfg, sim, buf, mask, now):
    """Push the current block to the next peer; chain until done."""
    app = sim.app
    H, K = app.peers.shape
    dev = mask.device
    lane = torch.arange(H, device=dev)
    idx = app.relay_next.clamp(0, K - 1).to(I64)
    peer = app.peers[lane, idx]
    active = mask & (app.relay_block >= 0) & (app.relay_next < K) \
        & (peer >= 0)
    dst_ip = ip_of_hosts(cfg, sim.net, peer)
    net, ok = udp.udp_enqueue_send(
        sim.net, active, app.sock, dst_ip,
        torch.full((H,), PORT, dtype=I32, device=dev), BLOCK_BYTES,
        app.relay_block)
    app = app.replace(
        relay_next=app.relay_next + active.to(I32),
        relays=app.relays + ok.to(I64),
    )
    sim = sim.replace(net=net, app=app)
    sim, buf = nic.notify_wants_send(sim, buf, ok, now)
    # chain to the next peer (or stop)
    more = active & (app.relay_next < K)
    nxt_peer = app.peers[lane, app.relay_next.clamp(0, K - 1).to(I64)]
    more = more & (nxt_peer >= 0)
    buf = emit(buf, more, sim.net.lane_id, now, KIND_RELAY, _words(H, dev))
    done = mask & ~more
    app = sim.app.replace(
        relay_block=torch.where(done, -1, sim.app.relay_block))
    return sim.replace(app=app), buf


def handler(cfg: NetConfig, sim, popped, buf, kinds=None):
    """`kinds` (the engine's bitmask of the kinds popped this
    micro-step; None = unknown) skips a phase whose kinds are absent —
    its masks would be all false, so it would change nothing."""
    app = sim.app
    now = popped.time
    H = app.sock.shape[0]
    dev = now.device

    # ---- mine a block ------------------------------------------------
    if _has(kinds, _MINE_KINDS):
        due = popped.valid & (popped.kind == KIND_MINE) \
            & (app.next_block >= 0) & (app.next_block < app.max_blocks)
        mine = due & (app.relay_block < 0)
        # busy relaying? retry shortly (rare: block interval >> relay
        # time)
        busy = due & (app.relay_block >= 0)
        buf = emit(buf, busy, sim.net.lane_id,
                   now + simtime.ONE_MILLISECOND, KIND_MINE, _words(H, dev))
        new_tip = torch.maximum(app.tip, app.next_block)
        app = app.replace(
            tip=torch.where(mine, new_tip, app.tip),
            blocks_mined=app.blocks_mined + mine.to(I64),
        )
        app = _start_relay(app, mine, app.next_block)
        # kick the relay chain for the freshly mined block
        buf = emit(buf, mine, sim.net.lane_id, now, KIND_RELAY,
                   _words(H, dev))
        # schedule this host's next mining slot (stride: the number of
        # hosts sharing the chain — H, or the replica size)
        nxt = app.next_block + app.mine_stride
        mine_t = nxt.to(I64) * app.block_interval
        sched = mine & (nxt < app.max_blocks)
        buf = emit(buf, sched, sim.net.lane_id, mine_t, KIND_MINE,
                   _words(H, dev))
        app = app.replace(next_block=torch.where(mine, nxt, app.next_block))
        sim = sim.replace(app=app)

    # ---- receive blocks ----------------------------------------------
    if _has(kinds, _RECV_KINDS):
        may_have = popped.valid & (
            (popped.kind == EventKind.PACKET)      # fused same-step delivery
            | (popped.kind == EventKind.NIC_RECV)  # deferred drain
            | (popped.kind == EventKind.PACKET_LOCAL))
        readable = gather_hs(sim.net.in_count, sim.app.sock) > 0
        net, got, _, _, _, block = udp.udp_recv(
            sim.net, may_have & readable, sim.app.sock)
        sim = sim.replace(net=net)
        app = sim.app
        fresh = got & (block > app.tip) & (app.relay_block < 0)
        stale = got & (block <= app.tip)
        # a fresh block while still relaying the previous one: adopt
        # the tip but skip re-relaying (bounded state; peers also hear
        # it from the origin's other neighbors)
        adopt = got & (block > app.tip)
        app = app.replace(
            tip=torch.where(adopt, block, app.tip),
            dup_rx=app.dup_rx + stale.to(I64),
        )
        app = _start_relay(app, fresh, block)
        sim = sim.replace(app=app)
        buf = emit(buf, fresh, sim.net.lane_id, now, KIND_RELAY,
                   _words(H, dev))

    # ---- relay chain -------------------------------------------------
    if _has(kinds, _RELAY_KINDS):
        relay = popped.valid & (popped.kind == KIND_RELAY)
        sim, buf = _relay_step(cfg, sim, buf, relay, now)
    return sim, buf


# ---------------------------------------------------------------------
# TCP gossip: block flooding over persistent TCP peer connections — the
# Bitcoin shape config #4 names (bitcoind's inv/getdata/block ride
# long-lived TCP links, not datagrams).
# ---------------------------------------------------------------------
#
# Topology: one TCP connection per undirected peer edge, initiated by
# the lower-id endpoint at PROC_START and matched to its peer slot on
# accept by source IP. Blocks ride the byte stream (BLOCK_BYTES per
# block, in adoption order — a host only relays ids above its tip, so
# each edge's id sequence is strictly increasing). Block ids travel in
# a per-edge SPSC sideband: the sender appends ids to its own [H, K, F]
# ring (it owns the write cursor), the receiver gathers the peer's
# ring and advances its own read cursor — no cross-row writes. The
# cross-row reads index the peer's row by its global host id, as the
# reference does; where that id lies past the rows of the (compacted)
# view, the index is clamped to the last row, as a JAX gather clamps.

FIFO = 16                    # ids in flight per edge
TCPPORT = 8334


@dataclass
class GossipTcpApp(_Replace):
    peers: torch.Tensor        # [H, K] i32 peer graph
    peer_back: torch.Tensor    # [H, K] i32 my slot index in peer's table
    lsock: torch.Tensor        # [H] i64 listener
    conn: torch.Tensor         # [H, K] i32 edge socket (-1 none yet)
    est: torch.Tensor          # [H, K] bool edge usable (send side)
    tip: torch.Tensor          # [H] i32 highest block id seen
    next_block: torch.Tensor   # [H] i32 next id this host mines (-1)
    relay_block: torch.Tensor  # [H] i32 id being relayed (-1 idle)
    relay_next: torch.Tensor   # [H] i32 next peer slot to push to
    send_left: torch.Tensor    # [H, K] i32 bytes of current push unsent
    fifo: torch.Tensor         # [H, K, F] i32 ids I sent on this edge
    wr: torch.Tensor           # [H, K] i32 my append cursor
    rd: torch.Tensor           # [H, K] i32 my read cursor into the
                               # peer's ring for the reverse direction
    rx_acc: torch.Tensor       # [H, K] i32 bytes toward the next block
    blocks_mined: torch.Tensor  # [H] i64
    dup_rx: torch.Tensor       # [H] i64
    relays: torch.Tensor       # [H] i64 blocks pushed
    stalls: torch.Tensor       # [H] i64 pushes skipped (edge backlog)
    block_interval: torch.Tensor  # [] i64
    max_blocks: torch.Tensor   # [] i32
    mine_stride: torch.Tensor  # [] i32
    mine_offset: torch.Tensor  # [] i64 warmup before block 0 (the TCP
                               # mesh needs PROC_START + handshakes first)


def setup_tcp(sim, *, peers_per_host: int = 8,
              block_interval=10 * simtime.ONE_SECOND,
              max_blocks: int = 100, graph_seed: int = 42):
    """Build the peer graph, bind listeners, create the lower-id
    endpoint's connect socket per edge, seed MINE events."""
    H = sim.net.host_ip.shape[0]
    dev = sim.net.host_ip.device
    peers = make_peer_graph(H, peers_per_host, graph_seed)
    K = peers.shape[1]
    # the TCP model needs symmetric edges (one connection per edge,
    # sideband cursors addressed via the reverse slot): drop directed
    # edges the peer does not reciprocate
    back = np.full((H, K), -1, np.int32)
    for h in range(H):
        for k in range(K):
            p = peers[h, k]
            if p >= 0:
                w = np.where(peers[p] == h)[0]
                if w.size:
                    back[h, k] = w[0]
                else:
                    peers[h, k] = -1
    every = torch.ones((H,), dtype=torch.bool, device=dev)
    net, lsock = sk_create(sim.net, every, SocketType.TCP)
    net, _ = sk_bind(net, every, lsock, 0, TCPPORT)
    sim = tcp.tcp_listen(sim.replace(net=net), every, lsock)
    conn = np.full((H, K), -1, np.int32)
    for k in range(K):
        initiate = (peers[:, k] >= 0) & (peers[:, k] > np.arange(H))
        net, fd = sk_create(sim.net, torch.as_tensor(initiate, device=dev),
                            SocketType.TCP)
        sim = sim.replace(net=net)
        conn[:, k] = np.where(initiate, fd.cpu().numpy(), -1)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def scalar(v, dtype):
        return torch.tensor(int(v), dtype=dtype, device=dev)

    # host h mines block h (the miner_stride=1 schedule); only ids
    # below max_blocks ever fire, so only those seeds are pushed
    first = np.arange(H, dtype=np.int64)
    app = GossipTcpApp(
        peers=torch.as_tensor(peers, device=dev),
        peer_back=torch.as_tensor(back, device=dev),
        lsock=lsock, conn=torch.as_tensor(conn, device=dev),
        est=zeros((H, K), torch.bool),
        tip=torch.full((H,), -1, dtype=I32, device=dev),
        next_block=torch.as_tensor(first.astype(np.int32), device=dev),
        relay_block=torch.full((H,), -1, dtype=I32, device=dev),
        relay_next=zeros((H,), I32),
        send_left=zeros((H, K), I32),
        fifo=torch.full((H, K, FIFO), -1, dtype=I32, device=dev),
        wr=zeros((H, K), I32), rd=zeros((H, K), I32),
        rx_acc=zeros((H, K), I32),
        blocks_mined=zeros((H,), I64),
        dup_rx=zeros((H,), I64),
        relays=zeros((H,), I64),
        stalls=zeros((H,), I64),
        block_interval=scalar(block_interval, I64),
        max_blocks=scalar(max_blocks, I32),
        mine_stride=scalar(H, I32),
        mine_offset=scalar(2 * simtime.ONE_SECOND, I64),
    )
    sim = sim.replace(app=app)
    return _seed_mine_events(
        sim, first < max_blocks,
        first * int(block_interval) + 2 * simtime.ONE_SECOND)


def _set_at(arr, rows, idx, value):
    """arr with arr[rows, idx] = value (distinct rows), as a new tensor:
    the reference's .at[rows, idx].set(value)."""
    out = arr.clone()
    out[rows, idx] = value.to(arr.dtype)
    return out


def _peer_row(pk, arr):
    """Row index `pk` of a cross-row read, clamped to `arr`'s rows as a
    JAX gather clamps an out-of-range index."""
    return pk.clamp(max=arr.shape[0] - 1).to(I64)


def tcp_handler(cfg: NetConfig, sim, popped, buf, kinds=None):
    """Serial per-micro-step handler of TCP gossip. The reference's two
    lax.fori_loops over the K peer slots are Python loops here.

    Gates, each value-identical because a TCP call whose mask is all
    false changes nothing: the connects run only when `kinds` (the
    engine's bitmask of the popped kinds; None = unknown) holds
    PROC_START, the mining only when it holds KIND_MINE, the relay push
    only when it holds KIND_RELAY; before the per-edge loop one host
    read takes, per edge, the any() of the pump's mask and of the lanes
    a receive can change (the live ones, and those whose byte count
    already holds a block; edge k's columns are written only in its
    own iteration, so both hold through the loop), and an edge phase
    with none is skipped."""
    now = popped.time
    woke = popped.valid
    app = sim.app
    H, K = app.peers.shape
    dev = woke.device
    rows = torch.arange(H, device=dev)

    # ---- connect the lower-id end of each edge at PROC_START ---------
    if _has(kinds, _START_KINDS):
        port = torch.full((H,), TCPPORT, dtype=I32, device=dev)
        for k in range(K):
            app = sim.app
            fd = app.conn[:, k]
            start = woke & (popped.kind == EventKind.PROC_START) & (fd >= 0)
            peer_ip = ip_of_hosts(cfg, sim.net, app.peers[:, k].clamp(min=0))
            sim, buf = tcp.tcp_connect(cfg, sim, start, fd, peer_ip, port,
                                       now, buf)
            app = sim.app
            sim = sim.replace(app=app.replace(
                est=set_col(app.est, k, app.est[:, k] | start)))

    # ---- accept: match the child to its peer slot by source ip -------
    app = sim.app
    lready = (gather_hs(sim.net.sk_flags, app.lsock)
              & SocketFlags.READABLE) != 0
    sim, got, child = tcp.tcp_accept(sim, woke & lready, app.lsock)
    app = sim.app
    peer_ip = gather_hs(sim.net.sk_peer_ip, child.clamp(min=0))
    ips = sim.net.ip_sorted
    pos = torch.searchsorted(ips, peer_ip.contiguous(), side="left") \
        .clamp(0, ips.shape[0] - 1)
    peer_host = sim.net.host_of_ip_sorted[pos]
    hit = (app.peers == peer_host[:, None]) & (app.conn < 0)
    pick = hit.to(torch.uint8).argmax(dim=1)
    matched = got & hit.any(dim=1)
    selk = matched[:, None] & (torch.arange(K, device=dev)[None, :]
                               == pick[:, None])
    sim = sim.replace(app=app.replace(
        conn=torch.where(selk, child[:, None], app.conn),
        est=app.est | selk))

    # ---- mine on schedule --------------------------------------------
    if _has(kinds, _MINE_KINDS):
        app = sim.app
        due = woke & (popped.kind == KIND_MINE) \
            & (app.next_block >= 0) & (app.next_block < app.max_blocks)
        mine = due & (app.relay_block < 0)
        busy = due & (app.relay_block >= 0)
        buf = emit(buf, busy, sim.net.lane_id,
                   now + simtime.ONE_MILLISECOND, KIND_MINE, _words(H, dev))
        app = app.replace(
            tip=torch.where(mine, torch.maximum(app.tip, app.next_block),
                            app.tip),
            blocks_mined=app.blocks_mined + mine.to(I64),
            relay_block=torch.where(mine, app.next_block, app.relay_block),
            relay_next=torch.where(mine, 0, app.relay_next),
        )
        buf = emit(buf, mine, sim.net.lane_id, now, KIND_RELAY,
                   _words(H, dev))
        nxt = app.next_block + app.mine_stride
        sched = mine & (nxt < app.max_blocks)
        buf = emit(buf, sched, sim.net.lane_id,
                   nxt.to(I64) * app.block_interval + app.mine_offset,
                   KIND_MINE, _words(H, dev))
        app = app.replace(next_block=torch.where(mine, nxt, app.next_block))
        sim = sim.replace(app=app)

    # ---- per-edge pump + receive -------------------------------------
    app = sim.app
    live_all = woke[:, None] & (app.conn >= 0)
    # a receive also frames a block on a lane that did not wake when
    # its byte count already holds one (its id was not yet published)
    gates = torch.stack([
        (live_all & (app.send_left > 0)).any(dim=0),
        (live_all | (app.rx_acc >= BLOCK_BYTES)).any(dim=0)]).tolist()
    block_bytes = torch.full((H,), BLOCK_BYTES, dtype=I32, device=dev)
    for k in range(K):
        g_pump, g_recv = gates[0][k], gates[1][k]
        app = sim.app
        fd = app.conn[:, k]
        live = woke & (fd >= 0)
        if g_pump:
            # pump: retry the unsent remainder of a partially-accepted
            # block push (the initial 16 KiB send buffer is smaller than
            # one 20 KB block; so is any backpressured edge's room)
            pending = live & (app.send_left[:, k] > 0)
            sim, buf, pumped = tcp.tcp_send(cfg, sim, pending, fd,
                                            app.send_left[:, k], now, buf)
            app = sim.app
            app = app.replace(send_left=set_col(
                app.send_left, k, app.send_left[:, k] - pumped.to(I32)))
            sim = sim.replace(app=app)
        if not g_recv:
            continue
        sim, buf, nread, _eof = tcp.tcp_recv(sim, live, fd, block_bytes,
                                             now, buf)
        app = sim.app
        acc = app.rx_acc[:, k] + nread.to(I32)
        done = acc >= BLOCK_BYTES          # one block per micro-step
        # the id rides the peer's sideband ring for this edge
        pk = app.peers[:, k].clamp(min=0)
        bk = app.peer_back[:, k].clamp(min=0).to(I64)
        rd = app.rd[:, k]
        bid = app.fifo[_peer_row(pk, app.fifo), bk, (rd % FIFO).to(I64)]
        take = done & (bid >= 0)
        fresh = take & (bid > app.tip)
        stale = take & ~fresh
        idle = app.relay_block < 0
        app = app.replace(
            rx_acc=set_col(app.rx_acc, k,
                            torch.where(take, acc - BLOCK_BYTES, acc)),
            rd=set_col(app.rd, k, rd + take.to(I32)),
            tip=torch.where(fresh, bid, app.tip),
            dup_rx=app.dup_rx + stale.to(I64),
            relay_block=torch.where(fresh & idle, bid, app.relay_block),
            relay_next=torch.where(fresh & idle, 0, app.relay_next),
        )
        sim = sim.replace(app=app)
        buf = emit(buf, fresh & idle, sim.net.lane_id, now, KIND_RELAY,
                   _words(H, dev))

    # ---- relay chain: push the current block, one edge per step ------
    if not _has(kinds, _RELAY_KINDS):
        return sim, buf
    relay = woke & (popped.kind == KIND_RELAY)
    app = sim.app
    idx = app.relay_next.clamp(0, K - 1).to(I64)
    fd = app.conn[rows, idx]
    est = app.est[rows, idx]
    # sideband room: my wr vs the peer's rd for this edge
    pk = app.peers[rows, idx].clamp(min=0)
    bk = app.peer_back[rows, idx].clamp(min=0).to(I64)
    peer_rd = app.rd[_peer_row(pk, app.rd), bk]
    active = relay & (app.relay_block >= 0) & (app.relay_next < K) \
        & (app.peers[rows, idx] >= 0)
    has_room = (app.wr[rows, idx] - peer_rd) < FIFO
    # one outstanding partial per edge: a still-pumping edge defers
    # this block (the per-edge pump drains send_left first)
    no_partial = app.send_left[rows, idx] == 0
    push = active & est & has_room & no_partial
    skip = active & ~(est & has_room & no_partial)
    sim, buf, accepted = tcp.tcp_send(cfg, sim, push, fd, block_bytes, now,
                                      buf)
    app = sim.app
    # a partial sndbuf accept leaves the remainder in send_left; the
    # per-edge pump retries it on every wake until the stream carries
    # the whole block (framing at the receiver needs every byte)
    sent = push
    app = app.replace(send_left=_set_at(
        app.send_left, rows, idx,
        torch.where(sent, BLOCK_BYTES - accepted.to(I32),
                    app.send_left[rows, idx])))
    wr = app.wr[rows, idx]
    sel = sent[:, None, None] \
        & (torch.arange(K, device=dev)[None, :, None] == idx[:, None, None]) \
        & (torch.arange(FIFO, device=dev)[None, None, :]
           == (wr % FIFO)[:, None, None])
    app = app.replace(
        fifo=torch.where(sel, app.relay_block[:, None, None], app.fifo),
        wr=_set_at(app.wr, rows, idx, wr + sent.to(I32)),
        relays=app.relays + sent.to(I64),
        stalls=app.stalls + skip.to(I64),
        relay_next=torch.where(active, app.relay_next + 1, app.relay_next),
    )
    more = active & (app.relay_next < K)
    buf = emit(buf, more, sim.net.lane_id, now, KIND_RELAY, _words(H, dev))
    app = app.replace(
        relay_block=torch.where(relay & ~more, -1, app.relay_block))
    return sim.replace(app=app), buf
