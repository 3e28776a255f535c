"""On-device UDP ping/echo application (PyTorch port of
shadow_tpu/apps/pingpong.py) — the 2-host tgen ping analog
(BASELINE.json config #1).

Client: at PROC_START, sends a `size`-byte datagram to the server;
each reply triggers the next ping until `count` pings are done,
accumulating round-trip times. Server: echoes every datagram back to
its source.

`build_bench` is the bundle bench.py's pingpong workload runs: half
the hosts clients, half servers, client i pinging server i on a
one-vertex 50 ms graph (the reference's __graft_entry__._build).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from shadow_tpu_torch.core import simtime
from shadow_tpu_torch.core.events import EventKind, _Replace, census_mask
from shadow_tpu_torch.net import nic, udp
from shadow_tpu_torch.net.rings import gather_hs
from shadow_tpu_torch.net.sockets import sk_bind, sk_create
from shadow_tpu_torch.net.state import NetConfig, SocketType

I32 = torch.int32
I64 = torch.int64

ROLE_NONE = 0
ROLE_CLIENT = 1
ROLE_SERVER = 2


@dataclass
class PingPongApp(_Replace):
    role: torch.Tensor         # [H] i64
    sock: torch.Tensor         # [H] i64 socket slot
    server_ip: torch.Tensor    # [H] i64 (client: where to ping)
    server_port: torch.Tensor  # [H] i32
    size: torch.Tensor         # [H] i32 datagram payload bytes
    remaining: torch.Tensor    # [H] i32 pings left to send
    sent: torch.Tensor         # [H] i32
    rcvd: torch.Tensor         # [H] i32 (client: replies; server: pings)
    last_send: torch.Tensor    # [H] i64
    rtt_sum: torch.Tensor      # [H] i64


def setup(sim, *, client_mask, server_mask, server_ip, server_port: int,
          count: int = 10, size: int = 64):
    """Create + bind sockets and the app state (build time)."""
    H = sim.net.host_ip.shape[0]
    dev = sim.net.host_ip.device
    client_mask = torch.as_tensor(client_mask, device=dev)
    server_mask = torch.as_tensor(server_mask, device=dev)
    either = client_mask | server_mask
    net, slot = sk_create(sim.net, either, SocketType.UDP)
    # server binds the known port; client takes an ephemeral port
    net, _ = sk_bind(net, server_mask, slot, 0, server_port)
    net, _ = sk_bind(net, client_mask, slot, 0, 0)
    app = PingPongApp(
        role=torch.where(client_mask, ROLE_CLIENT,
                         torch.where(server_mask, ROLE_SERVER,
                                     ROLE_NONE)).to(I64),
        sock=slot,
        server_ip=torch.broadcast_to(
            torch.as_tensor(server_ip, dtype=I64, device=dev), (H,)).clone(),
        server_port=torch.full((H,), server_port, dtype=I32, device=dev),
        size=torch.full((H,), size, dtype=I32, device=dev),
        remaining=torch.where(client_mask, count, 0).to(I32),
        sent=torch.zeros((H,), dtype=I32, device=dev),
        rcvd=torch.zeros((H,), dtype=I32, device=dev),
        last_send=torch.zeros((H,), dtype=I64, device=dev),
        rtt_sum=torch.zeros((H,), dtype=I64, device=dev),
    )
    return sim.replace(net=net, app=app)


def _client_send(sim, buf, mask, now):
    app = sim.app
    net, ok = udp.udp_enqueue_send(
        sim.net, mask, app.sock, app.server_ip, app.server_port,
        app.size, -1,
    )
    app = app.replace(
        remaining=app.remaining - ok.to(I32),
        sent=app.sent + ok.to(I32),
        last_send=torch.where(ok, now, app.last_send),
    )
    sim = sim.replace(net=net, app=app)
    return nic.notify_wants_send(sim, buf, ok, now)


_START_KINDS = census_mask((EventKind.PROC_START,))
_RECV_KINDS = census_mask((EventKind.PACKET, EventKind.NIC_RECV,
                           EventKind.PACKET_LOCAL))


def handler(cfg: NetConfig, sim, popped, buf, kinds=None):
    """`kinds` (the engine's bitmask of the kinds popped this
    micro-step; None = unknown) skips a half whose kinds are absent —
    its masks would be all false, so it would change nothing."""
    now = popped.time

    # process start: client fires the first ping
    if kinds is None or kinds & _START_KINDS:
        app = sim.app
        is_start = popped.valid & (popped.kind == EventKind.PROC_START)
        start_client = is_start & (app.role == ROLE_CLIENT) \
            & (app.remaining > 0)
        sim, buf = _client_send(sim, buf, start_client, now)

    if not (kinds is None or kinds & _RECV_KINDS):
        return sim, buf
    # drain the socket whenever an event may have delivered data (the
    # epoll-notify -> process_continue analog, ref: epoll.c:638-680);
    # one datagram per micro-step
    app = sim.app
    may_have_data = popped.valid & (
        (popped.kind == EventKind.PACKET)
        | (popped.kind == EventKind.NIC_RECV)
        | (popped.kind == EventKind.PACKET_LOCAL)
    ) & (app.role != ROLE_NONE)
    readable = gather_hs(sim.net.in_count, app.sock) > 0
    net, got, src_ip, src_port, length, _ = udp.udp_recv(
        sim.net, may_have_data & readable, app.sock)

    # server echoes to the datagram's source
    echo = got & (app.role == ROLE_SERVER)
    net, ok = udp.udp_enqueue_send(net, echo, app.sock, src_ip, src_port,
                                   length, -1)
    sim, buf = nic.notify_wants_send(sim.replace(net=net), buf, ok, now)

    # client accounts RTT and sends the next ping
    reply = got & (app.role == ROLE_CLIENT)
    app = app.replace(
        rcvd=app.rcvd + got.to(I32),
        rtt_sum=app.rtt_sum + torch.where(reply, now - app.last_send, 0),
    )
    sim = sim.replace(app=app)
    nxt = reply & (app.remaining > 0)
    return _client_send(sim, buf, nxt, now)


# The reference's __graft_entry__.GRAPH and PORT: one vertex, a 50 ms
# self-edge, 10,240 KiB/s up and down.
GRAPH = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="latency" attr.type="double" for="edge" id="lat" />
  <key attr.name="bandwidthup" attr.type="int" for="node" id="up" />
  <key attr.name="bandwidthdown" attr.type="int" for="node" id="dn" />
  <graph edgedefault="undirected">
    <node id="v0"><data key="up">10240</data><data key="dn">10240</data></node>
    <edge source="v0" target="v0"><data key="lat">50.0</data></edge>
  </graph>
</graphml>"""

PORT = 7000


def build_bench(num_hosts: int, end_time_s: float = 2, count: int = 3,
                tcp: bool = True, device=None, graph: str = GRAPH):
    """The reference's __graft_entry__._build: hosts client0..client{H/2-1}
    (PROC_START at 1 s) then server0..server{H/2-1}, client i pinging
    server i with 128-byte datagrams `count` times. bench.py's pingpong
    uses tcp=False, count=20; the graft entry tcp=True, count=3 at 8
    hosts. `graph` replaces the topology (the bench's BENCH_TOPO=mix);
    `device` None is "cuda"."""
    from shadow_tpu_torch.net.build import HostSpec, build

    H = num_hosts
    cfg = NetConfig(num_hosts=H, end_time=int(end_time_s * simtime.ONE_SECOND),
                    tcp=tcp)
    hosts = [
        HostSpec(name=f"client{i}", proc_start_time=simtime.ONE_SECOND)
        for i in range(H // 2)
    ] + [HostSpec(name=f"server{i}") for i in range(H // 2)]
    b = build(cfg, graph, hosts, device=device)
    lanes = np.arange(H)
    server_ip = np.zeros(H, np.int64)
    for i in range(H // 2):
        server_ip[i] = b.ip_of(f"server{i}")
    b.sim = setup(
        b.sim, client_mask=torch.as_tensor(lanes < H // 2),
        server_mask=torch.as_tensor(lanes >= H // 2), server_ip=server_ip,
        server_port=PORT, count=count, size=128)
    return b
