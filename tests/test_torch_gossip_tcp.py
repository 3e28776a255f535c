"""Parity of the port's TCP Bitcoin gossip (shadow_tpu_torch/apps/
gossip.py setup_tcp, tcp_handler) with the reference (shadow_tpu) on
the CPU.

The shape is the reference test's (tests/test_gossip_tcp.py): 8 hosts,
K = 3 peers, 3 blocks every 2 s from 2 s on, 4 + 2K sockets,
capacities 64, out_ring 16, PROC_START at 1 s, the one-vertex 50 ms
topology, seed 3, 12 sim-s — block flooding over persistent TCP peer
connections with the per-edge id sideband, to completion. The port's
run, with the handler's gates on, equals the reference's in
EngineStats and every state leaf. The cross-row sideband reads clamp
an index past the rows of a compacted view as a JAX gather does; that
is held against jax.numpy directly. Tolerance: zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.apps import gossip as jgossip
from shadow_tpu.core import simtime
from shadow_tpu.net import build as jbuild
from shadow_tpu.net.state import NetConfig as JConfig
from shadow_tpu_torch import convert
from shadow_tpu_torch.apps import gossip as tgossip
from shadow_tpu_torch.net import build as tbuild
from shadow_tpu_torch.net.state import NetConfig as TConfig
from tests.test_torch_tcp_bulk import _assert_leaves_equal, _jax_leaves
from torch_parity import side_by_side

torch.set_num_threads(1)

GRAPH = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="latency" attr.type="double" for="edge" id="lat" />
  <key attr.name="bandwidthup" attr.type="int" for="node" id="up" />
  <key attr.name="bandwidthdown" attr.type="int" for="node" id="dn" />
  <graph edgedefault="undirected">
    <node id="v0"><data key="up">102400</data><data key="dn">102400</data>
    </node>
    <edge source="v0" target="v0"><data key="lat">50.0</data></edge>
  </graph>
</graphml>"""

H = 8
K = 3
BLOCKS = 3


def _bundle(mod, cfg_cls, gossip, **kw):
    cfg = cfg_cls(num_hosts=H, seed=3, end_time=12 * simtime.ONE_SECOND,
                  sockets_per_host=4 + 2 * K, event_capacity=64,
                  outbox_capacity=64, router_ring=64, out_ring=16)
    hosts = [mod.HostSpec(name=f"n{i}", proc_start_time=simtime.ONE_SECOND)
             for i in range(H)]
    b = mod.build(cfg, GRAPH, hosts, **kw)
    b.sim = gossip.setup_tcp(b.sim, peers_per_host=K,
                             block_interval=2 * simtime.ONE_SECOND,
                             max_blocks=BLOCKS)
    return b


@pytest.fixture(scope="module")
def runs():
    jb = _bundle(jbuild, JConfig, jgossip)
    tb = _bundle(tbuild, TConfig, tgossip, device="cpu")
    # the reference's run and the port's side by side
    (jsim, jstats), (tsim, tstats) = side_by_side([
        lambda: jbuild.make_runner(
            jb, app_handlers=(jgossip.tcp_handler,))(jb.sim),
        lambda: tbuild.make_runner(
            tb, app_handlers=(tgossip.tcp_handler,), device="cpu")(tb.sim)])
    return {"boot": _jax_leaves(jb.sim),
            "port_boot": convert.sim_to_numpy(tb.sim),
            "jax_stats": jstats.as_dict(), "jax_final": _jax_leaves(jsim),
            "port_stats": tstats.as_dict(), "port_sim": tsim}


def test_boot_state_matches_reference(runs):
    _assert_leaves_equal(runs["boot"], runs["port_boot"])


def test_scale_run_builder_matches_the_run_bundle(runs):
    """shadow_tpu_torch.tools.scale_run's TCP gossip builder, given
    this file's peers, sockets and blocks, boots the bundle this file
    runs against the reference, leaf for leaf."""
    from shadow_tpu_torch.tools import scale_run

    args = scale_run.parse_args([
        "--workload", "gossip", "--gossip-transport", "tcp", "--hosts",
        str(H), "--sim-seconds", "12", "--cpu"])
    b, kw, verify = scale_run.build_workload(
        args, 3, 64, graph=GRAPH, peers=K, sockets=4 + 2 * K, blocks=BLOCKS)
    assert kw == {"app_handlers": (tgossip.tcp_handler,)}
    _assert_leaves_equal(runs["port_boot"], convert.sim_to_numpy(b.sim))
    assert verify(runs["port_sim"]) and verify.fraction == 1.0


def test_run_stats_match_reference(runs):
    assert runs["port_stats"] == runs["jax_stats"]


def test_run_every_leaf_matches_reference(runs):
    _assert_leaves_equal(runs["jax_final"],
                         convert.sim_to_numpy(runs["port_sim"]))


def test_floods_every_host(runs):
    """Every tip at the last block, dedup engaged, every stream framed
    (no partial block left), the mesh carried the blocks over TCP."""
    sim = runs["port_sim"]
    app = sim.app
    assert app.tip.tolist() == [BLOCKS - 1] * H
    assert int(app.dup_rx.sum()) > 0
    assert int(app.send_left.sum()) == 0 and int(app.rx_acc.sum()) == 0
    assert int(sim.net.ctr_tx_data_bytes.sum()) \
        >= BLOCKS * tgossip.BLOCK_BYTES
    assert int(sim.events.overflow) == 0 and int(sim.outbox.overflow) == 0
    # every edge kept: the graph is symmetric after setup_tcp
    peers, back = app.peers.numpy(), app.peer_back.numpy()
    for h in range(H):
        for k in range(K):
            if peers[h, k] >= 0:
                assert peers[peers[h, k], back[h, k]] == h


@pytest.mark.parametrize("rows", [4, 8])
def test_peer_row_clamps_like_a_jax_gather(rows):
    """app.fifo[pk, bk, rd % FIFO] with peer host ids past the rows of
    the (compacted) view: the port's clamped index reads the element a
    JAX gather reads."""
    rng = np.random.default_rng(rows)
    fifo = rng.integers(-1, 100, (rows, K, tgossip.FIFO)).astype(np.int32)
    pk = rng.integers(0, 3 * rows, rows).astype(np.int32)
    bk = rng.integers(0, K, rows).astype(np.int32)
    rd = rng.integers(0, 40, rows).astype(np.int32)
    want = np.asarray(jnp.asarray(fifo)[jnp.asarray(pk), jnp.asarray(bk),
                                        jnp.asarray(rd) % tgossip.FIFO])
    f = torch.as_tensor(fifo)
    got = f[tgossip._peer_row(torch.as_tensor(pk), f),
            torch.as_tensor(bk).long(),
            (torch.as_tensor(rd) % tgossip.FIFO).long()]
    np.testing.assert_array_equal(got.numpy(), want)
    assert (pk >= rows).any()
