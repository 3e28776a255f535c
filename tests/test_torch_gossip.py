"""Parity of the port's UDP Bitcoin gossip (shadow_tpu_torch/apps/
gossip.py make_peer_graph, setup, handler; BASELINE.json config #4)
with the reference (shadow_tpu) on the CPU.

The shape is tools/scale_run.py's --workload gossip at 64 hosts: K = 8
peers, a block every 2 s, 2 blocks, tcp=False, capacities 64, in_ring
32, the one-vertex 50 ms topology, 5 sim-s, with the telemetry ring
attached — once on one peer graph, once as 4 replicas of 16 hosts
(replica_size; block-diagonal graphs, each replica mining its own
chain). Each case runs to completion and equals the reference's run in
EngineStats and every state leaf. The block id rides the payref word
of the narrow 6-word UDP packet through the NIC and the router, so
every tip reaching the last block shows that word carried intact. The
two cases differ only in state, so one reference runner is compiled
for them; a third case arms the sparse fast path (sparse_lanes=16) so
that the gossip kinds (USER+1, USER+2) go through the census and the
compaction, with its own reference runner. Tolerance: zero.
"""

import jax
import numpy as np
import pytest
import torch

from shadow_tpu import telemetry as jtel
from shadow_tpu.apps import gossip as jgossip
from shadow_tpu.core import simtime
from shadow_tpu.net import build as jbuild
from shadow_tpu.net.state import NetConfig as JConfig
from shadow_tpu_torch import convert
from shadow_tpu_torch import telemetry as ttel
from shadow_tpu_torch.apps import gossip as tgossip
from shadow_tpu_torch.net import build as tbuild
from shadow_tpu_torch.net.state import NetConfig as TConfig
from tests.test_torch_tcp_bulk import _assert_leaves_equal, _jax_leaves

torch.set_num_threads(1)

ONE_VERTEX = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="latency" attr.type="double" for="edge" id="lat" />
  <key attr.name="bandwidthup" attr.type="int" for="node" id="up" />
  <key attr.name="bandwidthdown" attr.type="int" for="node" id="dn" />
  <graph edgedefault="undirected">
    <node id="poi"><data key="up">102400</data><data key="dn">102400</data>
    </node>
    <edge source="poi" target="poi"><data key="lat">50.0</data></edge>
  </graph>
</graphml>"""

H = 64
BLOCKS = 2
END = 5 * simtime.ONE_SECOND
# name -> (replica_size, sparse_lanes)
CASES = {"one-graph": (None, None), "replicas": (16, None),
         "sparse16": (None, 16)}


def _bundle(mod, cfg_cls, gossip, tel, name, **kw):
    rs, sparse = CASES[name]
    cfg = cfg_cls(num_hosts=H, seed=1, tcp=False, end_time=END,
                  event_capacity=64, outbox_capacity=64, router_ring=64,
                  in_ring=32, sparse_lanes=sparse)
    hosts = [mod.HostSpec(name=f"n{i}") for i in range(H)]
    b = mod.build(cfg, ONE_VERTEX, hosts, **kw)
    sim = gossip.setup(b.sim, peers_per_host=8,
                       block_interval=2 * simtime.ONE_SECOND,
                       max_blocks=BLOCKS, replica_size=rs)
    b.sim = tel.attach(sim)
    return b


@pytest.fixture(scope="module")
def runs():
    out = {}
    runners = {}
    for name in CASES:
        jb = _bundle(jbuild, JConfig, jgossip, jtel, name)
        key = CASES[name][1]
        if key not in runners:
            runners[key] = jbuild.make_runner(
                jb, app_handlers=(jgossip.handler,))
        jsim, jstats = runners[key](jb.sim)
        tb = _bundle(tbuild, TConfig, tgossip, ttel, name, device="cpu")
        tsim, tstats = tbuild.make_runner(
            tb, app_handlers=(tgossip.handler,), device="cpu")(tb.sim)
        out[name] = {"boot": _jax_leaves(jb.sim),
                     "port_boot": convert.sim_to_numpy(tb.sim),
                     "jax_stats": jstats.as_dict(),
                     "jax_final": _jax_leaves(jsim),
                     "port_stats": tstats.as_dict(), "port_sim": tsim}
    return out


@pytest.mark.parametrize("args", [(16, 4, 1), (64, 8, 42), (1000, 8, 7),
                                  (5120, 8, 42)])
def test_peer_graph_matches_reference(args):
    np.testing.assert_array_equal(tgossip.make_peer_graph(*args),
                                  jgossip.make_peer_graph(*args))


@pytest.mark.parametrize("name", list(CASES))
def test_boot_state_matches_reference(runs, name):
    _assert_leaves_equal(runs[name]["boot"], runs[name]["port_boot"])


@pytest.mark.parametrize("name", list(CASES))
def test_run_stats_match_reference(runs, name):
    assert runs[name]["port_stats"] == runs[name]["jax_stats"]


@pytest.mark.parametrize("name", list(CASES))
def test_run_every_leaf_matches_reference(runs, name):
    _assert_leaves_equal(runs[name]["jax_final"],
                         convert.sim_to_numpy(runs[name]["port_sim"]))


@pytest.mark.parametrize("name", list(CASES))
def test_every_tip_reaches_the_last_block(runs, name):
    sim, st = runs[name]["port_sim"], runs[name]["port_stats"]
    app = sim.app
    assert app.tip.tolist() == [BLOCKS - 1] * H
    replicas = H // (CASES[name][0] or H)
    assert int(app.blocks_mined.sum()) == BLOCKS * replicas
    assert int(app.dup_rx.sum()) > 0 and int(app.relays.sum()) > 0
    assert int(sim.events.overflow) == 0 and int(sim.outbox.overflow) == 0
    assert int(sim.net.rq_overflow) == 0
    assert int(sim.telem.count) == st["windows"]
    assert int(sim.telem.events.sum()) == st["events_processed"]


def test_sparse_case_compacts(runs):
    st = runs["sparse16"]["port_stats"]
    assert st["fastpath_hit"] > 0
    assert st["fastpath_hit"] + st["fastpath_miss"] == st["windows"]


def test_replicas_keep_to_their_blocks(runs):
    peers = runs["replicas"]["port_sim"].app.peers.numpy()
    blk = np.arange(H)[:, None] // 16
    assert ((peers < 0) | (peers // 16 == blk)).all()


def test_kinds_gate_is_the_identity():
    """The handler run with the engine's kinds bitmask and with kinds
    unknown (None: every phase runs) leaves every leaf equal."""
    from shadow_tpu_torch.core.engine import run
    from shadow_tpu_torch.net.step import make_step_fn

    b = _bundle(tbuild, TConfig, tgossip, ttel, "one-graph", device="cpu")
    step = make_step_fn(b.cfg, (tgossip.handler,))

    def blind(sim, popped, buf, kinds=None):
        return step(sim, popped, buf, kinds=None)

    outs = [run(b.sim, fn, end_time=b.cfg.end_time, min_jump=b.min_jump,
                emit_capacity=b.cfg.emit_capacity, lane_id=b.sim.net.lane_id)
            for fn in (step, blind)]
    (sima, sa), (simb, sb) = outs
    assert sa.as_dict() == sb.as_dict()
    _assert_leaves_equal(convert.sim_to_numpy(sima),
                         convert.sim_to_numpy(simb))
