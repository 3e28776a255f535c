"""Parity of the port's congested UDP paths with the reference:
narrow token buckets (NIC_SEND / NIC_RECV chains and refill waits),
router-queue build-up with CoDel drops, and path loss (reliability
draws that drop packets). PHOLD's uncongested runs never take these
branches with a live mask.

16 hosts, load 16, 40 KiB/s up and 5 KiB/s down (the receive buckets
are the bottleneck, so router queues grow past CoDel's target), 2% loss
per edge, 0.3 sim-s; one reference runner for the file. Tolerance: zero (integer state,
bit-exact f32 draws, CoDel's f64 control law on both sides).
"""

import jax
import numpy as np
import pytest
import torch

from shadow_tpu.apps import phold as jphold
from shadow_tpu.core import simtime
from shadow_tpu.net import build as jbuild
from shadow_tpu.net.state import NetConfig as JConfig
from shadow_tpu_torch import convert
from shadow_tpu_torch.apps import phold as tphold
from shadow_tpu_torch.net import build as tbuild
from shadow_tpu_torch.net.state import NetConfig as TConfig

torch.set_num_threads(1)

LOSSY_SLOW = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="latency" attr.type="double" for="edge" id="lat" />
  <key attr.name="packetloss" attr.type="double" for="edge" id="loss" />
  <key attr.name="bandwidthup" attr.type="int" for="node" id="up" />
  <key attr.name="bandwidthdown" attr.type="int" for="node" id="dn" />
  <graph edgedefault="undirected">
    <node id="a"><data key="up">40</data><data key="dn">5</data></node>
    <node id="b"><data key="up">40</data><data key="dn">5</data></node>
    <edge source="a" target="a"><data key="lat">5.0</data>
      <data key="loss">0.02</data></edge>
    <edge source="b" target="b"><data key="lat">7.0</data>
      <data key="loss">0.02</data></edge>
    <edge source="a" target="b"><data key="lat">3.0</data>
      <data key="loss">0.02</data></edge>
  </graph>
</graphml>"""

H, LOAD, SEED = 16, 16, 21
KW = dict(num_hosts=H, tcp=False, seed=SEED,
          end_time=3 * simtime.ONE_SECOND // 10,
          router_ring=64, event_capacity=64, outbox_capacity=64)


def _hosts(mod):
    return [mod.HostSpec(name=f"h{i}", proc_start_time=0) for i in range(H)]


@pytest.fixture(scope="module")
def runs():
    jb = jbuild.build(JConfig(**KW), LOSSY_SLOW, _hosts(jbuild))
    jb.sim = jphold.setup(jb.sim, load=LOAD)
    jsim, jstats = jbuild.make_runner(jb, app_handlers=(jphold.handler,))(
        jb.sim)
    flat, _ = jax.tree_util.tree_flatten_with_path(jsim)
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}
    tb = tbuild.build(TConfig(**KW), LOSSY_SLOW, _hosts(tbuild),
                      device="cpu")
    tb.sim = tphold.setup(tb.sim, load=LOAD)
    tsim, tstats = tbuild.run(tb, app_handlers=(tphold.handler,),
                              device="cpu")
    return jstats.as_dict(), want, tstats.as_dict(), tsim


def test_congested_run_takes_the_congested_branches(runs):
    _, _, _, sim = runs
    net = sim.net
    assert int(net.ctr_drop_reliability.sum()) > 0
    assert int(net.ctr_drop_codel.sum()) > 0
    assert int(net.tb_send_tokens.min()) < 1500  # buckets ran dry


def test_congested_stats_match_reference(runs):
    jstats, _, tstats, _ = runs
    assert tstats == jstats


def test_congested_every_leaf_matches_reference(runs):
    _, want, _, tsim = runs
    got = convert.sim_to_numpy(tsim)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
