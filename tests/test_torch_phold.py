"""End-to-end parity of the port's UDP PHOLD main path
(shadow_tpu_torch) with the reference (shadow_tpu) at small size.

- The port's own build gives the reference's boot state (build +
  phold.setup), leaf by leaf, at 16 and 64 hosts.
- A whole run at 64 hosts (load 4, 1 sim-s) gives equal EngineStats and
  every final leaf equal, compared by flax field path through
  convert.sim_to_numpy.
- The reference's boot state carried across with convert.sim_from_numpy
  and run in the port gives the same result.

One reference runner is compiled for the whole file (module fixture).
Tolerance: zero — the state is integer apart from f32 uniforms, which
are bit-exact.
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

H, LOAD, SEED = 64, 4, 3


def _cfg_kw(num_hosts, seed):
    return dict(num_hosts=num_hosts, tcp=False, seed=seed,
                end_time=simtime.ONE_SECOND)


def _jax_bundle(num_hosts, load, seed):
    hosts = [jbuild.HostSpec(name=f"peer{i}", proc_start_time=0)
             for i in range(num_hosts)]
    b = jbuild.build(JConfig(**_cfg_kw(num_hosts, seed)), ONE_VERTEX, hosts)
    b.sim = jphold.setup(b.sim, load=load)
    return b


def _port_bundle(num_hosts, load, seed):
    hosts = [tbuild.HostSpec(name=f"peer{i}", proc_start_time=0)
             for i in range(num_hosts)]
    b = tbuild.build(TConfig(**_cfg_kw(num_hosts, seed)), ONE_VERTEX, hosts,
                     device="cpu")
    b.sim = tphold.setup(b.sim, load=load)
    return b


def _jax_leaves(sim):
    flat, _ = jax.tree_util.tree_flatten_with_path(sim)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _assert_leaves_equal(want, got):
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, (k, want[k].dtype, got[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def runs():
    jb = _jax_bundle(H, LOAD, SEED)
    boot = _jax_leaves(jb.sim)
    jsim, jstats = jbuild.make_runner(jb, app_handlers=(jphold.handler,))(
        jb.sim)
    tb = _port_bundle(H, LOAD, SEED)
    tsim, tstats = tbuild.make_runner(tb, app_handlers=(tphold.handler,),
                                      device="cpu")(tb.sim)
    return {"boot": boot, "jax_stats": jstats.as_dict(),
            "jax_final": _jax_leaves(jsim), "bundle": tb,
            "port_stats": tstats.as_dict(), "port_sim": tsim}


@pytest.mark.parametrize("num_hosts", [16, 64])
def test_boot_state_matches_reference(num_hosts):
    jb = _jax_bundle(num_hosts, LOAD, SEED)
    tb = _port_bundle(num_hosts, LOAD, SEED)
    assert tb.min_jump == jb.min_jump
    assert tb.cfg.ip_affine_base == jb.cfg.ip_affine_base
    _assert_leaves_equal(_jax_leaves(jb.sim), convert.sim_to_numpy(tb.sim))


def test_run_stats_match_reference(runs):
    assert runs["port_stats"] == runs["jax_stats"]
    assert runs["port_stats"]["windows"] == 21


def test_run_every_leaf_matches_reference(runs):
    _assert_leaves_equal(runs["jax_final"],
                         convert.sim_to_numpy(runs["port_sim"]))


def test_run_circulates_without_loss(runs):
    sim = runs["port_sim"]
    sent, rcvd = int(sim.app.sent.sum()), int(sim.app.rcvd.sum())
    assert int(sim.app.remaining.sum()) == 0
    assert sent == H * LOAD + rcvd and rcvd > H * LOAD * 5
    assert int(sim.events.overflow) == 0 and int(sim.outbox.overflow) == 0
    assert int(sim.net.rq_overflow) == 0


def test_reference_boot_state_runs_identically_in_port(runs):
    sim = convert.sim_from_numpy(runs["boot"], device="cpu")
    out, stats = tbuild.make_runner(
        runs["bundle"], app_handlers=(tphold.handler,), device="cpu")(sim)
    assert stats.as_dict() == runs["jax_stats"]
    _assert_leaves_equal(runs["jax_final"], convert.sim_to_numpy(out))


def test_convert_round_trip(runs):
    leaves = runs["jax_final"]
    _assert_leaves_equal(
        leaves, convert.sim_to_numpy(convert.sim_from_numpy(leaves)))
