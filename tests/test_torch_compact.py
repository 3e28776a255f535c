"""Parity of the port's sparse-window fast path (shadow_tpu_torch/
core/compact.py, core/engine.py step_window) and window telemetry
(telemetry/ring.py, telemetry/harvest.py) with the reference.

- active_indices against the reference's on seeded masks;
  gather_lanes against the reference's on the same boot state;
  gather_lanes/scatter_lanes round trips.
- The sparse PHOLD of tests/test_sparse_fastpath.py (64 hosts, 4 of
  them active, load 2, sparse_lanes=16, ring on) and its census
  overflow (the same budget with 24 active hosts, so most windows hold
  more live rows than 16 and run full width): EngineStats, hit/miss
  included, and every state leaf, .telem.* included, equal the
  reference's.
- Harvester.summary() equals the reference Harvester's on the same run.

Both reference runs go through one compiled runner (same budget and
shapes; the active-host count is state data). Tolerance: zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu import telemetry as jtel
from shadow_tpu.apps import phold as jphold
from shadow_tpu.core import compact as jcompact
from shadow_tpu.core import simtime
from shadow_tpu.net import build as jbuild
from shadow_tpu.net.state import NetConfig as JConfig
from shadow_tpu_torch import convert
from shadow_tpu_torch import telemetry as ttel
from shadow_tpu_torch.apps import phold as tphold
from shadow_tpu_torch.core import compact as tcompact
from shadow_tpu_torch.net import build as tbuild
from shadow_tpu_torch.net.state import NetConfig as TConfig

torch.set_num_threads(1)

ONE_VERTEX = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="latency" attr.type="double" for="edge" id="lat" />
  <key attr.name="bandwidthup" attr.type="int" for="node" id="up" />
  <key attr.name="bandwidthdown" attr.type="int" for="node" id="dn" />
  <graph edgedefault="undirected">
    <node id="v0"><data key="up">10240</data><data key="dn">10240</data></node>
    <edge source="v0" target="v0"><data key="lat">50.0</data></edge>
  </graph>
</graphml>"""

H, LOAD, RING, SPARSE = 64, 2, 64, 16
# name -> active hosts
RUNS = {"hit": 4, "census_overflow": 24}


def _bundle(mod, cfg_cls, **kw):
    cfg = cfg_cls(num_hosts=H, tcp=False, end_time=simtime.ONE_SECOND,
                  seed=3, event_capacity=32, outbox_capacity=32,
                  router_ring=32, sparse_lanes=SPARSE)
    hosts = [mod.HostSpec(name=f"p{i}", proc_start_time=0) for i in range(H)]
    return mod.build(cfg, ONE_VERTEX, hosts, **kw)


def _boot(bundle, name, tel, app):
    """The bundle's boot sim with PHOLD set up for run `name` (the runs
    differ only in the active-host count) and the ring attached."""
    return tel.attach(app.setup(bundle.sim, load=LOAD,
                                active_hosts=RUNS[name]), capacity=RING)


@pytest.fixture(scope="module")
def bundles():
    """(reference bundle, port bundle), each built once for the file."""
    return _bundle(jbuild, JConfig), _bundle(tbuild, TConfig, device="cpu")


def _jax_leaves(sim):
    flat, _ = jax.tree_util.tree_flatten_with_path(sim)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _assert_leaves_equal(want, got):
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, (k, want[k].dtype, got[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def runs(bundles):
    jb, tb = bundles
    runner = jbuild.make_runner(jb, app_handlers=(jphold.handler,))
    trunner = tbuild.make_runner(tb, app_handlers=(tphold.handler,),
                                 device="cpu")
    out = {}
    for name in RUNS:
        jsim, jstats = runner(_boot(jb, name, jtel, jphold))
        jh = jtel.Harvester()
        jh.drain(jsim)
        tsim, tstats = trunner(_boot(tb, name, ttel, tphold))
        out[name] = dict(jax_stats=jstats.as_dict(),
                         jax_leaves=_jax_leaves(jsim),
                         jax_summary=jh.summary(),
                         stats=tstats.as_dict(), sim=tsim)
    return out


@pytest.mark.parametrize("name", sorted(RUNS))
def test_sparse_run_stats_match_reference(runs, name):
    r = runs[name]
    assert r["stats"] == r["jax_stats"]
    st = r["stats"]
    assert st["fastpath_hit"] + st["fastpath_miss"] == st["windows"]
    assert st["fastpath_miss"] > 0
    if name == "hit":
        assert st["fastpath_hit"] > 0


@pytest.mark.parametrize("name", sorted(RUNS))
def test_sparse_run_every_leaf_matches_reference(runs, name):
    r = runs[name]
    _assert_leaves_equal(r["jax_leaves"], convert.sim_to_numpy(r["sim"]))


@pytest.mark.parametrize("name", sorted(RUNS))
def test_harvester_summary_matches_reference(runs, name):
    r = runs[name]
    h = ttel.Harvester()
    assert h.drain(r["sim"]) == r["stats"]["windows"]
    assert h.summary() == r["jax_summary"]
    assert (sum(rec.fastpath for rec in h.records)
            == r["stats"]["fastpath_hit"])
    assert (sum(rec.events for rec in h.records)
            == r["stats"]["events_processed"])
    assert h.records[0].active_lanes == H
    # a second drain takes nothing new
    assert h.drain(r["sim"]) == 0


def test_harvester_counts_overrun(bundles):
    tb = bundles[1]
    sim = _boot(tb, "hit", ttel, tphold).replace(telem=None)
    sim = ttel.attach(sim, capacity=4)
    sim, stats = tbuild.make_runner(tb, app_handlers=(tphold.handler,),
                                    end_time=simtime.ONE_SECOND // 4,
                                    device="cpu")(sim)
    h = ttel.Harvester()
    assert h.drain(sim) == 4
    assert h.records_lost == int(stats.windows) - 4
    assert [r.index for r in h.records] == list(
        range(int(stats.windows) - 4, int(stats.windows)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_active_indices_match_reference(seed):
    rng = np.random.default_rng(seed)
    active = rng.random(40) < [0.1, 0.5, 0.9][seed]
    for s in (1, 8, 40):
        got = tcompact.active_indices(torch.as_tensor(active), s)
        want = jcompact.active_indices(jnp.asarray(active), s)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gather_lanes_matches_reference(bundles):
    jsim = _boot(bundles[0], "hit", jtel, jphold)
    tsim = _boot(bundles[1], "hit", ttel, tphold)
    idx = np.array([5, 0, 63, 17, 2], np.int32)
    want = _jax_leaves(jcompact.gather_lanes(jsim, jnp.asarray(idx)))
    _assert_leaves_equal(
        want, convert.sim_to_numpy(
            tcompact.gather_lanes(tsim, torch.as_tensor(idx))))


def test_gather_scatter_round_trip(bundles):
    sim = _boot(bundles[1], "hit", ttel, tphold)
    idx = tcompact.active_indices(torch.arange(H) % 5 == 0, 16)
    csim = tcompact.gather_lanes(sim, idx)
    assert csim.events.time.shape[0] == 16
    assert csim.net.lane_id.tolist() == idx.tolist()
    # replicated tables, the ring and scalars pass through whole
    assert csim.net.host_ip is sim.net.host_ip
    assert csim.telem.wstart is sim.telem.wstart
    assert csim.events.overflow is sim.events.overflow
    full = convert.sim_to_numpy(sim)
    _assert_leaves_equal(
        full, convert.sim_to_numpy(tcompact.scatter_lanes(sim, csim, idx)))
    # a change to compact rows lands on exactly those rows
    csim = csim.replace(app=csim.app.replace(sent=csim.app.sent + 7),
                        events=csim.events.replace(
                            overflow=csim.events.overflow + 1))
    back = tcompact.scatter_lanes(sim, csim, idx)
    sent = back.app.sent.clone()
    assert (sent[idx.long()] == sim.app.sent[idx.long()] + 7).all()
    sent[idx.long()] = sim.app.sent[idx.long()]
    assert torch.equal(sent, sim.app.sent)
    assert int(back.events.overflow) == int(sim.events.overflow) + 1
