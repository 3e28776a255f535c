"""Routing parity past one and two vertices: the port's numpy topology
(shadow_tpu_torch.routing.topology) against the reference's on
tests/test_topology.py's graphs, table for table — the triangle whose
shortest path routes around a vertex, attach tiers and longest-prefix
matching, min_jump and its 10 ms floor, a disconnected graph refused —
and a 64-host PHOLD run on bench.py's three-vertex MIX_VERTICES
(~1.1 ms windows) to 0.05 sim-s, leaf-equal with the reference.
Tolerance zero.
"""

import jax
import numpy as np
import pytest
import torch

from shadow_tpu.apps import phold as jphold
from shadow_tpu.core import simtime
from shadow_tpu.net import build as jbuild
from shadow_tpu.net.state import NetConfig as JConfig
from shadow_tpu.routing import Topology as JTopology
from shadow_tpu.routing import parse_graphml as jparse
from shadow_tpu_torch import convert
from shadow_tpu_torch.apps import phold as tphold
from shadow_tpu_torch.bench import MIX_VERTICES
from shadow_tpu_torch.net import build as tbuild
from shadow_tpu_torch.net.state import NetConfig as TConfig
from shadow_tpu_torch.routing.graphml import parse_graphml as tparse
from shadow_tpu_torch.routing.topology import Topology as TTopology
from test_topology import SINGLE, TRIANGLE

torch.set_num_threads(1)

GRAPHS = {"single": SINGLE, "triangle": TRIANGLE, "mix": MIX_VERTICES}


def _tops(name):
    text = GRAPHS[name]
    return JTopology(jparse(text)), TTopology(tparse(text))


@pytest.mark.parametrize("name", list(GRAPHS))
def test_path_tables_match_reference(name):
    j, t = _tops(name)
    assert t.is_complete == j.is_complete
    assert t.prefers_direct_paths == j.prefers_direct_paths
    assert t.graph.vertex_index == j.graph.vertex_index
    for attr in ("latency_ms", "latency_ns", "reliability"):
        want, got = np.asarray(getattr(j, attr)), np.asarray(getattr(t, attr))
        assert got.dtype == want.dtype, attr
        np.testing.assert_array_equal(got, want, err_msg=attr)


def test_triangle_routes_around_a_vertex():
    """a->c direct is 100 ms at 50% loss; a-b-c is 30 ms; the self path
    is the cheapest incident edge twice."""
    _, t = _tops("triangle")
    ia, ib, ic = (t.graph.vertex_index[x] for x in "abc")
    assert t.latency_ms[ia, ic] == 30.0
    assert abs(t.reliability[ia, ic] - 0.9) < 1e-9
    assert abs(t.reliability[ib, ic] - 1.0) < 1e-9
    assert t.latency_ms[ia, ia] == 20.0


ATTACH = [
    (0.0, dict(citycode="nyc", type_hint="relay")),
    (0.0, dict(citycode="nyc")),
    (1.0, dict(citycode="nyc")),
    (1.0, dict(type_hint="client")),
    (0.5, dict(ip_hint="11.0.0.200", citycode="lon")),
    (0.5, dict(ip_hint="11.0.0.3")),
    (0.0, {}),
    (1.0, {}),
    (0.37, dict(countrycode="zz")),
]


@pytest.mark.parametrize("draw,hints", ATTACH)
def test_attach_tiers_and_lpm_match_reference(draw, hints):
    j, t = _tops("triangle")
    assert t.find_attachment(draw, **hints) == j.find_attachment(draw,
                                                                 **hints)


@pytest.mark.parametrize("name,hints,draws", [
    ("triangle", [{"citycode": "nyc", "type": "relay"}, {"citycode": "lon"}],
     [0.0, 0.0]),
    ("triangle", [{"citycode": "nyc", "type": "relay"}] * 2, [0.0, 0.0]),
    ("triangle", [{}] * 5, [0.1, 0.5, 0.9, 0.3, 0.7]),
    ("mix", [{}] * 16, np.random.default_rng(3).random(16)),
    ("single", [{}], [0.0]),
])
def test_attach_hosts_and_min_jump_match_reference(name, hints, draws):
    j, t = _tops(name)
    pj, pt = j.attach_hosts(hints, draws), t.attach_hosts(hints, draws)
    for attr in ("vertex", "bw_up_kibps", "bw_down_kibps"):
        np.testing.assert_array_equal(np.asarray(getattr(pt, attr)),
                                      np.asarray(getattr(pj, attr)))
    assert t.min_jump_ns(pt) == j.min_jump_ns(pj)


def test_min_jump_values():
    _, t = _tops("triangle")
    pl = t.attach_hosts([{"citycode": "nyc", "type": "relay"},
                         {"citycode": "lon"}], [0.0, 0.0])
    assert t.min_jump_ns(pl) == 30 * simtime.ONE_MILLISECOND
    pl2 = t.attach_hosts([{"citycode": "nyc", "type": "relay"}] * 2,
                         [0.0, 0.0])
    assert t.min_jump_ns(pl2) == 20 * simtime.ONE_MILLISECOND
    # one host: no cross-host pair -> the 10 ms default runahead
    _, s = _tops("single")
    assert s.min_jump_ns(s.attach_hosts([{}], [0.0])) \
        == 10 * simtime.ONE_MILLISECOND


def test_disconnected_graph_rejected():
    bad = """<graphml><graph edgedefault="undirected">
      <node id="x"/><node id="y"/>
      <key attr.name="latency" attr.type="double" for="edge" id="lat"/>
    </graph></graphml>"""
    for parse, Top in ((jparse, JTopology), (tparse, TTopology)):
        with pytest.raises(ValueError, match="connected|no path"):
            Top(parse(bad))


# ----------------------------------------------- PHOLD on MIX_VERTICES

H, LOAD, END = 64, 4, simtime.ONE_SECOND // 20


def _cfg_kw():
    return dict(num_hosts=H, tcp=False, seed=3, end_time=END,
                event_capacity=32, outbox_capacity=32, router_ring=32)


@pytest.fixture(scope="module")
def mix_runs():
    hosts = [jbuild.HostSpec(name=f"peer{i}", proc_start_time=0)
             for i in range(H)]
    jb = jbuild.build(JConfig(**_cfg_kw()), MIX_VERTICES, hosts)
    jb.sim = jphold.setup(jb.sim, load=LOAD)
    jsim, jstats = jbuild.make_runner(
        jb, app_handlers=(jphold.handler,), app_bulk=jphold.BULK)(jb.sim)
    flat, _ = jax.tree_util.tree_flatten_with_path(jsim)
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}
    thosts = [tbuild.HostSpec(name=f"peer{i}", proc_start_time=0)
              for i in range(H)]
    tb = tbuild.build(TConfig(**_cfg_kw()), MIX_VERTICES, thosts,
                      device="cpu")
    tb.sim = tphold.setup(tb.sim, load=LOAD)
    tsim, tstats = tbuild.make_runner(
        tb, app_handlers=(tphold.handler,), app_bulk=tphold.BULK,
        device="cpu")(tb.sim)
    return {"jax": (want, jstats.as_dict(), jb.min_jump),
            "port": (convert.sim_to_numpy(tsim), tstats.as_dict(),
                     tb.min_jump, tsim)}


def test_mix_phold_stats_match_reference(mix_runs):
    want, wstats, wjump = mix_runs["jax"]
    got, gstats, gjump = mix_runs["port"][:3]
    assert gjump == wjump == 1_100_000
    assert gstats == wstats
    # the small-window shape: dozens of ~1.1 ms windows in 50 ms
    assert gstats["windows"] >= 40


def test_mix_phold_every_leaf_matches_reference(mix_runs):
    want, got = mix_runs["jax"][0], mix_runs["port"][0]
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_mix_phold_hosts_span_every_vertex(mix_runs):
    sim = mix_runs["port"][3]
    assert sorted(set(sim.net.vertex_of_host.tolist())) == [0, 1, 2]
    assert int(sim.events.overflow) == 0 and int(sim.outbox.overflow) == 0
    assert int(sim.app.rcvd.sum()) > 0
