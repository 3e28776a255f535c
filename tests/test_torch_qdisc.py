"""Parity of the port's interface qdiscs and router queue managers
(shadow_tpu_torch.net.nic) with the reference's:

- tests/test_router_qdisc.py's shape — 8 UDP ping clients blast one
  server throttled to 1 KiB/s down, router ring 4 — under the SINGLE,
  STATIC and CODEL managers (each a UDP program), cut from 2 to 0.3
  sim-s (its 1 ms windows cost the port ~15 ms each on the CPU);
- the round-robin interface qdisc on the built-in example (3 clients
  upload to one server, whose ACKs leave through several child
  sockets), loaded with `interface_qdisc="rr"` as the CLI's
  `--interface-qdisc rr` passes it, cut to 4 sim-s (the one TCP
  program).

Each holds EngineStats and every final leaf equal (tolerance zero),
plus the reference test's checks on the port's run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.apps import pingpong as jping
from shadow_tpu.config import loader as jloader
from shadow_tpu.config import xmlconfig as jxml
from shadow_tpu.core import simtime
from shadow_tpu.net import build as jbuild
from shadow_tpu.net import packetfmt as jpf
from shadow_tpu.net.state import NetConfig as JConfig
from shadow_tpu_torch import convert
from shadow_tpu_torch.apps import pingpong as tping
from shadow_tpu_torch.config import examples
from shadow_tpu_torch.config import loader as tloader
from shadow_tpu_torch.config import xmlconfig as txml
from shadow_tpu_torch.net import build as tbuild
from shadow_tpu_torch.net.state import NetConfig as TConfig
from shadow_tpu_torch.net.state import QDisc, RouterQ
from test_router_qdisc import GRAPH, PORT
from torch_parity import side_by_side

torch.set_num_threads(1)

CLIENTS = 8
BLAST_END = 300 * simtime.ONE_MILLISECOND


def _jax_leaves(sim):
    flat, _ = jax.tree_util.tree_flatten_with_path(sim)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _assert_leaves_equal(want, got):
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, (k, want[k].dtype, got[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _blast(pkg, router_qdisc):
    """tests/test_router_qdisc.py's _run build, in either package."""
    H = CLIENTS + 1
    if pkg == "jax":
        build, HostSpec, Cfg, app, kw = (jbuild.build, jbuild.HostSpec,
                                         JConfig, jping, {})
    else:
        build, HostSpec, Cfg, app, kw = (tbuild.build, tbuild.HostSpec,
                                         TConfig, tping, {"device": "cpu"})
    cfg = Cfg(num_hosts=H, tcp=False, end_time=BLAST_END,
              router_qdisc=router_qdisc, event_capacity=64,
              outbox_capacity=64, router_ring=4)
    hosts = [HostSpec(name=f"c{i}", type="client",
                      proc_start_time=simtime.ONE_MILLISECOND)
             for i in range(CLIENTS)]
    hosts.append(HostSpec(name="server", type="server"))
    b = build(cfg, GRAPH, hosts, **kw)
    client, server = np.arange(H) < CLIENTS, np.arange(H) >= CLIENTS
    sip = np.zeros(H, np.int64)
    sip[:CLIENTS] = b.ip_of("server")
    if pkg == "jax":
        client, server, sip = (jnp.asarray(client), jnp.asarray(server),
                               jnp.asarray(sip))
    b.sim = app.setup(b.sim, client_mask=client, server_mask=server,
                      server_ip=sip, server_port=PORT, count=8, size=1000)
    return b


MANAGERS = {"single": RouterQ.SINGLE, "static": RouterQ.STATIC,
            "codel": RouterQ.CODEL}
RR_TEXT = examples.example_config(clients=3, kib=40, stoptime=4)


@pytest.fixture(scope="module")
def runs():
    """{name: (reference stats, leaves, port stats, leaves)}; the four
    reference programs run side by side."""
    ov = {"interface_qdisc": "rr"}
    jl = jloader.load(jxml.parse_config(RR_TEXT), seed=2, overrides=dict(ov))
    tl = tloader.load(txml.parse_config(RR_TEXT), seed=2, overrides=dict(ov),
                      device="cpu")
    assert tl.bundle.cfg.qdisc == QDisc.RR == jl.bundle.cfg.qdisc

    def ref(b, handlers):
        def go():
            jsim, jstats = jbuild.run(b, app_handlers=handlers)
            return jstats.as_dict(), _jax_leaves(jsim)
        return go

    def port():
        got = {}
        for name, rq in MANAGERS.items():
            tsim, tstats = tbuild.run(_blast("port", rq),
                                      app_handlers=(tping.handler,),
                                      device="cpu")
            got[name] = (tstats.as_dict(), convert.sim_to_numpy(tsim))
        tsim, tstats = tbuild.run(tl.bundle, app_handlers=tl.handlers,
                                  device="cpu")
        got["rr"] = (tstats.as_dict(), convert.sim_to_numpy(tsim))
        return got

    cases = {name: (_blast("jax", rq), (jping.handler,))
             for name, rq in MANAGERS.items()}
    cases["rr"] = (jl.bundle, jl.handlers)
    *refs, got = side_by_side([ref(b, h) for b, h in cases.values()]
                              + [port])
    return {name: (*r, *got[name]) for name, r in zip(cases, refs)}


@pytest.mark.parametrize("name", [*MANAGERS, "rr"])
def test_run_matches_reference(runs, name):
    jstats, jleaves, tstats, tleaves = runs[name]
    assert tstats == jstats
    _assert_leaves_equal(jleaves, tleaves)


@pytest.mark.parametrize("name", ["single", "static"])
def test_drop_managers_drop_by_policy(runs, name):
    """tests/test_router_qdisc.py: the burst finds the queue taken, the
    drops are policy (counted, audited), not overflow, and traffic
    still flows."""
    leaves = runs[name][3]
    H = CLIENTS + 1
    assert int(leaves[".events.overflow"]) == 0
    assert int(leaves[".net.ctr_drop_codel"][H - 1]) > 0
    assert int(leaves[".net.rq_overflow"]) == 0
    assert int(leaves[".net.ctr_rx_packets"][H - 1]) > 0
    assert "ROUTER_DROPPED" in jpf.pds_decode(
        int(leaves[".net.last_drop_status"][H - 1]))


def test_codel_keeps_ring_admission(runs):
    leaves = runs["codel"][3]
    assert int(leaves[".events.overflow"]) == 0
    assert int(leaves[".net.ctr_rx_packets"][CLIENTS]) > 0


def test_round_robin_cursor_moves(runs):
    """The RR cursor advanced on the server, which sends from several
    child sockets, and the uploads progressed."""
    leaves = runs["rr"][3]
    srv = leaves[".app.is_server"]
    assert (leaves[".net.rr_ptr"][srv] > 0).all()
    assert int(leaves[".app.rcvd"].sum()) > 0
    assert int(leaves[".events.overflow"]) == 0
