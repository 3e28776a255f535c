"""The emit buffer overflows the same way in the port as in the
reference (shadow_tpu) on the CPU.

NetConfig.emit_capacity defaults to nic_drain + 6 = 10 with TCP on.
TCP gossip as tools/scale_run.py builds it (K = 8 peers, 12 sockets,
out_ring 16, capacities 64, PROC_START at 1 s, the one-vertex 50 ms
topology, 2 s block interval) issues one tcp_connect per peer in the
PROC_START micro-step, more emissions than that buffer holds, and the
reference counts each lost one in events.overflow. At 16 hosts to 1.5
sim-s (the connect burst and the handshakes) the port's run equals
the reference's in EngineStats, in every state leaf and in every
overflow counter (events, outbox, router ring), and that count is not
zero. Tolerance: zero.
"""

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
from tests.test_torch_gossip_tcp import GRAPH
from tests.test_torch_tcp_bulk import _assert_leaves_equal, _jax_leaves

torch.set_num_threads(1)

H = 16
END = int(1.5 * simtime.ONE_SECOND)


def _cfg(cfg_cls, **kw):
    return cfg_cls(num_hosts=H, seed=1, end_time=END, sockets_per_host=12,
                   event_capacity=64, outbox_capacity=64, router_ring=64,
                   out_ring=16, **kw)


def _bundle(mod, cfg_cls, gossip, **kw):
    hosts = [mod.HostSpec(name=f"n{i}", proc_start_time=simtime.ONE_SECOND)
             for i in range(H)]
    b = mod.build(_cfg(cfg_cls), GRAPH, hosts, **kw)
    b.sim = gossip.setup_tcp(b.sim, peers_per_host=8,
                             block_interval=2 * simtime.ONE_SECOND,
                             max_blocks=2)
    return b


def _overflows(sim):
    return {"events": int(np.asarray(sim.events.overflow)),
            "outbox": int(np.asarray(sim.outbox.overflow)),
            "router": int(np.asarray(sim.net.rq_overflow))}


@pytest.fixture(scope="module")
def runs():
    jb = _bundle(jbuild, JConfig, jgossip)
    jsim, jstats = jbuild.make_runner(
        jb, app_handlers=(jgossip.tcp_handler,))(jb.sim)
    tb = _bundle(tbuild, TConfig, tgossip, device="cpu")
    tsim, tstats = tbuild.make_runner(
        tb, app_handlers=(tgossip.tcp_handler,), device="cpu")(tb.sim)
    return {"jax_stats": jstats.as_dict(), "jax_final": _jax_leaves(jsim),
            "jax_overflow": _overflows(jsim), "port_stats": tstats.as_dict(),
            "port_sim": tsim}


@pytest.mark.parametrize("kw", [{}, {"tcp": False}, {"emit_capacity": 40},
                                {"nic_drain": 8}])
def test_emit_capacity_resolves_as_the_reference(kw):
    assert _cfg(TConfig, **kw).emit_capacity \
        == _cfg(JConfig, **kw).emit_capacity
    if not kw:
        assert _cfg(TConfig).emit_capacity == 10


def test_run_stats_match_reference(runs):
    assert runs["port_stats"] == runs["jax_stats"]


def test_every_leaf_matches_reference(runs):
    _assert_leaves_equal(runs["jax_final"],
                         convert.sim_to_numpy(runs["port_sim"]))


def test_overflow_counters_match_reference(runs):
    got = _overflows(runs["port_sim"])
    assert got == runs["jax_overflow"]
    # the connect burst of 8 peers overflows the default buffer
    assert got["events"] > 0
