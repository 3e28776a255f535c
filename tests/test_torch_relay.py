"""End-to-end parity of the port's TCP path (shadow_tpu_torch/net/tcp.py,
the NIC's TCP branches, the TCP timer families and apps/relay.py) with
the reference (shadow_tpu) on the CPU.

Three runs at 10 hosts (4 sockets each, the 25 ms one-vertex topology
of tests/test_models.py, telemetry ring attached), each to 65 sim-s so
that the 60 s TIME_WAIT expires, TCP_CLOSE_TIMER fires and sockets are
freed:

- "lossless": 2 circuits x 5 hops, 30,000 bytes each;
- "lossy": 5 circuits x 2 hops, 12,000 bytes each, 10% path loss, so
  that segments are retransmitted and fast recovery is entered;
- "rst": 2 circuits x 2 hops, 10,000 bytes each, the second server's
  listener closed in both packages' boot state: its client's SYN
  matches no socket and is answered with a RST, which resets the
  connector.

Each run compares EngineStats and every state leaf (.tcp.*, .app.* and
.telem.* included) with the reference's run of the same boot state.
The "lossy" run starts from the reference's boot state carried across
with convert.sim_from_numpy; every case's boot state built by the port
is compared with the reference's separately. One reference runner is
compiled for the file (the runs differ only in state data).
Tolerance: zero.
"""

import jax
import numpy as np
import pytest
import torch

from shadow_tpu import telemetry as jtel
from shadow_tpu.apps import relay as jrelay
from shadow_tpu.core import events as jevents
from shadow_tpu.core import simtime
from shadow_tpu.net import build as jbuild
from shadow_tpu.net import tcp as jtcp
from shadow_tpu.net.state import NetConfig as JConfig
from shadow_tpu_torch import convert
from shadow_tpu_torch import telemetry as ttel
from shadow_tpu_torch.apps import relay as trelay
from shadow_tpu_torch.core import events as tevents
from shadow_tpu_torch.net import build as tbuild
from shadow_tpu_torch.net import tcp as ttcp
from shadow_tpu_torch.net.state import NetConfig as TConfig
from shadow_tpu_torch.net.state import SocketType

torch.set_num_threads(1)

GRAPH = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="latency" attr.type="double" for="edge" id="lat" />
  <key attr.name="packetloss" attr.type="double" for="edge" id="pl" />
  <key attr.name="bandwidthup" attr.type="int" for="node" id="up" />
  <key attr.name="bandwidthdown" attr.type="int" for="node" id="dn" />
  <graph edgedefault="undirected">
    <node id="poi"><data key="up">10240</data><data key="dn">10240</data>
    </node>
    <edge source="poi" target="poi"><data key="lat">25.0</data>
      <data key="pl">%(loss)s</data></edge>
  </graph>
</graphml>"""

H = 10
END = 65 * simtime.ONE_SECOND
# name -> (path loss, circuits, bytes per circuit, hosts whose listener
# is closed before the run)
CASES = {
    "lossless": (0.0, [[0, 1, 2, 3, 4], [5, 6, 7, 8, 9]], 30_000, ()),
    "lossy": (0.1, [[2 * c, 2 * c + 1] for c in range(5)], 12_000, ()),
    "rst": (0.0, [[0, 1], [2, 3]], 10_000, (3,)),
}


def _bundle(mod, cfg_cls, relay, tcp, events, tel, name, **kw):
    loss, circuits, total, closed = CASES[name]
    cfg = cfg_cls(num_hosts=H, end_time=END, sockets_per_host=4)
    hosts = [mod.HostSpec(name=f"n{i}", proc_start_time=simtime.ONE_SECOND)
             for i in range(H)]
    b = mod.build(cfg, GRAPH % {"loss": loss}, hosts, **kw)
    sim = relay.setup(b.sim, circuits=circuits, total_bytes=total)
    if closed:
        m = np.zeros(H, bool)
        m[list(closed)] = True
        if kw:
            dev = kw["device"]
            mask = torch.as_tensor(m, device=dev)
            now = torch.zeros(H, dtype=torch.int64, device=dev)
            buf = events.EmitBuffer.create(H, b.cfg.emit_capacity,
                                           b.cfg.words_width, device=dev)
            sim, _ = tcp.tcp_close(b.cfg, sim, mask, sim.app.lsock, now, buf)
        else:
            # jitted: the reference's eager dispatch of the flush inside
            # tcp_close costs more than compiling it
            buf = events.EmitBuffer.create(H, b.cfg.emit_capacity,
                                           b.cfg.words_width)
            sim, _ = jax.jit(lambda s, mk, bf: tcp.tcp_close(
                b.cfg, s, mk, s.app.lsock,
                jax.numpy.zeros(H, jax.numpy.int64), bf))(
                    sim, jax.numpy.asarray(m), buf)
    b.sim = tel.attach(sim)
    return b


def _jax_bundle(name):
    return _bundle(jbuild, JConfig, jrelay, jtcp, jevents, jtel, name)


def _port_bundle(name):
    return _bundle(tbuild, TConfig, trelay, ttcp, tevents, ttel, name,
                   device="cpu")


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
    out = {}
    runner = None
    for name in CASES:
        jb = _jax_bundle(name)
        if runner is None:
            runner = jbuild.make_runner(jb, app_handlers=(jrelay.handler,))
        jsim, jstats = runner(jb.sim)
        tb = _port_bundle(name)
        boot = _jax_leaves(jb.sim)
        sim0 = (convert.sim_from_numpy(boot, device="cpu")
                if name == "lossy" else tb.sim)
        tsim, tstats = tbuild.make_runner(
            tb, app_handlers=(trelay.handler,), device="cpu")(sim0)
        out[name] = {"boot": boot, "port_boot": convert.sim_to_numpy(tb.sim),
                     "jax_stats": jstats.as_dict(),
                     "jax_final": _jax_leaves(jsim),
                     "port_stats": tstats.as_dict(), "port_sim": tsim}
    return out


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


@pytest.mark.parametrize("name", ["lossless", "lossy"])
def test_circuits_complete(runs, name):
    sim = runs[name]["port_sim"]
    _, circuits, total, _ = CASES[name]
    app = sim.app
    for chain in circuits:
        assert int(app.rcvd[chain[-1]]) == total
        assert bool(app.up_eof[chain[-1]])
    assert int(app.to_send.sum()) == 0 and int(app.fwd_pending.sum()) == 0
    assert int(sim.events.overflow) == 0 and int(sim.outbox.overflow) == 0
    assert int(sim.net.rq_overflow) == 0
    # the ring's planes add up to the run's totals
    st = runs[name]["port_stats"]
    assert int(sim.telem.count) == st["windows"]
    assert int(sim.telem.events.sum()) == st["events_processed"]
    assert int(sim.telem.retx.sum()) == int(sim.tcp.retx_segs.sum())


def test_lossy_run_retransmits_and_recovers(runs):
    tcp = runs["lossy"]["port_sim"].tcp
    assert int(tcp.retx_segs.sum()) > 0
    assert int(tcp.fr_entries.sum()) > 0


def test_time_wait_expires_and_frees_sockets(runs):
    """By 65 s every TIME_WAIT socket has been reaped: only the
    listeners of relays and servers remain allocated."""
    sim = runs["lossless"]["port_sim"]
    assert not bool((sim.tcp.st == ttcp.TcpSt.TIME_WAIT).any())
    alloc = sim.net.sk_type != SocketType.NONE
    listeners = sim.app.lsock >= 0
    assert alloc.sum(dim=1).tolist() == listeners.to(torch.int64).tolist()
    freed = sim.net.ctr_sk_free
    assert int(freed.sum()) == int(sim.net.ctr_sk_alloc.sum()) \
        - int(listeners.sum())


def test_rst_resets_the_connector(runs):
    """Host 2's SYN reaches host 3, whose listener is closed: host 3
    answers with a RST and drops nothing else; host 2's socket is
    freed and its SYN is never retransmitted. The other circuit
    completes."""
    sim = runs["rst"]["port_sim"]
    net, tcp, app = sim.net, sim.tcp, sim.app
    assert int(net.ctr_drop_nosocket[3]) == 1
    assert int(net.sk_type[2].abs().sum()) == 0
    assert int(net.ctr_sk_free[2]) == 1
    assert int(tcp.retx_segs[2]) == 0
    assert int(app.rcvd[1]) == CASES["rst"][2] and int(app.rcvd[3]) == 0
