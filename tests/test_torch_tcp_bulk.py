"""Parity of the port's TCP bulk window pass (shadow_tpu_torch/net/
tcp_bulk.py, apps/relay.py RelayTcpBulk, make_runner(app_tcp_bulk=...))
with the reference (shadow_tpu) on the CPU.

Four relay runs at 10 hosts (4 sockets, capacities 64, the one-vertex
50 ms topology of tests/test_tcp_bulk.py, telemetry ring attached, 12
sim-s), each through the TCP bulk pass in both packages:

- "lossless": 2 circuits x 5 hops, 30,000 bytes;
- "lossy": 5 circuits x 2 hops, 60,000 bytes, 2% loss, started from
  the reference's boot state with every rng_ctr set just below 2^32
  (carried across with convert.sim_from_numpy), so the draw counters
  wrap mid-run;
- "slow": 5 x 2 hops, 60,000 bytes, 2% loss on a 2,500 KiB/s link
  (the pass's NIC output-ring path);
- "lossy5": 2 x 5 hops, 60,000 bytes, 2% loss.

Each port run's EngineStats and every state leaf (.tcp.*, .app.*,
.telem.* included) equal the reference's TCP bulk run. The port's
narrow pass (lossless=True) and its serial path, on two cases, equal
the reference's bulk run under the dead-plane contract of
tests/test_tcp_bulk.py (copied below). One reference runner is
compiled for the file: loss and bandwidth are topology data, so the
cases differ only in state. Tolerance: zero.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu import telemetry as jtel
from shadow_tpu.apps import relay as jrelay
from shadow_tpu.core import simtime
from shadow_tpu.net import build as jbuild
from shadow_tpu.net import tcp_bulk as jtcp_bulk
from shadow_tpu.net.state import NetConfig as JConfig
from shadow_tpu.net.state import QDisc as JQDisc
from shadow_tpu.net.state import RouterQ as JRouterQ
from shadow_tpu_torch import convert
from shadow_tpu_torch import telemetry as ttel
from shadow_tpu_torch.apps import relay as trelay
from shadow_tpu_torch.core.engine import resolve_sparse_lanes
from shadow_tpu_torch.core.engine import run as engine_run
from shadow_tpu_torch.net import build as tbuild
from shadow_tpu_torch.net import tcp_bulk as ttcp_bulk
from shadow_tpu_torch.net.state import NetConfig as TConfig
from shadow_tpu_torch.net.state import QDisc as TQDisc
from shadow_tpu_torch.net.state import RouterQ as TRouterQ
from shadow_tpu_torch.net.step import make_step_fn
from shadow_tpu_torch.telemetry import make_telem_fn

torch.set_num_threads(1)

GRAPH = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="latency" attr.type="double" for="edge" id="lat" />
  <key attr.name="packetloss" attr.type="double" for="edge" id="pl" />
  <key attr.name="bandwidthup" attr.type="int" for="node" id="up" />
  <key attr.name="bandwidthdown" attr.type="int" for="node" id="dn" />
  <graph edgedefault="undirected">
    <node id="v0"><data key="up">%(bw)d</data><data key="dn">%(bw)d</data>
    </node>
    <edge source="v0" target="v0"><data key="lat">50.0</data>
    <data key="pl">%(loss)s</data></edge>
  </graph>
</graphml>"""

H = 10
END = 12 * simtime.ONE_SECOND
CAP = 64
# name -> (hops per circuit, bytes per circuit, link KiB/s, path loss)
CASES = {
    "lossless": (5, 30_000, 102400, 0.0),
    "lossy": (2, 60_000, 102400, 0.02),
    "slow": (2, 60_000, 2500, 0.02),
    "lossy5": (5, 60_000, 102400, 0.02),
}
# the case started from the reference's boot state, counters near 2^32
CARRIED = "lossy"
# the cases the port's narrow pass and serial path also run
CONTRACT_CASES = ("lossless", "lossy")

# dead storage under the reference's contract (tests/test_tcp_bulk.py)
DEAD = {
    "in_src_ip", "in_src_port", "in_len", "in_payref", "in_status",
    "out_words", "out_priority",
    "rq_src", "rq_enq_ts", "rq_words",
}


def _circuits(name):
    hop = CASES[name][0]
    return [list(range(c * hop, (c + 1) * hop)) for c in range(H // hop)]


def _bundle(mod, cfg_cls, relay, tel, name, **kw):
    _, total, bw, loss = CASES[name]
    cfg = cfg_cls(num_hosts=H, end_time=END, sockets_per_host=4,
                  event_capacity=CAP, outbox_capacity=CAP, router_ring=CAP)
    hosts = [mod.HostSpec(name=f"n{i}", proc_start_time=simtime.ONE_SECOND)
             for i in range(H)]
    b = mod.build(cfg, GRAPH % {"bw": bw, "loss": loss}, hosts, **kw)
    sim = relay.setup(b.sim, circuits=_circuits(name), total_bytes=total)
    b.sim = tel.attach(sim)
    return b


def _near_wrap():
    return (2**32 - 7 - np.arange(H)).astype(np.uint32)


def _jax_leaves(sim):
    flat, _ = jax.tree_util.tree_flatten_with_path(sim)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _assert_leaves_equal(want, got):
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, (k, want[k].dtype, got[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _group(leaves, name):
    p = f".{name}."
    return {k[len(p):]: v for k, v in leaves.items() if k.startswith(p)}


def _assert_contract(want, got):
    """The reference's bit-identity contract between a bulk run and a
    serial run (tests/test_tcp_bulk.py _compare), on leaf dicts: net
    leaves outside the dead set, the live output-ring regions, every
    tcp and app leaf, the live event-queue slots, the outbox's
    dst/time/count/overflow."""
    na, nb = _group(want, "net"), _group(got, "net")
    assert sorted(na) == sorted(nb)
    for f in na:
        if f not in DEAD:
            np.testing.assert_array_equal(nb[f], na[f],
                                          err_msg=f"net.{f} diverged")
    head, cnt = na["out_head"], na["out_count"]
    BO = na["out_words"].shape[2]
    off = (np.arange(BO)[None, None, :] - head[..., None]) % BO
    live = off < cnt[..., None]
    for f in ("out_words", "out_priority"):
        lv = live[..., None] if na[f].ndim == 4 else live
        np.testing.assert_array_equal(
            np.where(lv, nb[f], 0), np.where(lv, na[f], 0),
            err_msg=f"net.{f} live ring region diverged")
    for grp in ("tcp", "app"):
        ga, gb = _group(want, grp), _group(got, grp)
        assert sorted(ga) == sorted(gb)
        for f in ga:
            np.testing.assert_array_equal(gb[f], ga[f],
                                          err_msg=f"{grp}.{f} diverged")
    qa, qb = _group(want, "events"), _group(got, "events")
    live_a = qa["time"] != simtime.INVALID
    live_b = qb["time"] != simtime.INVALID
    for f in ("time", "kind", "src", "seq", "words", "next_seq",
              "overflow"):
        a, b = qa[f], qb[f]
        if f in ("kind", "src", "seq", "words"):
            la = live_a[..., None] if f == "words" else live_a
            lb = live_b[..., None] if f == "words" else live_b
            a, b = np.where(la, a, 0), np.where(lb, b, 0)
        np.testing.assert_array_equal(b, a, err_msg=f"events.{f} diverged")
    oa, ob = _group(want, "outbox"), _group(got, "outbox")
    for f in ("dst", "time", "count", "overflow"):
        np.testing.assert_array_equal(ob[f], oa[f],
                                      err_msg=f"outbox.{f} diverged")


def _port_run(tb, sim0, **kw):
    return tbuild.make_runner(tb, app_handlers=(trelay.handler,),
                              device="cpu", **kw)(sim0)


@pytest.fixture(scope="module")
def runs():
    out = {}
    runner = None
    for name in CASES:
        jb = _bundle(jbuild, JConfig, jrelay, jtel, name)
        if name == CARRIED:
            jb.sim = jb.sim.replace(net=jb.sim.net.replace(
                rng_ctr=jnp.asarray(_near_wrap())))
        if runner is None:
            runner = jbuild.make_runner(jb, app_handlers=(jrelay.handler,),
                                        app_tcp_bulk=jrelay.TCP_BULK)
        jsim, jstats = runner(jb.sim)
        tb = _port_bundle(name)
        boot = _jax_leaves(jb.sim)
        sim0 = (convert.sim_from_numpy(boot, device="cpu")
                if name == CARRIED else tb.sim)
        tsim, tstats = _port_run(tb, sim0, app_tcp_bulk=trelay.TCP_BULK)
        r = {"boot": boot, "port_boot": convert.sim_to_numpy(tb.sim),
             "jax_stats": jstats.as_dict(), "jax_final": _jax_leaves(jsim),
             "port_stats": tstats.as_dict(), "port_sim": tsim,
             "bundle": tb, "sim0": sim0}
        if name in CONTRACT_CASES:
            for mode, kw in (("narrow", {"app_tcp_bulk": trelay.TCP_BULK,
                                         "tcp_bulk_lossless": True}),
                             ("serial", {})):
                s, st = _port_run(tb, sim0, **kw)
                r[mode] = (convert.sim_to_numpy(s), st.as_dict())
        out[name] = r
    return out


def _port_bundle(name):
    return _bundle(tbuild, TConfig, trelay, ttel, name, device="cpu")


@pytest.mark.parametrize("name", list(CASES))
def test_boot_state_matches_reference(runs, name):
    r = runs[name]
    port_boot = dict(r["port_boot"])
    if name == CARRIED:
        assert (r["boot"][".net.rng_ctr"] == _near_wrap()).all()
        port_boot[".net.rng_ctr"] = r["boot"][".net.rng_ctr"]
    _assert_leaves_equal(r["boot"], port_boot)


@pytest.mark.parametrize("name", list(CASES))
def test_bulk_stats_match_reference(runs, name):
    assert runs[name]["port_stats"] == runs[name]["jax_stats"]


@pytest.mark.parametrize("name", list(CASES))
def test_bulk_every_leaf_matches_reference(runs, name):
    _assert_leaves_equal(runs[name]["jax_final"],
                         convert.sim_to_numpy(runs[name]["port_sim"]))


@pytest.mark.parametrize("name", list(CASES))
def test_transfers_complete_through_the_pass(runs, name):
    sim = runs[name]["port_sim"]
    total = CASES[name][1]
    for chain in _circuits(name):
        assert int(sim.app.rcvd[chain[-1]]) == total
    assert int(sim.events.overflow) == 0 and int(sim.outbox.overflow) == 0
    st = runs[name]["port_stats"]
    assert int(sim.telem.count) == st["windows"]
    assert int(sim.telem.events.sum()) == st["events_processed"]
    assert int(sim.telem.retx.sum()) == int(sim.tcp.retx_segs.sum())
    if CASES[name][3] > 0:
        assert int(sim.tcp.retx_segs.sum()) > 0


def test_counters_wrap_in_the_carried_case(runs):
    """Every host of the carried case started within 16 draws of 2^32;
    the clients, which wire every data segment, wrapped past zero."""
    ctr = runs[CARRIED]["port_sim"].net.rng_ctr
    clients = [c[0] for c in _circuits(CARRIED)]
    assert int(ctr[clients].max()) < 2**31


@pytest.mark.parametrize("mode", ["narrow", "serial"])
@pytest.mark.parametrize("name", CONTRACT_CASES)
def test_contract_with_reference_bulk(runs, name, mode):
    """The port's narrow pass and its serial path end where the
    reference's bulk pass ends, under the reference's contract, with
    the same events and windows."""
    r = runs[name]
    leaves, st = r[mode]
    _assert_contract(r["jax_final"], leaves)
    assert st["events_processed"] == r["jax_stats"]["events_processed"]
    assert st["windows"] == r["jax_stats"]["windows"]


@pytest.mark.parametrize("name", CONTRACT_CASES)
def test_pass_engages(runs, name):
    """Fewer micro-steps than the serial path, and the debug view of
    the pass commits hosts on some windows; debug=True changes
    nothing."""
    r = runs[name]
    assert r["port_stats"]["micro_steps"] < r["serial"][1]["micro_steps"]
    tb = r["bundle"]
    fn = ttcp_bulk.make_tcp_bulk_fn(tb.cfg, trelay.TCP_BULK, debug=True)
    commits = []

    def bulk(sim, wend):
        sim, n, d = fn(sim, wend)
        assert not bool((d["commit"] & ~d["elig"]).any())
        commits.append(int(d["commit"].sum()))
        return sim, n

    sim, st = engine_run(
        r["sim0"], make_step_fn(tb.cfg, (trelay.handler,)),
        end_time=tb.cfg.end_time, min_jump=tb.min_jump,
        emit_capacity=tb.cfg.emit_capacity, lane_id=r["sim0"].net.lane_id,
        bulk_fn=bulk, telem_fn=make_telem_fn(),
        sparse_lanes=resolve_sparse_lanes(tb.cfg))
    assert st.as_dict() == r["port_stats"]
    assert sum(c > 0 for c in commits) > 0
    assert fn.counters["iterations"] > 0
    _assert_leaves_equal(r["jax_final"], convert.sim_to_numpy(sim))


# ---- static preconditions -----------------------------------------------

VARIANTS = {
    "default": {},
    "udp": {"tcp": False},
    "rr": {"qdisc": "RR"},
    "router_single": {"router_qdisc": "SINGLE"},
    "pcap": {"pcap": True},
    "cpu": {"cpu_threshold_ns": 0},
    "drain3": {"nic_drain": 3},
    "out_ring4": {"out_ring": 4},
}


def _variant(cfg_cls, qd, rq, kw):
    kw = dict(kw)
    if "qdisc" in kw:
        kw["qdisc"] = getattr(qd, kw["qdisc"])
    if "router_qdisc" in kw:
        kw["router_qdisc"] = getattr(rq, kw["router_qdisc"])
    return cfg_cls(num_hosts=4, **kw)


@pytest.mark.parametrize("lossless", [False, True])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_static_preconditions_match_reference(variant, lossless):
    jfn = jtcp_bulk.make_tcp_bulk_fn(
        _variant(JConfig, JQDisc, JRouterQ, VARIANTS[variant]),
        jrelay.TCP_BULK, lossless=lossless)
    tfn = ttcp_bulk.make_tcp_bulk_fn(
        _variant(TConfig, TQDisc, TRouterQ, VARIANTS[variant]),
        trelay.TCP_BULK, lossless=lossless)
    assert (jfn is None) == (tfn is None)


# ---- the relay's bulk contract on seeded app states ---------------------

def _app_states(seed, n=64, S=4):
    rng = np.random.default_rng(seed)
    role = rng.integers(0, 4, n).astype(np.int32)
    lsock = np.where(role >= 2, rng.integers(-1, S, n), -1).astype(np.int64)
    return {
        "role": role,
        "lsock": lsock,
        "up_conn": rng.integers(-1, S, n).astype(np.int32),
        "down_sock": rng.integers(-1, S, n).astype(np.int64),
        "next_ip": rng.integers(0, 2**32, n).astype(np.int64),
        "connected": rng.random(n) < 0.7,
        "to_send": np.where(rng.random(n) < 0.5, 0,
                            rng.integers(1, 10**6, n)).astype(np.int32),
        "fwd_pending": np.where(rng.random(n) < 0.6, 0,
                                rng.integers(1, 10**5, n)).astype(np.int32),
        "up_eof": rng.random(n) < 0.3,
        "closed_down": rng.random(n) < 0.4,
        "rcvd": rng.integers(0, 10**6, n).astype(np.int64),
        "done_at": np.where(rng.random(n) < 0.5, -1,
                            rng.integers(0, 10**10, n)).astype(np.int64),
    }, rng.integers(0, 11, (n, S)).astype(np.int32), rng


def _both_apps(fields):
    japp = jrelay.RelayApp(**{k: jnp.asarray(v) for k, v in fields.items()})
    tapp = trelay.RelayApp(**{k: torch.as_tensor(v)
                              for k, v in fields.items()})
    return japp, tapp


def _eq(j, t):
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


def _eq_app(japp, tapp):
    for k in trelay.RelayApp.__dataclass_fields__:
        _eq(getattr(japp, k), getattr(tapp, k))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_relay_bulk_contract_matches_reference(seed):
    fields, st, rng = _app_states(seed)
    japp, tapp = _both_apps(fields)
    n, S = st.shape
    jsim = types.SimpleNamespace(app=japp, tcp=types.SimpleNamespace(
        st=jnp.asarray(st)))
    tsim = types.SimpleNamespace(app=tapp, tcp=types.SimpleNamespace(
        st=torch.as_tensor(st)))
    _eq(jrelay.TCP_BULK.precheck(None, jsim),
        trelay.TCP_BULK.precheck(None, tsim))

    mask = rng.random(n) < 0.6
    slot = np.where(rng.random(n) < 0.7, fields["up_conn"],
                    rng.integers(0, S, n)).astype(np.int32)
    nread = rng.integers(0, 2 << 20, n).astype(np.int32)
    now = rng.integers(0, 10**10, n).astype(np.int64)
    j_out = jrelay.TCP_BULK.on_data(None, japp, jnp.asarray(mask),
                                    jnp.asarray(slot), jnp.asarray(nread),
                                    jnp.asarray(now))
    t_out = trelay.TCP_BULK.on_data(None, tapp, torch.as_tensor(mask),
                                    torch.as_tensor(slot),
                                    torch.as_tensor(nread),
                                    torch.as_tensor(now))
    _eq_app(j_out[0], t_out[0])
    for a, b in zip(j_out[1:], t_out[1:]):
        _eq(a, b)

    j_out = jrelay.TCP_BULK.on_eof(None, japp, jnp.asarray(mask),
                                   jnp.asarray(slot), jnp.asarray(now))
    t_out = trelay.TCP_BULK.on_eof(None, tapp, torch.as_tensor(mask),
                                   torch.as_tensor(slot),
                                   torch.as_tensor(now))
    _eq_app(j_out[0], t_out[0])
    for a, b in zip(j_out[1:], t_out[1:]):
        _eq(a, b)
