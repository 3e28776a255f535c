"""Parity of the port's bulk window pass (shadow_tpu_torch/net/bulk.py,
apps/phold.py PholdBulk) and telemetry ring with the reference.

- make_order, rank_in_order and suffix_sum in both order forms against
  the reference's functions in both forms, on seeded [H, K] inputs with
  time ties, duplicate (time, tie) pairs, INVALID slots and masked
  weights.
- A whole PHOLD run at 32 hosts (load 4, 1 sim-s) with the bulk pass
  and the telemetry ring on, every host's rng_ctr started just below
  2**32 so the uint32 counters wrap mid-run: EngineStats and every
  state leaf, .telem.* included, equal the reference's. The port runs
  it in both order forms against one reference run in its CPU form
  ("sort"; tests/test_bulk.py holds the reference's two forms equal).
- The throttled fallback (64 KiB/s links: token budgets fail
  eligibility, so the serial path runs; slower links only add CPU
  micro-steps) and the too-small rcvbuf case (datagrams dropped as
  buffer-full: rcv_fit fails), each against the reference.
- make_bulk_fn returns None on exactly the reference's static
  preconditions.

The three reference runs share one compiled runner (same shapes; the
configs differ only in state data). Tolerance: zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu import telemetry as jtel
from shadow_tpu.apps import phold as jphold
from shadow_tpu.core import simtime
from shadow_tpu.net import build as jbuild
from shadow_tpu.net import bulk as jbulk
from shadow_tpu.net.state import NetConfig as JConfig
from shadow_tpu_torch import convert
from shadow_tpu_torch import telemetry as ttel
from shadow_tpu_torch.apps import phold as tphold
from shadow_tpu_torch.net import build as tbuild
from shadow_tpu_torch.net import bulk as tbulk
from shadow_tpu_torch.net.state import NetConfig as TConfig
from shadow_tpu_torch.net.state import QDisc, RouterQ

torch.set_num_threads(1)

GRAPH = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="latency" attr.type="double" for="edge" id="lat" />
  <key attr.name="bandwidthup" attr.type="int" for="node" id="up" />
  <key attr.name="bandwidthdown" attr.type="int" for="node" id="dn" />
  <graph edgedefault="undirected">
    <node id="v0"><data key="up">%(bw)d</data><data key="dn">%(bw)d</data>
    </node>
    <edge source="v0" target="v0"><data key="lat">50.0</data></edge>
  </graph>
</graphml>"""

H, CAP, RING = 32, 32, 64
# name -> (load, seed, link KiB/s, NetConfig overrides)
RUNS = {
    "main": (4, 5, 102400, {}),
    "throttled": (2, 3, 64, {}),
    "rcvbuf": (2, 11, 102400, {"rcvbuf": 32}),   # < MSG_SIZE = 64
}
# main run: counters start just below 2**32 and wrap mid-run
CTR0 = (2**32 - 1 - 3 * np.arange(H)).astype(np.uint32)


def _cfg_kw(name):
    load, seed, _, extra = RUNS[name]
    return dict(num_hosts=H, tcp=False, seed=seed,
                end_time=simtime.ONE_SECOND, event_capacity=CAP,
                outbox_capacity=CAP, router_ring=CAP, in_ring=8, **extra)


def _jax_sim(name):
    load, _, bw, _ = RUNS[name]
    hosts = [jbuild.HostSpec(name=f"p{i}", proc_start_time=0)
             for i in range(H)]
    b = jbuild.build(JConfig(**_cfg_kw(name)), GRAPH % {"bw": bw}, hosts)
    sim = jtel.attach(jphold.setup(b.sim, load=load), capacity=RING)
    if name == "main":
        sim = sim.replace(net=sim.net.replace(
            rng_ctr=jnp.asarray(CTR0, jnp.uint32)))
    b.sim = sim
    return b


def _port_run(name):
    load, _, bw, _ = RUNS[name]
    hosts = [tbuild.HostSpec(name=f"p{i}", proc_start_time=0)
             for i in range(H)]
    b = tbuild.build(TConfig(**_cfg_kw(name)), GRAPH % {"bw": bw}, hosts,
                     device="cpu")
    sim = ttel.attach(tphold.setup(b.sim, load=load), capacity=RING)
    if name == "main":
        sim = sim.replace(net=sim.net.replace(
            rng_ctr=torch.as_tensor(CTR0.astype(np.int64))))
    sim, stats = tbuild.make_runner(
        b, app_handlers=(tphold.handler,), app_bulk=tphold.BULK,
        device="cpu")(sim)
    return stats.as_dict(), sim


def _jax_leaves(sim):
    flat, _ = jax.tree_util.tree_flatten_with_path(sim)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _assert_leaves_equal(want, got):
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, (k, want[k].dtype, got[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def jax_runs():
    bundles = {name: _jax_sim(name) for name in RUNS}
    runner = jbuild.make_runner(bundles["main"],
                                app_handlers=(jphold.handler,),
                                app_bulk=jphold.BULK)
    out = {}
    for name, b in bundles.items():
        sim, stats = runner(b.sim)
        out[name] = (stats.as_dict(), _jax_leaves(sim))
    return out


@pytest.fixture(scope="module", params=["sort", "cube"])
def port_main(request):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbulk, "_default_impl",
                   lambda H, K, device: request.param)
        return _port_run("main")


def test_bulk_run_stats_match_reference(jax_runs, port_main):
    assert port_main[0] == jax_runs["main"][0]


def test_bulk_run_every_leaf_matches_reference(jax_runs, port_main):
    _assert_leaves_equal(jax_runs["main"][1],
                         convert.sim_to_numpy(port_main[1]))


def test_bulk_run_engages_and_wraps_counters(port_main):
    stats, sim = port_main
    # nearly every event went through the bulk pass, not micro-steps
    assert stats["micro_steps"] < stats["windows"]
    assert stats["events_processed"] > H * 4 * 10
    assert int(sim.events.overflow) == 0 and int(sim.outbox.overflow) == 0
    # every host's draw counter passed 2**32 - 1 and wrapped
    assert (sim.net.rng_ctr < torch.as_tensor(CTR0.astype(np.int64))).all()
    assert int(sim.telem.count) == stats["windows"]
    assert int(sim.telem.events.sum()) == stats["events_processed"]


@pytest.mark.parametrize("name", ["throttled", "rcvbuf"])
def test_fallback_matches_reference(jax_runs, name):
    stats, sim = _port_run(name)
    want_stats, want = jax_runs[name]
    assert stats == want_stats
    _assert_leaves_equal(want, convert.sim_to_numpy(sim))
    if name == "throttled":
        # token budgets failed eligibility: the serial path ran
        assert stats["micro_steps"] > stats["windows"]
    else:
        assert int(sim.net.ctr_drop_bufferfull.sum()) > 0


def _order_inputs(seed, Hs=6, K=12):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, (Hs, K)).astype(np.int64) * 1000
    t[rng.random((Hs, K)) < 0.3] = simtime.INVALID
    src = rng.integers(0, 3, (Hs, K)).astype(np.int64)
    seq = rng.integers(0, 3, (Hs, K)).astype(np.int64)
    tie = (src << 32) | seq
    weight = rng.random((Hs, K)) < 0.6
    value = np.where(rng.random((Hs, K)) < 0.7,
                     rng.integers(0, 2000, (Hs, K)), 0).astype(np.int64)
    return t, tie, weight, value


@pytest.mark.parametrize("port_form", ["sort", "cube"])
@pytest.mark.parametrize("seed", [0, 1])
def test_order_helpers_match_reference(port_form, seed):
    t, tie, weight, value = _order_inputs(seed)
    po = tbulk.make_order(torch.as_tensor(t), torch.as_tensor(tie),
                          impl=port_form)
    rank = tbulk.rank_in_order(po, torch.as_tensor(weight)).numpy()
    suff = tbulk.suffix_sum(po, torch.as_tensor(value)).numpy()
    assert rank.dtype == np.int32 and suff.dtype == np.int64
    for jax_form in ("sort", "cube"):
        jo = jbulk.make_order(jnp.asarray(t), jnp.asarray(tie),
                              impl=jax_form)
        np.testing.assert_array_equal(
            rank, np.asarray(jbulk.rank_in_order(jo, jnp.asarray(weight))))
        np.testing.assert_array_equal(
            suff, np.asarray(jbulk.suffix_sum(jo, jnp.asarray(value))))
        if jax_form == port_form == "sort":
            np.testing.assert_array_equal(po.perm.numpy(), np.asarray(jo.perm))
            np.testing.assert_array_equal(po.inv.numpy(), np.asarray(jo.inv))
        if jax_form == port_form == "cube":
            np.testing.assert_array_equal(po.prec.numpy(), np.asarray(jo.prec))


class _LongReplies(tphold.PholdBulk):
    max_send_len = 1500   # + UDP header > MTU


PRECONDITIONS = {
    "udp": {},
    "tcp": dict(tcp=True),
    "rr_qdisc": dict(qdisc=QDisc.RR),
    "router_single": dict(router_qdisc=RouterQ.SINGLE),
    "pcap": dict(pcap=True),
    "track_paths": dict(track_paths=True),
    "out_ring": dict(out_ring=1),
    "small_outbox": dict(outbox_capacity=8, event_capacity=32),
    "cpu_model": dict(cpu_threshold_ns=0),
    "long_replies": {},
}


@pytest.mark.parametrize("case", sorted(PRECONDITIONS))
def test_bulk_static_preconditions(case):
    kw = {"num_hosts": 4, "tcp": False, **PRECONDITIONS[case]}
    jb, tb = jphold.BULK, tphold.BULK
    if case == "long_replies":
        jb = type("JLong", (jphold.PholdBulk,), {"max_send_len": 1500})()
        tb = _LongReplies()
    want = jbulk.make_bulk_fn(JConfig(**kw), jb) is None
    assert (tbulk.make_bulk_fn(TConfig(**kw), tb) is None) == want
    assert want == (case != "udp")


def test_make_runner_skips_bulk_when_preconditions_fail():
    cfg = TConfig(**{**_cfg_kw("main"), "outbox_capacity": CAP // 2})
    b = tbuild.build(cfg, GRAPH % {"bw": 102400},
                     [tbuild.HostSpec(name=f"p{i}") for i in range(H)],
                     device="cpu")
    assert tbuild._resolve_bulk_fn(b, tphold.BULK) is None
    assert tbuild._resolve_bulk_fn(b, None) is None
