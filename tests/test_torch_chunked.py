"""Parity of the port's window rules and chunked dispatch with the
reference, on the CPU:

- core.engine.make_wend_fn, static and adaptive, and its .explain,
  against the reference's on the same boot state (fault record times
  passed in directly, end clamps, raised and downed table entries, a
  table_fn);
- core.engine.run's start_time and fault_times against the reference's
  engine.run;
- net.build.make_chunked_runner at K = 1, 3 and 8 leaf-equal to
  make_runner and to the reference's make_runner and
  make_chunked_runner (PHOLD with the bulk pass and the ring);
- utils.checkpoint.run_windows on a one-rank mesh at K = 1 and 8;
- warm serving (compile/serve.py) on the chunked runner and
  run_windows: a store miss, a hit and a cold run, each equal to the
  reference's;
- utils.checkpoint.run_windows at K = 1 and K = 8, and the adaptive
  rule on a uniform graph equal to the static partition
  (tests/test_chunked.py's contract); on_chunk window counts summing to
  stats.windows;
- the caller's sim left unchanged by every runner.

Three reference programs are compiled for the file. Tolerance zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu import telemetry as jtelemetry
from shadow_tpu.apps import phold as jphold
from shadow_tpu.core import engine as jengine
from shadow_tpu.core import simtime
from shadow_tpu.net import build as jbuild
from shadow_tpu.net.state import NetConfig as JConfig
from shadow_tpu.net.step import make_step_fn as jmake_step_fn
from shadow_tpu_torch import convert
from shadow_tpu_torch import faults as tfaults
from shadow_tpu_torch import telemetry as ttelemetry
from shadow_tpu_torch.apps import phold as tphold
from shadow_tpu_torch.bench import MIX_VERTICES, ONE_VERTEX
from shadow_tpu_torch.core import engine as tengine
from shadow_tpu_torch.net import build as tbuild
from shadow_tpu_torch.net.state import NetConfig as TConfig
from shadow_tpu_torch.net.step import make_step_fn as tmake_step_fn
from shadow_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(1)

SEC = simtime.ONE_SECOND
H, LOAD, SEED = 16, 4, 7


def _cfg(end, seed=SEED):
    cap = max(32, 4 * LOAD)
    return dict(num_hosts=H, tcp=False, end_time=end, seed=seed,
                event_capacity=cap, outbox_capacity=cap, router_ring=cap,
                in_ring=max(8, 2 * LOAD))


def _bundle(pkg, graph=ONE_VERTEX, end=SEC, ring=False):
    if pkg == "jax":
        hosts = [jbuild.HostSpec(name=f"p{i}", proc_start_time=0)
                 for i in range(H)]
        b = jbuild.build(JConfig(**_cfg(end)), graph, hosts)
        b.sim = jphold.setup(b.sim, load=LOAD)
        if ring:
            b.sim = jtelemetry.attach(b.sim)
        return b
    hosts = [tbuild.HostSpec(name=f"p{i}", proc_start_time=0)
             for i in range(H)]
    b = tbuild.build(TConfig(**_cfg(end)), graph, hosts, device="cpu")
    b.sim = tphold.setup(b.sim, load=LOAD)
    if ring:
        b.sim = ttelemetry.attach(b.sim)
    return b


def _jax_leaves(sim):
    flat, _ = jax.tree_util.tree_flatten_with_path(sim)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _assert_leaves_equal(want, got):
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, (k, want[k].dtype, got[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _ints(t):
    return tuple(int(x) for x in t)


# ------------------------------------------------------------ wend rules


@pytest.fixture(scope="module")
def mix():
    return _bundle("jax", MIX_VERTICES), _bundle("port", MIX_VERTICES)


def test_adaptive_jump_spec_matches_reference(mix):
    jb, tb = mix
    assert tb.min_jump == jb.min_jump
    jm, jft = jbuild.adaptive_jump_spec(jb)
    tm, tft = tbuild.adaptive_jump_spec(tb)
    np.testing.assert_array_equal(tm, jm)
    assert jft is None and tft is None
    assert tbuild.plan_times(tb) is None


WSTARTS = (0, 1_234_567, 49_999_999, SEC - 10)
STATIC_CASES = {
    "plain": dict(end=SEC),
    "records": dict(end=SEC, fault_times=[700_000, 50_000_000, 3_000_000,
                                          700_000]),
    "end_clamp": dict(end=1_500_000),
    "records_and_end": dict(end=40_000_000, fault_times=[2_000_000]),
}


@pytest.mark.parametrize("case", list(STATIC_CASES))
def test_static_wend_fn_matches_reference(mix, case):
    jb, tb = mix
    kw = STATIC_CASES[case]
    common = dict(min_jump=jb.min_jump, end_time=kw["end"],
                  fault_times=kw.get("fault_times"))
    jfn = jengine.make_wend_fn(**common)
    tfn = tengine.make_wend_fn(**common)
    for ws in WSTARTS:
        if ws > kw["end"]:
            continue
        want = _ints(jfn.explain(jb.sim, jnp.asarray(ws, jnp.int64)))
        assert tfn.explain(tb.sim, ws) == want, ws
        assert tfn(tb.sim, ws) == int(jfn(jb.sim, jnp.asarray(ws, jnp.int64)))
        assert want[0] == tfn(tb.sim, ws)


def _tables(sim, raise_=None, down=None):
    """(latency_ns, reliability) of `sim` as numpy, with `raise_`
    ({(a, b): +ns}) added and `down` pairs at reliability 0."""
    lat = np.array(sim.net.latency_ns).copy()
    rel = np.array(sim.net.reliability).copy()
    for (a, b), d in (raise_ or {}).items():
        lat[a, b] += d
        lat[b, a] += d
    for a, b in down or ():
        rel[a, b] = rel[b, a] = 0.0
    return lat, rel


ADAPTIVE_CASES = {
    "boot": {},
    "raised": dict(raise_={(0, 0): 4_000_000, (0, 1): 4_000_000,
                           (1, 1): 1_000_000}),
    "downed": dict(down=[(0, 0), (0, 1)]),
    "all_down": dict(down=[(a, b) for a in range(3) for b in range(3)]),
    "records": dict(raise_={(0, 0): 9_000_000}, fault_times=[5_000_000]),
    "end_clamp": dict(raise_={(0, 0): 9_000_000}, end=2_500_000),
    "table_fn": dict(table_fn=True, raise_={(0, 0): 3_000_000,
                                            (0, 1): 3_000_000}),
}


@pytest.mark.parametrize("case", list(ADAPTIVE_CASES))
def test_adaptive_wend_fn_matches_reference(mix, case):
    jb, tb = mix
    kw = ADAPTIVE_CASES[case]
    mask, _ = jbuild.adaptive_jump_spec(jb)
    lat, rel = _tables(jb.sim, kw.get("raise_"), kw.get("down"))
    jsim = jb.sim.replace(net=jb.sim.net.replace(
        latency_ns=jnp.asarray(lat), reliability=jnp.asarray(rel)))
    tsim = tb.sim.replace(net=tb.sim.net.replace(
        latency_ns=torch.as_tensor(lat), reliability=torch.as_tensor(rel)))
    common = dict(min_jump=jb.min_jump, end_time=kw.get("end", SEC),
                  pair_mask=mask, fault_times=kw.get("fault_times"))
    jtf = ttf = None
    if kw.get("table_fn"):
        # tables replayed at wstart + 1, not read from the sim
        jsim, tsim = jb.sim, tb.sim
        seen = []

        def jtf(t):
            seen.append(int(t))
            return jnp.asarray(lat), jnp.asarray(rel)

        def ttf(t):
            seen.append(int(t))
            return torch.as_tensor(lat), torch.as_tensor(rel)
    jfn = jengine.make_wend_fn(table_fn=jtf, **common)
    tfn = tengine.make_wend_fn(table_fn=ttf, **common)
    for ws in WSTARTS:
        if ws > common["end_time"]:
            continue
        want = _ints(jfn.explain(jsim, jnp.asarray(ws, jnp.int64)))
        assert tfn.explain(tsim, ws) == want, (ws, want)
        assert tfn(tsim, ws) == int(jfn(jsim, jnp.asarray(ws, jnp.int64)))
    if kw.get("table_fn"):
        assert seen and all(t - 1 in WSTARTS for t in seen)


def test_wend_fn_refuses_a_non_positive_jump():
    with pytest.raises(ValueError, match="positive"):
        tengine.make_wend_fn(min_jump=0, end_time=SEC)


# ------------------------------------------------------- whole-run rules

RUN_START, RUN_RECORDS = 120_000_000, [130_000_000, 200_000_001, 777_000_000]


@pytest.fixture(scope="module")
def run_args():
    """The reference's engine.run with start_time and fault_times."""
    jb = _bundle("jax")
    step = jmake_step_fn(jb.cfg, (jphold.handler,))
    sim, stats = jengine.run(
        jb.sim, step, end_time=jb.cfg.end_time, min_jump=jb.min_jump,
        start_time=RUN_START, emit_capacity=jb.cfg.emit_capacity,
        lane_id=jb.sim.net.lane_id, fault_times=RUN_RECORDS)
    return _jax_leaves(sim), stats.as_dict()


def test_run_start_time_and_fault_times_match_reference(run_args):
    want, want_stats = run_args
    tb = _bundle("port")
    step = tmake_step_fn(tb.cfg, (tphold.handler,))
    sim, stats = tengine.run(
        tb.sim, step, end_time=tb.cfg.end_time, min_jump=tb.min_jump,
        start_time=RUN_START, emit_capacity=tb.cfg.emit_capacity,
        lane_id=tb.sim.net.lane_id, fault_times=RUN_RECORDS)
    assert stats.as_dict() == want_stats
    _assert_leaves_equal(want, convert.sim_to_numpy(sim))


# --------------------------------------------------------- chunked runs


@pytest.fixture(scope="module")
def ref_runs():
    """The reference's make_runner and make_chunked_runner (K = 3) on
    PHOLD with the bulk pass and the ring."""
    out = {}
    for name, factory, kw in (
            ("whole", jbuild.make_runner, {}),
            ("chunked", jbuild.make_chunked_runner, {"chunk_windows": 3})):
        jb = _bundle("jax", ring=True)
        sim, stats = factory(jb, app_handlers=(jphold.handler,),
                             app_bulk=jphold.BULK, **kw)(jb.sim)
        out[name] = (_jax_leaves(sim), stats.as_dict())
    return out


def test_reference_chunked_equals_whole(ref_runs):
    _assert_leaves_equal(*[ref_runs[k][0] for k in ("whole", "chunked")])
    assert ref_runs["whole"][1] == ref_runs["chunked"][1]


def _port_run(runner_of, ring=True):
    """(leaves, stats) of one port run, checking the caller's sim is
    left as it was."""
    tb = _bundle("port", ring=ring)
    before = convert.sim_to_numpy(tb.sim)
    sim, stats = runner_of(tb)(tb.sim)
    _assert_leaves_equal(before, convert.sim_to_numpy(tb.sim))
    return convert.sim_to_numpy(sim), stats.as_dict()


@pytest.mark.parametrize("k", [1, 3, 8])
def test_chunked_runner_matches_reference(ref_runs, k):
    leaves, stats = _port_run(lambda b: tbuild.make_chunked_runner(
        b, app_handlers=(tphold.handler,), app_bulk=tphold.BULK,
        chunk_windows=k, device="cpu"))
    want, want_stats = ref_runs["whole"]
    assert stats == want_stats
    _assert_leaves_equal(want, leaves)


def test_make_runner_matches_reference(ref_runs):
    leaves, stats = _port_run(lambda b: tbuild.make_runner(
        b, app_handlers=(tphold.handler,), app_bulk=tphold.BULK,
        device="cpu"))
    assert stats == ref_runs["whole"][1]
    _assert_leaves_equal(ref_runs["whole"][0], leaves)


def test_chunked_adaptive_on_uniform_graph_is_static(ref_runs):
    leaves, stats = _port_run(lambda b: tbuild.make_chunked_runner(
        b, app_handlers=(tphold.handler,), app_bulk=tphold.BULK,
        chunk_windows=4, adaptive_jump=True, device="cpu"))
    assert stats == ref_runs["whole"][1]
    _assert_leaves_equal(ref_runs["whole"][0], leaves)


def _run_windows(ring=True, **kw):
    tb = _bundle("port", ring=ring)
    tb.app_bulk = tphold.BULK
    before = convert.sim_to_numpy(tb.sim)
    sim, stats, saved = tckpt.run_windows(
        tb, app_handlers=(tphold.handler,), device="cpu", **kw)
    _assert_leaves_equal(before, convert.sim_to_numpy(tb.sim))
    assert saved == []
    return convert.sim_to_numpy(sim), stats.as_dict()


@pytest.mark.parametrize("kw", [{}, {"windows_per_dispatch": 8},
                                {"adaptive_jump": True},
                                {"windows_per_dispatch": 8,
                                 "adaptive_jump": True}],
                         ids=["k1", "k8", "k1_adaptive", "k8_adaptive"])
def test_run_windows_matches_reference(ref_runs, kw):
    leaves, stats = _run_windows(**kw)
    assert stats == ref_runs["whole"][1]
    _assert_leaves_equal(ref_runs["whole"][0], leaves)


# the leaves the reference gives per shard count (parallel/shard.py)
PER_SHARD_COUNT = (".outbox.narrow_hit", ".outbox.narrow_miss",
                   ".outbox.max_occupied", ".outbox.route_elided")


@pytest.mark.parametrize("k", [1, 8])
def test_run_windows_on_a_mesh(ref_runs, k):
    """run_windows(mesh=...), once refused, on a one-rank mesh (no
    process group: the sharded route and the scalar replication at one
    shard) at K = 1 and 8: every leaf but the four the reference gives
    per shard count equals the reference's run. The two-rank loop is
    held to the reference's sharded one in
    tests/test_torch_parallel_dispatch.py."""
    from shadow_tpu_torch.parallel import Mesh

    leaves, stats = _run_windows(mesh=Mesh(1, device="cpu"),
                                 windows_per_dispatch=k)
    want, want_stats = ref_runs["whole"]
    assert stats == want_stats
    _assert_leaves_equal({k_: v for k_, v in want.items()
                          if k_ not in PER_SHARD_COUNT},
                         {k_: v for k_, v in leaves.items()
                          if k_ not in PER_SHARD_COUNT})
    hit, miss = (int(leaves[f".outbox.narrow_{x}"]) for x in ("hit", "miss"))
    assert hit + miss == stats["windows"]


def test_on_chunk_window_counts_sum_to_total():
    per_dispatch, spans = [], []

    def on_chunk(sim, wstats, wstart, wend, next_min):
        per_dispatch.append(int(wstats.windows))
        spans.append((wstart, wend, next_min))

    tb = _bundle("port")
    _, st, _ = tckpt.run_windows(tb, app_handlers=(tphold.handler,),
                                 windows_per_dispatch=8, on_chunk=on_chunk,
                                 device="cpu")
    assert sum(per_dispatch) == int(st.windows)
    assert len(per_dispatch) < int(st.windows)
    assert max(per_dispatch) <= 8
    # each chunk starts where the last one's next start was
    for (_, _, nxt), (ws, _, _) in zip(spans, spans[1:]):
        assert ws == nxt


def test_on_round_sees_every_window_at_k1():
    rounds = []
    tb = _bundle("port")
    _, st, _ = tckpt.run_windows(
        tb, app_handlers=(tphold.handler,), device="cpu",
        on_round=lambda sim, s, ws, we, nm: rounds.append((ws, we, nm)))
    assert len(rounds) == int(st.windows)
    assert all(we - ws <= tb.min_jump for ws, we, _ in rounds)


def test_chunk_past_the_end_returns_its_carry():
    tb = _bundle("port")
    step = tmake_step_fn(tb.cfg, (tphold.handler,))
    chunk = tengine.make_chunk_body(
        step, end_time=SEC, chunk_windows=4,
        wend_fn=tengine.make_wend_fn(min_jump=tb.min_jump, end_time=SEC))
    stats = tengine.EngineStats.create()
    for ws in (SEC + 1, simtime.INVALID):
        sim, st, out = chunk(tb.sim, stats, ws)
        assert sim is tb.sim and st is stats and out == ws


def _counting_fault_fn():
    """A fault_fn that records each window end it is applied at."""
    def fault_fn(sim, wend):
        fault_fn.wends.append(int(wend))
        return sim
    fault_fn.wends = []
    return fault_fn


def test_chunked_runner_refusals(ref_runs, tmp_path, monkeypatch):
    tb = _bundle("port")
    with pytest.raises(ValueError, match="chunk_windows must be >= 1"):
        tbuild.make_chunked_runner(tb, chunk_windows=0, device="cpu")
    # warm_start and compile_info, once refused, run: on one program
    # store a miss, then a hit, then a cold run, each equal to the
    # reference's K = 3 run
    monkeypatch.setenv("SHADOW_AOT_DIR", str(tmp_path / "aot"))
    monkeypatch.delenv("SHADOW_WARM_PROGRAMS", raising=False)
    monkeypatch.delenv("SHADOW_NO_COMPILE_CACHE", raising=False)
    infos = []
    for warm in (True, True, False):
        wb = _bundle("port", ring=True)
        info = {}
        sim, st = tbuild.make_chunked_runner(
            wb, app_handlers=(tphold.handler,), app_bulk=tphold.BULK,
            chunk_windows=3, device="cpu", warm_start=warm,
            compile_info=info)(wb.sim)
        assert st.as_dict() == ref_runs["chunked"][1]
        _assert_leaves_equal(ref_runs["chunked"][0],
                             convert.sim_to_numpy(sim))
        infos.append(info)
    assert [i.get("hit") for i in infos] == [False, True, None]
    assert infos[0]["stored"] and infos[0]["key"] == infos[1]["key"]
    assert infos[2] == {"warm": False}
    # a fault_fn is accepted and applied at every window's end
    fn = _counting_fault_fn()
    _, st = tbuild.make_chunked_runner(
        tb, app_handlers=(tphold.handler,), chunk_windows=4, fault_fn=fn,
        device="cpu")(tb.sim)
    assert len(fn.wends) == int(st.windows) > 0
    assert fn.wends == sorted(fn.wends)
    # an installed plan's record times clamp both window rules
    tfaults.install(tb, [tfaults.FaultRecord(
        t_ns=1_234_567, kind=tfaults.FaultKind.LOSS, a=0, b=0, value=1)])
    for adaptive in (False, True):
        wend_fn = tbuild.resolve_wend_fn(tb, SEC, adaptive=adaptive)
        assert wend_fn(tb.sim, 0) == 1_234_567
        assert wend_fn(tb.sim, 1_234_567) == 1_234_567 + tb.min_jump


def test_run_windows_refusals(ref_runs, tmp_path, monkeypatch):
    tb = _bundle("port")
    # warm_start and compile_info, once refused, run: a miss, a hit and
    # a cold run on one key, each equal to the reference's whole run
    monkeypatch.setenv("SHADOW_AOT_DIR", str(tmp_path / "aot"))
    monkeypatch.delenv("SHADOW_WARM_PROGRAMS", raising=False)
    monkeypatch.delenv("SHADOW_NO_COMPILE_CACHE", raising=False)
    infos = []
    for warm in (True, True, False):
        info = {}
        leaves, stats = _run_windows(warm_start=warm, compile_info=info)
        assert stats == ref_runs["whole"][1]
        _assert_leaves_equal(ref_runs["whole"][0], leaves)
        infos.append(info)
    assert [i.get("hit") for i in infos] == [False, True, None]
    assert infos[0]["key"] == infos[1]["key"] == infos[2]["key"]
    assert infos[2]["warm"] is False
    # dispatch_wrap, once refused, wraps every dispatch the loop issues
    # (one a window at K = 1, as the reference's per-window loop) and
    # changes nothing: the run equals the reference's
    calls = []

    def wrap(fn):
        def dispatch(*a, **k):
            calls.append(a[1])
            return fn(*a, **k)
        return dispatch

    leaves, stats = _run_windows(dispatch_wrap=wrap)
    assert stats == ref_runs["whole"][1]
    assert len(calls) == stats["windows"] and calls == sorted(calls)
    _assert_leaves_equal(ref_runs["whole"][0], leaves)
    # a feeder is taken (tests/test_torch_inject.py runs it), but only
    # into a sim with staging lanes, as in the reference
    from shadow_tpu_torch.inject import Feeder

    with pytest.raises(ValueError, match="inject_lanes"):
        tckpt.run_windows(tb, device="cpu", feeder=Feeder([]))
    with pytest.raises(ValueError, match="windows_per_dispatch"):
        tckpt.run_windows(tb, device="cpu", windows_per_dispatch=0)
    # a fault_fn is accepted and applied at every window's end, on the
    # per-window and the chunked path
    for k in (1, 4):
        fn = _counting_fault_fn()
        _, st, _ = tckpt.run_windows(tb, (tphold.handler,), device="cpu",
                                     windows_per_dispatch=k, fault_fn=fn)
        assert len(fn.wends) == int(st.windows) > 0


def test_chunked_runner_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("checks the behavior without a CUDA device")
    tb = _bundle("port")
    with pytest.raises(RuntimeError, match="CUDA"):
        tbuild.make_chunked_runner(tb)
    with pytest.raises(RuntimeError, match="CUDA"):
        tckpt.run_windows(tb)
