"""Parity of the port's causality recorder (telemetry/causality.py) with
the reference's, on the CPU, tolerance zero:

- a serial UDP program (PHOLD at 64 hosts, 8 of them active, no bulk
  pass, the sparse fast path armed at 16 lanes so the lineage parent
  keys hash the compacted rows' global ids) with the ring and both
  recorders: every leaf — lineage sub-rings, advance plane, flow ring —
  equal to the reference's whole-run program, and make_chunk_body at
  K = 1 and K = 16 equal to it;
- the harvested lineage and advance records, critical_chains,
  binding_histogram, binding_edges, the lineage traffic matrix and the
  manifest block equal to the reference's;
- lineage_update on a saturated sub-ring (capacity 2, period 1) and
  advance_latch through a wrap, against the reference's on the same
  inputs, and the harvester's per-host overrun accounting.

One reference program is compiled for the file.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu import telemetry as jtelemetry
from shadow_tpu.apps import phold as jphold
from shadow_tpu.core import events as jevents
from shadow_tpu.net import build as jbuild
from shadow_tpu.telemetry import causality as jcaus
from shadow_tpu_torch import convert
from shadow_tpu_torch import telemetry as ttelemetry
from shadow_tpu_torch.apps import phold as tphold
from shadow_tpu_torch.core import events as tevents
from shadow_tpu_torch.net import build as tbuild
from shadow_tpu_torch.telemetry import causality as tcaus
from torch_parity import assert_leaves_equal, jax_leaves, packed

torch.set_num_threads(1)

KW = dict(H=64, load=2, lanes=False, replicas=False, sparse_lanes=16,
          active_hosts=8, flows=(4, 4096), causality=(2, 64))


@pytest.fixture(scope="module")
def runs():
    jb, tb = packed("jax", **KW), packed("port", **KW)
    jsim, jst = jbuild.make_runner(jb, app_handlers=(jphold.handler,))(
        jb.sim)
    tsim, tst = tbuild.make_runner(tb, app_handlers=(tphold.handler,),
                                   device="cpu")(tb.sim)
    return {"jax": (jsim, jst), "port": (tsim, tst), "bundle": tb}


def test_lineage_and_advance_planes_match_reference(runs):
    (jsim, jst), (tsim, tst) = runs["jax"], runs["port"]
    assert tst.as_dict() == {k: int(getattr(jst, k))
                             for k in tst.as_dict()}
    assert tst.fastpath_hit > 0
    assert_leaves_equal(jax_leaves(jsim), convert.sim_to_numpy(tsim))
    cz = tsim.causality
    assert int(cz.count.sum()) > 0
    assert int(cz.adv_count) == int(tst.windows)
    assert bool((cz.count <= cz.seen).all())


@pytest.mark.parametrize("K", [1, 16])
def test_chunk_body_matches_the_whole_run(runs, K):
    tb = runs["bundle"]
    sim, st = tbuild.make_chunked_runner(
        tb, app_handlers=(tphold.handler,), chunk_windows=K,
        device="cpu")(tb.sim)
    tsim, tst = runs["port"]
    assert st.as_dict() == tst.as_dict()
    assert_leaves_equal(convert.sim_to_numpy(tsim),
                        convert.sim_to_numpy(sim))


def test_host_side_blocks_match_reference(runs):
    jh, th = jtelemetry.Harvester(), ttelemetry.Harvester()
    jh.drain(runs["jax"][0])
    th.drain(runs["port"][0])
    assert [vars(r) for r in th.caus_records] \
        == [vars(r) for r in jh.caus_records]
    assert [vars(r) for r in th.adv_records] \
        == [vars(r) for r in jh.adv_records]
    assert max(r.key for r in th.caus_records) >= 1 << 63   # unsigned
    recs_t, recs_j = th.caus_records, jh.caus_records
    chains = tcaus.critical_chains(recs_t, top_k=5)
    assert chains == jcaus.critical_chains(recs_j, top_k=5)
    assert chains and chains[0]["length"] >= 2
    assert tcaus.binding_histogram(th.adv_records) \
        == jcaus.binding_histogram(jh.adv_records)
    assert tcaus.binding_edges(th.adv_records) \
        == jcaus.binding_edges(jh.adv_records)
    for S in (1, 2):
        assert tcaus.lineage_traffic_matrix(recs_t, num_hosts=64,
                                            path_shards=S) \
            == jcaus.lineage_traffic_matrix(recs_j, num_hosts=64,
                                            path_shards=S)
        assert tcaus.causality_manifest_block(
            th, num_hosts=64, sample_period=2, path_shards=S) \
            == jcaus.causality_manifest_block(
                jh, num_hosts=64, sample_period=2, path_shards=S)
    assert th.summary() == jh.summary()


class _Sim(SimpleNamespace):
    def replace(self, **kw):
        return _Sim(**{**vars(self), **kw})


def _lineage_inputs(rng, H=8, E=3, F=2):
    """Random pre-apply states: popped events, an emission buffer with
    holes, per-host next_seq, and sub-rings already past a wrap."""
    return dict(
        valid=rng.random(H) < 0.7,
        time=rng.integers(0, 10**9, H).astype(np.int64),
        src=rng.integers(-1, H, H).astype(np.int32),
        seq=rng.integers(-2**31, 2**31 - 1, H).astype(np.int32),
        dst=np.where(rng.random((H, E)) < 0.6,
                     rng.integers(0, H, (H, E)), -1).astype(np.int32),
        btime=rng.integers(0, 10**9, (H, E)).astype(np.int64),
        kind=rng.integers(0, 20, (H, E)).astype(np.int32),
        next_seq=rng.integers(0, 50, H).astype(np.int32),
        count=rng.integers(0, 7, H).astype(np.int64), F=F)


def _run_lineage(pkg, x, lane_id):
    H, E = x["dst"].shape
    jax_side = pkg == "jax"
    ev, cm = (jevents, jcaus) if jax_side else (tevents, tcaus)
    as_ = jnp.asarray if jax_side else torch.as_tensor
    dev = {} if jax_side else {"device": "cpu"}
    popped = ev.Popped(valid=as_(x["valid"]), time=as_(x["time"]),
                       kind=as_(np.zeros(H, np.int32)), src=as_(x["src"]),
                       seq=as_(x["seq"]),
                       words=as_(np.zeros((H, 6), np.int32)))
    cz = cm.CausalityState.create(H, x["F"], 1, 4, **dev)
    buf = ev.EmitBuffer.create(H, E, nwords=6, **dev)
    buf = buf.replace(dst=as_(x["dst"]), time=as_(x["btime"]),
                      kind=as_(x["kind"]))
    cz = cz.replace(count=as_(x["count"]), seen=as_(x["count"] * 2),
                    execs=as_(x["count"] + 3))
    sim = _Sim(causality=cz, events=_Sim(next_seq=as_(x["next_seq"])))
    lane = None if lane_id is None else as_(lane_id)
    out = cm.lineage_update(sim, popped, buf, lane).causality
    return {n: np.asarray(getattr(out, n)) for n, _ in cm.LINEAGE_PLANES
            + (("count", 0), ("seen", 0), ("execs", 0))}


@pytest.mark.parametrize("lanes", ["rows", "ids"])
def test_lineage_update_on_a_saturated_ring_matches_reference(lanes):
    rng = np.random.default_rng(11)
    x = _lineage_inputs(rng)
    lane_id = (None if lanes == "rows"
               else np.arange(100, 108, dtype=np.int32))
    want = _run_lineage("jax", x, lane_id)
    got = _run_lineage("port", x, lane_id)
    for n in want:
        w = want[n]
        g = got[n].view(np.uint64) if n in tcaus.U64_PLANES else got[n]
        assert g.dtype == w.dtype, n
        np.testing.assert_array_equal(g, w, err_msg=n)
    assert (got["count"] - x["count"]).max() > x["F"]   # wrapped


def test_advance_latch_and_overrun_accounting_match_reference():
    """Six latches into a 4-slot plane (a wrap), then the harvesters'
    lineage and advance drains of the same planes."""
    tz = tcaus.CausalityState.create(4, 2, 1, 4, device="cpu")
    jz = jcaus.CausalityState.create(4, 2, 1, 4)
    ts, js = _Sim(causality=tz), _Sim(causality=jz)
    for i in range(6):
        args = (i * 10, i * 10 + 7, i % 5, i - 1, i - 2, 50 + i)
        ts = tcaus.advance_latch(ts, *args, torch.tensor(i, dtype=torch.int32))
        js = jcaus.advance_latch(js, *args, jnp.asarray(i, jnp.int32))
    for n, _ in tcaus.ADVANCE_PLANES + (("adv_count", 0),):
        np.testing.assert_array_equal(
            getattr(ts.causality, n).numpy(),
            np.asarray(getattr(js.causality, n)), err_msg=n)
    counts = np.array([0, 1, 5, 9], np.int64)
    keys = np.arange(8, dtype=np.int64).reshape(4, 2) - 3
    ts = ts.replace(causality=ts.causality.replace(
        count=torch.as_tensor(counts), key=torch.as_tensor(keys)))
    js = js.replace(causality=js.causality.replace(
        count=jnp.asarray(counts), key=jnp.asarray(keys.view(np.uint64))))
    th, jh = ttelemetry.Harvester(), jtelemetry.Harvester()
    th._drain_causality(ts)
    jh._drain_causality(js)
    assert [vars(r) for r in th.caus_records] \
        == [vars(r) for r in jh.caus_records]
    assert [vars(r) for r in th.adv_records] \
        == [vars(r) for r in jh.adv_records]
    assert (th.caus_lost, th.adv_lost) == (jh.caus_lost, jh.adv_lost) \
        == (10, 2)


def test_state_validates_its_knobs():
    for kw in ({"capacity": 0}, {"sample_period": 0}, {"adv_capacity": 0}):
        with pytest.raises(ValueError):
            tcaus.CausalityState.create(4, device="cpu", **kw)
