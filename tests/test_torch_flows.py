"""Parity of the port's flow flight-recorder (telemetry/flows.py) with
the reference's, on the CPU, tolerance zero:

- sample_hash and the sampling remainder on edge values (int32 -1,
  INVALID time, extreme seqs) for periods 1, 3, 7, 64 and 1,000;
- the bulk path: bench's packed PHOLD (4 lanes x 4 hosts, ring, flow
  and causality recorders) leaf-equal to the reference's run;
- the serial path: every window's flow_fn call of a port run held to
  the reference's flow_fn on the same state, through a saturated ring
  (capacity 8, period 1: wraps and window clamps);
- the sharded merge (make_flow_fn(axis), two gloo ranks) against the
  reference's under shard_map on 2 devices;
- recorders off byte-identical to no recorders;
- the harvested records, histograms, per-lane latency, traffic matrix
  and manifest block equal to the reference's.

One reference program is compiled for the file.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu import telemetry as jtelemetry
from shadow_tpu.apps import phold as jphold
from shadow_tpu.net import build as jbuild
from shadow_tpu.telemetry import flows as jflows
from shadow_tpu_torch import convert
from shadow_tpu_torch import telemetry as ttelemetry
from shadow_tpu_torch.apps import phold as tphold
from shadow_tpu_torch.core import engine as tengine
from shadow_tpu_torch.core import simtime
from shadow_tpu_torch.net import build as tbuild
from shadow_tpu_torch.net.step import make_step_fn
from shadow_tpu_torch.telemetry import flows as tflows
from torch_parity import (
    assert_leaves_equal,
    jax_leaves,
    packed,
    to_jax,
)

torch.set_num_threads(1)

SEC = simtime.ONE_SECOND
REC = dict(flows=(3, 4096), causality=(2, 64))


@pytest.fixture(scope="module")
def runs():
    jb, tb = packed("jax", **REC), packed("port", **REC)
    jsim, jst = jbuild.make_runner(jb, app_handlers=(jphold.handler,),
                                   app_bulk=jphold.BULK)(jb.sim)
    tsim, tst = tbuild.make_runner(tb, app_handlers=(tphold.handler,),
                                   app_bulk=tphold.BULK,
                                   device="cpu")(tb.sim)
    return {"jax": (jsim, jst), "port": (tsim, tst)}


# ------------------------------------------------------------- hashing

_I32 = (-1, 0, 1, 7, 2**31 - 1, -2**31)
_TIME = (0, 1, 50_000_000, 2**62, simtime.INVALID, -1)


def _edge_grid():
    g = np.array(np.meshgrid(_TIME, _I32, _I32, _I32, indexing="ij"),
                 dtype=object).reshape(4, -1)
    return (np.array(g[0], np.int64), np.array(g[1], np.int32),
            np.array(g[2], np.int32), np.array(g[3], np.int32))


@pytest.mark.parametrize("period", [1, 3, 7, 64, 1000])
def test_sample_hash_matches_reference_on_edge_values(period):
    t, d, s, q = _edge_grid()
    want = np.asarray(jflows.sample_hash(*map(jnp.asarray, (t, d, s, q))))
    got = tflows.sample_hash(*map(torch.as_tensor, (t, d, s, q)))
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    want_keep = np.asarray(jnp.asarray(want) % jnp.uint64(period)
                           == jnp.uint64(0))
    got_keep = (tflows.hash_mod(got, period) == 0).numpy()
    np.testing.assert_array_equal(got_keep, want_keep)
    np.testing.assert_array_equal(
        tflows.hash_mod(got, period).numpy(),
        np.asarray(jnp.asarray(want) % jnp.uint64(period)).astype(np.int64))


# ------------------------------------------------------------ the runs


def test_bulk_path_matches_reference(runs):
    jsim, jst = runs["jax"]
    tsim, tst = runs["port"]
    assert tst.as_dict() == {k: int(getattr(jst, k))
                             for k in tst.as_dict()}
    assert_leaves_equal(jax_leaves(jsim), convert.sim_to_numpy(tsim))
    assert int(tsim.flows.count) > 0
    assert int(tsim.flows.count + tsim.flows.lost) \
        == int(tsim.flows.sampled)


def test_recorders_off_are_byte_identical():
    """Attaching the recorders adds leaves and changes none."""
    out = []
    for rec in ({}, REC):
        b = packed("port", end=SEC // 2, **rec)
        sim, st = tbuild.make_runner(b, app_handlers=(tphold.handler,),
                                     app_bulk=tphold.BULK,
                                     device="cpu")(b.sim)
        out.append((convert.sim_to_numpy(sim), st.as_dict()))
    (plain, st0), (rec, st1) = out
    assert st0 == st1
    extra = set(rec) - set(plain)
    assert extra and all(k.startswith((".flows", ".causality"))
                         for k in extra)
    assert_leaves_equal(plain, rec, keys=sorted(plain))


def test_serial_windows_match_reference_flow_fn():
    """The port's serial path (no bulk pass), a saturated ring of 8 at
    period 1: each window's flow_fn call equal to the reference's
    flow_fn on the same pre-route state."""
    small = dict(flows=(1, 8))
    tb = packed("port", end=SEC // 4, **small)
    jtmpl = packed("jax", end=SEC // 4, **small).sim
    real = tflows.make_flow_fn()
    jfn = jflows.make_flow_fn()
    calls = []

    def flow_fn(sim, wstart, wend):
        out = real(sim, wstart, wend)
        want = jfn(to_jax(sim, jtmpl), wstart, wend)
        calls.append((jax_leaves(want.flows), convert.sim_to_numpy(out)))
        return out

    step = make_step_fn(tb.cfg, (tphold.handler,))
    sim, stats = tengine.run(
        tb.sim, step, end_time=tb.cfg.end_time, min_jump=tb.min_jump,
        emit_capacity=tb.cfg.emit_capacity, lane_id=tb.sim.net.lane_id,
        telem_fn=ttelemetry.make_telem_fn(), flow_fn=flow_fn)
    assert len(calls) == int(stats.windows) > 2
    for want, got in calls:
        got = {k[len(".flows"):]: v for k, v in got.items()
               if k.startswith(".flows")}
        assert_leaves_equal(want, got)
    ring = sim.flows
    assert int(ring.lost) > 0 and int(ring.count) > ring.capacity
    assert int(ring.count + ring.lost) == int(ring.sampled)


def test_sharded_merge_is_refused():
    """The sharded merge, once refused (make_flow_fn(axis)): two ranks
    (gloo) recording a seeded outbox of the 16-host program twice —
    per-rank offsets, the capacity clamp and a wrap — hold the ring to
    the reference's make_flow_fn("hosts") under shard_map on 2
    devices."""
    import jax
    from jax.sharding import Mesh as JMesh

    import torch_shard_ranks as R
    from shadow_tpu.parallel.shard import _shard_map, sim_specs
    from shadow_tpu_torch.parallel import spawn

    got = spawn(R.flow_merge_case, 2, deadline_s=120)[0]
    jb = packed("jax", lanes=False, ring=False, replicas=False,
                flows=R.FLOW_RING)
    planes = R.seeded_outbox(11, 16, jb.sim.outbox.dst.shape[1],
                             jb.sim.outbox.words.shape[-1], 2)
    jsim = jb.sim.replace(outbox=jb.sim.outbox.replace(
        **{k: jnp.asarray(v) for k, v in planes.items()}))
    fn = jflows.make_flow_fn("hosts")

    def body(s):
        for w0, w1 in R.FLOW_WINDOWS:
            s = fn(s, w0, w1)
        return s

    specs = sim_specs(jsim, "hosts")
    mesh = JMesh(np.array(jax.devices()[:2]), ("hosts",))
    out = jax.jit(_shard_map(body, mesh=mesh, in_specs=(specs,),
                             out_specs=specs, check_vma=False))(jsim)
    want = {".flows" + k: v for k, v in jax_leaves(out.flows).items()}
    assert int(want[".flows.lost"]) > 0
    assert int(want[".flows.count"]) > R.FLOW_RING[1]
    assert_leaves_equal(want, got)
    with pytest.raises(TypeError, match="Mesh"):
        tflows.make_flow_fn(axis="hosts")


def test_host_side_blocks_match_reference(runs):
    jh, th = jtelemetry.Harvester(), ttelemetry.Harvester()
    jh.drain(runs["jax"][0])
    th.drain(runs["port"][0])
    assert th.flow_records == [tflows.FlowRecord(**vars(r))
                               for r in jh.flow_records]
    assert (th.flow_sampled, th.flow_seen, th.flow_lost,
            th.flow_lost_clamp) == (jh.flow_sampled, jh.flow_seen,
                                    jh.flow_lost, jh.flow_lost_clamp)
    recs_t, recs_j = th.flow_records, jh.flow_records
    assert tflows.per_lane_latency(recs_t) == jflows.per_lane_latency(recs_j)
    for S in (1, 2, 4):
        assert tflows.latency_histograms(recs_t, num_hosts=16,
                                         path_shards=S) \
            == jflows.latency_histograms(recs_j, num_hosts=16,
                                         path_shards=S)
        assert tflows.traffic_matrix(recs_t, num_hosts=16, path_shards=S) \
            == jflows.traffic_matrix(recs_j, num_hosts=16, path_shards=S)
    assert tflows.flows_manifest_block(th, num_hosts=16, shards=1,
                                       sample_period=3) \
        == jflows.flows_manifest_block(jh, num_hosts=16, shards=1,
                                       sample_period=3)
    assert th.summary() == jh.summary()


def test_flow_ring_validates_its_knobs():
    for kw in ({"capacity": 0}, {"sample_period": 0}):
        with pytest.raises(ValueError):
            tflows.FlowRing.create(device="cpu", **kw)
