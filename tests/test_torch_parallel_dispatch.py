"""The port's sharded dispatch shapes (two gloo ranks on the CPU)
against the reference's sharded supervised run on 2 of the conftest's
8 CPU devices, tolerance zero, on one program: PHOLD at 16 hosts with
the window telemetry ring, the flow recorder, the bulk pass and a fault
plan (loss, a crash and restart, a latency
spike; tests/torch_shard_ranks.py DISPATCH_*):

- the telemetry ring and the flow ring of the sharded window loop
  (make_telem_fn(axis), make_flow_fn(axis)) equal to the reference's;
- checkpoint.run_windows(mesh=) at K = 1 and K = 8: every final leaf
  and EngineStats;
- faults.run_supervised(mesh=) with the plan: ok, every leaf, its
  snapshots;
- a snapshot taken on 2 ranks resumed on 1, and one taken on 1
  resumed on 2: the final leaves of the uninterrupted run (but the
  leaves that count per shard, which mix two shard counts);
- the program's sparse twin (a 4-row budget, no bulk pass: the census
  reduction and each rank's compaction) on 2 ranks against the port's
  serial run (tests/test_torch_compact.py holds that path to the
  reference), the per-shard-count leaves and micro-steps aside.

One reference sharded program (its chunked supervised loop) serves the
file; the port's cases run in one spawn of two ranks.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import torch_shard_ranks as R
from shadow_tpu import faults as jfaults
from shadow_tpu.apps import phold as jphold
from shadow_tpu.faults.supervisor import run_supervised as jrun_supervised
from shadow_tpu_torch import convert
from shadow_tpu_torch.apps import phold as tphold
from shadow_tpu_torch.parallel import spawn
from shadow_tpu_torch.utils import checkpoint as tckpt
from torch_parity import assert_leaves_equal, jax_leaves, packed

torch.set_num_threads(1)

# the leaves that count per shard: the reference's four narrow
# counters, and the ring planes of a run whose windows ran on two
# shard counts (micro-steps are the slowest shard's, routed counts
# split by shard)
PER_SHARD_COUNT = (".outbox.narrow_hit", ".outbox.narrow_miss",
                   ".outbox.max_occupied", ".outbox.route_elided")
MIXED = PER_SHARD_COUNT + (".telem.micro_steps", ".telem.routed_local",
                           ".telem.routed_cross")


def _without(leaves, keys):
    return {k: v for k, v in leaves.items() if k not in keys}


def _jstats(st):
    st = jax.device_get(st)
    return {k: int(getattr(st, k)) for k in
            ("events_processed", "micro_steps", "windows", "fastpath_hit",
             "fastpath_miss")}


def _ref(d):
    """The reference's supervised loop at K = 8 on 2 devices."""
    jb = packed("jax", H=16, load=2, end=R.DISPATCH_END, lanes=False,
                replicas=False, flows=R.DISPATCH_FLOWS)
    jfaults.install(jb, jfaults.records_from_json(R.DISPATCH_PLAN))
    jb.app_bulk = jphold.BULK
    mesh = JMesh(np.array(jax.devices()[:2]), ("hosts",))
    res = jrun_supervised(jb, (jphold.handler,), mesh=mesh,
                          windows_per_dispatch=8,
                          checkpoint_path=str(d / "sup"),
                          checkpoint_every_windows=16)
    assert res.ok
    return jax_leaves(res.sim), _jstats(res.stats)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return _ref(tmp_path_factory.mktemp("ref"))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return _port(tmp_path_factory.mktemp("port"))


def _port(d):
    """The two ranks' cases, and the serial halves of the snapshot
    crossings: a one-rank snapshot (taken here, resumed on 2 by the
    ranks) and the ranks' first snapshot resumed here on 1."""
    b = R.dispatch_bundle()
    _, _, saved1 = tckpt.run_windows(
        b, (tphold.handler,), device="cpu",
        checkpoint_every_ns=R.CHECKPOINT_NS,
        checkpoint_path=str(d / "one"))
    out = spawn(R.dispatch_cases, 2, str(d), saved1[0][0],
                deadline_s=240)[0]
    path, t = out["saved"][0]
    b = R.dispatch_bundle()
    sim0, t0, _ = tckpt.load(path, b.sim)
    sim, st, _ = tckpt.run_windows(b, (tphold.handler,), sim=sim0,
                                   start_time=t0, device="cpu")
    out["resume_on_1"] = (convert.sim_to_numpy(sim), st.as_dict())
    out["one_meta"] = tckpt.peek_meta(saved1[0][0])
    out["two_meta"] = tckpt.peek_meta(path)
    b = R.dispatch_bundle(sparse=True)
    sim, st, _ = tckpt.run_windows(b, (tphold.handler,), device="cpu",
                                   windows_per_dispatch=8)
    out["sparse_on_1"] = (convert.sim_to_numpy(sim), st.as_dict())
    return out


def test_sharded_rings_match_reference(ref, port):
    want = ref[0]
    for k in ("k1", "k8"):
        got = port[k][0]
        rings = [p for p in want if p.startswith((".telem.", ".flows."))]
        assert any(p.startswith(".flows.") for p in rings)
        assert int(want[".flows.sampled"]) > 0
        assert_leaves_equal(want, got, keys=rings)


@pytest.mark.parametrize("k", ["k1", "k8"])
def test_run_windows_on_mesh_matches_reference(ref, port, k):
    want, wstats = ref
    leaves, stats = port[k]
    assert_leaves_equal(want, leaves)
    assert stats == wstats


def test_run_supervised_on_mesh_with_fault_plan(ref, port):
    ok, leaves, stats, saved = port["sup"]
    assert ok
    assert_leaves_equal(ref[0], leaves)
    assert stats == ref[1]
    assert saved and all(tckpt.peek_meta(p)["shards"] == 2
                         for p, _ in saved)


@pytest.mark.parametrize("case", ["resume_on_1", "resume_on_2"])
def test_snapshot_crosses_shard_counts(ref, port, case):
    assert port["one_meta"]["shards"] == 1
    assert port["two_meta"]["shards"] == 2
    leaves, _ = port[case]
    assert_leaves_equal(_without(ref[0], MIXED), _without(leaves, MIXED))


def test_sparse_census_on_mesh_equals_serial(port):
    """The census (a sum over the ranks) decides every rank's branch
    alike: the fast-path counts and every leaf of the serial run."""
    want, wst = port["sparse_on_1"]
    got, gst = port["sparse"]
    assert wst["fastpath_hit"] > 0
    for k in ("events_processed", "windows", "fastpath_hit",
              "fastpath_miss"):
        assert gst[k] == wst[k], k
    assert_leaves_equal(_without(want, MIXED), _without(got, MIXED))
