"""Elastic degraded-mesh recovery in the port (parallel/elastic.py, the
integrity sentinel in the window loop, the verified-state ledger and
the supervisor's retry/shrink/serial ladder over torch.distributed)
against the reference, tolerance zero:

- `classify` and `guard_dispatch` agree with the reference on each of
  its markers and test cases, and classify the torch.distributed
  failures (gloo's closed, reset or timed-out peer, NCCL's aborted
  communicator, the watchdog's timeout, DistBackendError); a CUDA
  program fault stays unclassified;
- the serial sentinel: a run carrying it equals the reference's serial
  run leaf for leaf, digest, checks and verified_through included;
- on 4 and 2 gloo ranks a clean run's sentinel leaves equal the serial
  ones (they are shard-count invariant, so the reference's serial run
  is the oracle), and a divergence on rank 1 latches shard 1 at the
  first window end past its onset;
- the offender rule over a table of digest vectors;
- shard_digests, elastic_meta and replan_shards equal the reference's
  on the same snapshot, written by either package, and refuse bad
  widths and a forged ledger with its messages;
- survivor_mesh and next_pow2_down;
- the serial retry bit-identical to an uninterrupted control;
- on 4 gloo ranks a dispatch poisoned twice steps retry then shrink to
  2, and a rank that kills its own process steps a shrink to 2; both
  end equal to the port's serial supervised run, and their elastic
  blocks pass tools/telemetry_lint.py.

One reference program (the serial whole run with the sentinel) serves
the file; the port's mesh cases run in one spawn of four ranks
(tests/torch_shard_ranks.py elastic_cases) beside it.
"""

import jax
import numpy as np
import pytest
import torch
from conftest import load_tool
from jax.sharding import Mesh as JMesh

import torch_shard_ranks as R
from shadow_tpu import faults as jfaults
from shadow_tpu.apps import phold as jphold
from shadow_tpu.net.build import make_runner as jmake_runner
from shadow_tpu.parallel import elastic as jel
from shadow_tpu.utils import checkpoint as jckpt
from shadow_tpu_torch import convert
from shadow_tpu_torch.apps import phold as tphold
from shadow_tpu_torch.parallel import elastic as tel
from shadow_tpu_torch.parallel import spawn
from shadow_tpu_torch.utils import checkpoint as tckpt
from torch_parity import assert_leaves_equal, jax_leaves, packed, side_by_side

torch.set_num_threads(1)

# the leaves that count per shard count (the outbox's narrow counters)
# and, on a run whose windows ran on several shard counts, the ring's
# per-shard planes (tests/test_torch_parallel_dispatch.py)
MIXED = (".outbox.narrow_hit", ".outbox.narrow_miss",
         ".outbox.max_occupied", ".outbox.route_elided",
         ".telem.micro_steps", ".telem.routed_local",
         ".telem.routed_cross")


def _sentinel(leaves):
    return {k: v for k, v in leaves.items() if k.startswith(".sentinel.")}


def _outside(leaves, prefixes):
    return {k: v for k, v in leaves.items()
            if not k.startswith(prefixes) and k not in MIXED}


def _ref_bundle():
    jb = packed("jax", H=16, load=2, end=R.DISPATCH_END, lanes=False,
                replicas=False, flows=R.DISPATCH_FLOWS)
    jfaults.install(jb, jfaults.records_from_json(R.DISPATCH_PLAN))
    jb.app_bulk = jphold.BULK
    jb.sim = jel.attach_sentinel(jb.sim)
    return jb


def _ref_run():
    jb = _ref_bundle()
    sim, _ = jmake_runner(jb, app_handlers=(jphold.handler,),
                          app_bulk=jphold.BULK)(jb.sim)
    return jb.sim, sim


def _port_serial(d):
    """The port's serial runs: run_windows K = 1 with the sentinel, the
    supervised run (the ladders' oracle), and the poisoned serial retry
    beside its uninterrupted control."""
    out = {}
    sim, st, _ = tckpt.run_windows(R.elastic_bundle(), (tphold.handler,),
                                   device="cpu")
    out["k1"] = (convert.sim_to_numpy(sim), st.as_dict())
    sup = R.elastic_supervised(R.elastic_bundle(), None, str(d / "sup"),
                               device="cpu")
    assert sup["ok"] and sup["elastic"]["ladder_steps"] == []
    out["sup"] = sup
    common = dict(app_handlers=(tphold.handler,),
                  checkpoint_every_windows=2, max_retries=2,
                  sleep=lambda s: None, device="cpu")
    from shadow_tpu_torch import faults as tfaults

    ctrl = tfaults.run_supervised(R.elastic_bundle(),
                                  checkpoint_path=str(d / "ctrl"),
                                  run_id="el.ctrl", **common)
    res = tfaults.run_supervised(
        R.elastic_bundle(), checkpoint_path=str(d / "chaos"),
        elastic=tel.ElasticPolicy(),
        dispatch_wrap=tel.make_poisoned_dispatch(ctrl.dispatches // 2,
                                                 shard=0),
        run_id="el.chaos", **common)
    out["retry"] = (ctrl, res)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("elastic")
    (init, ref), ranks, serial = side_by_side([
        _ref_run,
        lambda: spawn(R.elastic_cases, 4, str(d), deadline_s=400,
                      may_die=(3,)),
        lambda: _port_serial(d)])
    return {"ref_init": init, "ref": jax_leaves(ref), "ranks": ranks,
            "serial": serial, "dir": d}


# ------------------------------------------------------ classification

_REF_CASES = [
    (RuntimeError("INTERNAL: DEVICE_LOST: device ordinal 3 halted"),
     8, {}),
    (ValueError("bad spec"), 8, {}),
    (RuntimeError("sync timeout"), 8,
     {"elapsed_s": 12.0, "deadline_s": 5.0}),
    (RuntimeError("transfer to device failed: device 1 gone"), 2, {}),
] + [(RuntimeError(f"runtime: {m} (device 9)"), 16, {})
     for m in jel._LOSS_MARKERS]

# torch.distributed's failures of a lost peer, and a CUDA program fault
_TORCH_CASES = {
    "gloo_closed": ("[../gloo/transport/tcp/pair.cc:534] Connection "
                    "closed by peer [127.0.0.1]:41013", True),
    "gloo_reset": ("[../gloo/transport/tcp/pair.cc:589] Read error "
                   "[127.0.0.1]:2133: Connection reset by peer", True),
    "gloo_timeout": ("[../gloo/transport/tcp/unbound_buffer.cc:78] Timed "
                     "out waiting 5000ms for recv operation to complete",
                     True),
    "nccl_abort": ("NCCL communicator was aborted on rank 2.", True),
    "watchdog": ("[Rank 1] Watchdog caught collective operation "
                 "timeout: WorkNCCL(SeqNum=7, OpType=ALLREDUCE) ran for "
                 "60000 milliseconds before timing out.", True),
    "illegal_address": ("CUDA error: an illegal memory access was "
                        "encountered", False),
}


def _as_tuple(err):
    return None if err is None else (type(err).__name__, err.shard,
                                     err.cause, str(err))


@pytest.mark.parametrize("case", range(len(_REF_CASES)))
def test_classify_matches_reference(case):
    exc, shards, kw = _REF_CASES[case]
    assert _as_tuple(tel.classify(exc, shards=shards, **kw)) \
        == _as_tuple(jel.classify(exc, shards=shards, **kw))


def test_guard_dispatch_matches_reference():
    def boom():
        raise RuntimeError("transfer to device failed: device 1 gone")

    got = []
    for mod in (jel, tel):
        with pytest.raises(mod.DeviceLossError) as e:
            mod.guard_dispatch(boom, shards=2)()
        got.append(_as_tuple(e.value))
        assert mod.guard_dispatch(lambda: 7)() == 7
        with pytest.raises(ValueError):
            mod.guard_dispatch(lambda: int("x"))()
    assert got[0] == got[1]
    poison = tel.make_poisoned_dispatch([1, 2], shard=3)(lambda: 5)
    assert poison() == 5
    for _ in range(2):
        with pytest.raises(RuntimeError) as e:
            poison()
        assert tel.classify(e.value, shards=4).shard == 3
    assert poison() == 5


@pytest.mark.parametrize("name", sorted(_TORCH_CASES))
def test_classify_torch_distributed_failures(name):
    msg, lost = _TORCH_CASES[name]
    err = tel.classify(RuntimeError(msg), shards=4)
    if not lost:
        assert err is None
        return
    assert isinstance(err, tel.DeviceLossError)
    assert err.cause == "collective_error" and err.shard == -1
    assert err.as_dict()["fault"] == "DEVICE_LOST"


def test_classify_dist_backend_error():
    import torch.distributed as dist

    err = tel.classify(dist.DistBackendError("backend failed"), shards=2)
    assert isinstance(err, tel.DeviceLossError)
    assert err.cause == "collective_error"


# ---------------------------------------------------------- the sentinel

def test_serial_sentinel_matches_reference(runs):
    """The serial identity sentinel (run_windows K = 1) equals the
    reference's serial run in every leaf, the sentinel's included."""
    want = runs["ref"]
    got, _ = runs["serial"]["k1"]
    assert_leaves_equal(want, got)
    rep = _sentinel(got)
    assert rep[".sentinel.trip"] == 0 and rep[".sentinel.checks"] > 0
    assert rep[".sentinel.verified_through"] > 0
    assert rep[".sentinel.digest"].dtype == np.uint32


def test_digest_matches_reference_at_every_width(runs):
    """digest_replicated of the initial state at a few window ends, and
    the mesh cases' sentinel leaves (4 ranks at K = 1 and 4, 2 ranks):
    equal to the reference's serial ones, the rest of the state too
    (but the per-shard-count leaves)."""
    jsim = runs["ref_init"]
    tsim = convert.sim_from_numpy(jax_leaves(jsim), device="cpu",
                                  template=R.elastic_bundle().sim)
    for wend in (0, 1, 123_456_789, (1 << 40) + 7):
        assert int(tel.digest_replicated(tsim, wend)) \
            == int(jel.digest_replicated(jsim, wend))
    want = runs["ref"]
    rank0 = runs["ranks"][0]
    for case in ("clean4_k1", "clean4_k4", "clean2"):
        got = rank0[case][0]
        assert_leaves_equal(_sentinel(want), _sentinel(got))
        assert_leaves_equal(_outside(want, ()), _outside(got, ()),
                            keys=sorted(_outside(want, ())))


def _window_ends(leaves):
    n = int(leaves[".telem.count"])
    return [int(w) for w in leaves[".telem.wend"][:n]]


def test_divergence_latches_victim(runs):
    """latency_ns[0, 0] + 1 on rank 1's replica from 0.6 s: the
    sentinel latches shard 1 at the first window end at or past it,
    verified through the window before, and trips at every later
    barrier; the latch report lints clean."""
    ends = _window_ends(runs["ref"])
    rep = runs["ranks"][0]["diverged"]
    assert rep["shard"] == R.ELASTIC_VICTIM
    assert rep["tripped_at_ns"] == min(w for w in ends
                                       if w >= R.ELASTIC_AT_NS)
    assert rep["verified_through_ns"] == max(w for w in ends
                                             if w < R.ELASTIC_AT_NS)
    assert rep["checks"] == len(ends)
    assert rep["trips"] == sum(w >= R.ELASTIC_AT_NS for w in ends)
    assert all(r["diverged"] == rep for r in runs["ranks"][:3])
    tl = load_tool("telemetry_lint")
    assert tl._lint_health_sentinel(rep) == []


@pytest.mark.parametrize("digests,want", [
    ([5, 5, 7, 5], (7, 5, 2)),       # a minority: the odd one out
    ([5, 7, 5, 7], (7, 5, 1)),       # a tie: the holders of the max
    ([7, 5], (7, 5, 0)),
    ([5, 7], (7, 5, 1)),
    ([9, 9, 9, 9], (9, 9, 4)),       # no mismatch: no suspect
    ([3, 8, 8, 8, 8, 8, 8, 8], (8, 3, 0)),
    ([8, 8, 3, 3, 3, 8, 8, 8], (8, 3, 2)),
])
def test_offender_rule(digests, want):
    assert tel.offender_of(digests) == want
    assert tel.offender_of(torch.tensor(digests)) == want


# ---------------------------------------------------- ledger and replan

def _saved(pkg, sim, path, shards, elastic, time_ns=0):
    mod = jckpt if pkg == "jax" else tckpt
    return mod.save(path, sim, time_ns=time_ns, shards=shards,
                    elastic=elastic)


def test_ledger_and_replan_match_reference(runs, tmp_path):
    """elastic_meta of the runs' final state equals the reference's; a
    snapshot written by either package replans 16 -> 4 -> 1 in the
    other's replan_shards with the reference's ledger, leaf-exact, and
    lints clean."""
    jb = _ref_bundle()
    jsim = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jb.sim),
        [jax.numpy.asarray(runs["ref"][k]) for k in jax_leaves(jb.sim)])
    tsim = convert.sim_from_numpy(runs["ref"], device="cpu",
                                  template=R.elastic_bundle().sim)
    want = jckpt.elastic_meta(jsim, 16)
    assert tckpt.elastic_meta(tsim, 16) == want
    for s in (1, 2, 8):
        assert tel.shard_digests(tsim, s) == jel.shard_digests(jsim, s)
    tl = load_tool("telemetry_lint")
    metas = {}
    for writer, replanner in (("jax", "port"), ("port", "jax")):
        sim = jsim if writer == "jax" else tsim
        tmpl = jb.sim if replanner == "jax" else R.elastic_bundle().sim
        mod = jckpt if replanner == "jax" else tckpt
        path = str(tmp_path / f"{writer}.npz")
        _saved(writer, sim, path, 16, (jckpt if writer == "jax" else tckpt)
               .elastic_meta(sim, 16), time_ns=R.DISPATCH_END + 1)
        mod.replan_shards(path, 4, template_sim=tmpl)
        mod.replan_shards(path, 1, template_sim=tmpl)
        leaves, meta = tckpt.load_leaves(path)
        assert_leaves_equal(runs["ref"], leaves)
        metas[writer] = meta["elastic"]
        assert meta["shards"] == 1
        errs, _ = tl.lint_checkpoint_elastic(path)
        assert errs == []
    assert metas["jax"] == metas["port"]
    assert [r["to"] for r in metas["port"]["replans"]] == [4, 1]
    assert metas["port"]["shard_digests"] == jel.shard_digests(jsim, 1)


def test_replan_refusals_match_reference(runs, tmp_path):
    jb = _ref_bundle()
    tb = R.elastic_bundle()
    errs = {}
    for pkg, sim, mod in (("jax", jb.sim, jckpt), ("port", tb.sim, tckpt)):
        path = str(tmp_path / f"{pkg}")
        _saved(pkg, sim, path, 8, None)
        forged = mod.elastic_meta(sim, 8)
        forged["shard_digests"][2] = "0" * 64
        _saved(pkg, sim, path + ".forged", 8, forged)
        got = []
        for args, kw in (((path, 3), {}), ((path, 32), {}),
                         ((path + ".forged", 4), {"template_sim": sim})):
            with pytest.raises(ValueError) as e:
                mod.replan_shards(*args, **kw)
            got.append(str(e.value))
        errs[pkg] = got
    assert errs["port"] == errs["jax"]
    assert "power" in errs["port"][0] and "divisible" in errs["port"][1]
    assert "digest mismatch" in errs["port"][2]


def test_survivor_mesh_and_pow2():
    devices = np.array(jax.devices()[:8])
    jmesh, n = jel.survivor_mesh(JMesh(devices, ("hosts",)), "hosts", 6)
    kept = [int(d.id) for d in np.asarray(jmesh.devices).reshape(-1)]
    plan, tn = tel.survivor_mesh(_FakeMesh(8), "hosts", 6)
    assert (plan, tn) == ([0, 1, 2, 3], n)
    assert kept == [int(devices[i].id) for i in plan]
    none_mesh, n = jel.survivor_mesh(JMesh(devices[:2], ("hosts",)),
                                     "hosts", 0)
    assert (none_mesh, n) == (None, 1)
    assert tel.survivor_mesh(_FakeMesh(2), "hosts", 0) == (None, 1)
    # an unknown loss drops the last rank; a rank already missing from
    # the live set is the one lost
    assert tel.survivor_ranks(4, -1) == [0, 1]
    assert tel.survivor_ranks(4, -1, live=[0, 1, 2]) == [0, 1]
    assert tel.survivor_ranks(4, 0, live=[1, 2, 3]) == [1, 2]
    assert tel.survivor_ranks(8, 2) == [0, 1, 3, 4]
    for k in (1, 2, 3, 7, 8, 9, 1000):
        assert tel.next_pow2_down(k) == jel.next_pow2_down(k)
    for mod in (jel, tel):
        with pytest.raises(ValueError):
            mod.next_pow2_down(0)


class _FakeMesh:
    """A mesh's shape alone (survivor_mesh plans without a group)."""

    def __init__(self, size):
        self.size, self.rank, self.axis = size, 0, "hosts"


# -------------------------------------------------------- the ladder

def test_serial_retry_bit_identical_to_control(runs):
    ctrl, res = runs["serial"]["retry"]
    assert ctrl.ok and ctrl.dispatches > 2
    assert res.ok, res.failure_report()
    el = res.elastic
    assert [s["action"] for s in el["ladder_steps"]] == ["retry"]
    assert el["final_shards"] == 1 and el["mesh_transitions"] == []
    assert len(el["losses"]) == 1 and res.retries_used == 0
    want = convert.sim_to_numpy(ctrl.sim)
    got = convert.sim_to_numpy(res.sim)
    keys = [k for k in want if not k.startswith(".sentinel.")]
    assert_leaves_equal(want, got, keys=keys)
    assert tel.sentinel_report(res.sim)["verified_through_ns"] \
        == tel.sentinel_report(ctrl.sim)["verified_through_ns"]
    tl = load_tool("telemetry_lint")
    assert tl._lint_elastic(el, None) == ([], [])


def _reporter(ranks, case):
    got = [r[case] for r in ranks if r is not None and case in r]
    writers = [g for g in got if g["reports"]]
    assert len(writers) == 1, [(g["retired"], g["reports"]) for g in got]
    return writers[0], got


@pytest.mark.parametrize("case,ladder,retired", [
    ("poison", ["retry", "shrink"], [0]), ("kill", ["shrink"], [2])])
def test_mesh_ladder_ends_equal_to_serial(runs, case, ladder, retired):
    """4 ranks: two poisoned dispatches step a retry on 4 ranks, then a
    shrink that drops the named shard 0 and the rank past the pow2 cut
    (2 retire); rank 3 killing itself steps a shrink to 2 (rank 2
    retires; rank 3 holds no result to read, as it dies in the second
    case). The reporting rank's final state (sentinel leaves and
    per-shard-count leaves aside) and EngineStats (micro-steps aside)
    equal the serial supervised run's; no failure retry is spent; the
    elastic block lints clean."""
    res, got = _reporter(runs["ranks"], case)
    assert res["ok"] and res["retries_used"] == 0
    el = res["elastic"]
    assert [s["action"] for s in el["ladder_steps"]] == ladder
    assert el["initial_shards"] == 4 and el["final_shards"] == 2
    assert len(el["losses"]) == len(ladder)
    assert [(t["from"], t["to"]) for t in el["mesh_transitions"]] \
        == [(4, 2)]
    assert [r for r in range(3) if runs["ranks"][r][case]["retired"]] \
        == retired
    want = runs["serial"]["sup"]
    assert_leaves_equal(_outside(want["leaves"], (".sentinel.",)),
                        _outside(res["leaves"], (".sentinel.",)))
    ws, gs = dict(want["stats"]), dict(res["stats"])
    ws.pop("micro_steps"), gs.pop("micro_steps")
    assert gs == ws
    tl = load_tool("telemetry_lint")
    assert tl._lint_elastic(el, None) == ([], [])
