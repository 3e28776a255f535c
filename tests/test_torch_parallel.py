"""Parity of the port's sharded window loop (shadow_tpu_torch.parallel,
one gloo rank per shard on the CPU) with the reference's run_sharded on
the conftest's 8-device CPU mesh — tests/test_parallel.py's contract:

- 2 and 8 shards on its 8-host pingpong: every final leaf, by flax
  field path, equal to the reference's at the same shard count (the
  outbox's narrow counters included) and to the port's serial run but
  for the leaves the reference itself gives per shard count;
- exchange_capacity=1: the whole run counts its dropped entries in
  overflow (tests/test_parallel.py's check), and the exchange at one
  slot a peer counts the reference's overflow, entry for entry;
- an initial overflow of 3 comes back as 3;
- route_outbox_sharded on seeded outboxes (the narrow branch, the full
  branch, the empty elision, bad dst, exchange overflow, a misrouted
  arrival) against the reference's under shard_map.

Tolerance zero. Each shard count is one spawn of its ranks
(tests/torch_shard_ranks.py, which imports only the port), and one
reference sharded program a shard count serves its cases (the
exchange-capacity case holds the route itself to the reference's, a
program of its own would cost a second whole-run compile).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

import torch_shard_ranks as R
from shadow_tpu.apps import pingpong as jping
from shadow_tpu.core.events import EventQueue as JQueue
from shadow_tpu.core.events import Outbox as JOutbox
from shadow_tpu.parallel.shard import _shard_map
from shadow_tpu.parallel.shard import make_sharded_runner as jrunner
from shadow_tpu.parallel.shard import route_outbox_sharded as jroute
from shadow_tpu_torch import convert
from shadow_tpu_torch.net.build import run as trun
from shadow_tpu_torch.parallel import spawn
from test_parallel import _build as jbuild_pingpong
from torch_parity import side_by_side

torch.set_num_threads(1)

# the leaves the reference gives per shard count
PER_SHARD_COUNT = (".outbox.narrow_hit", ".outbox.narrow_miss",
                   ".outbox.max_occupied", ".outbox.route_elided")


def _jax_leaves(sim):
    flat, _ = jax.tree_util.tree_flatten_with_path(jax.device_get(sim))
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _assert_equal(want, got, skip=()):
    assert sorted(want) == sorted(got), sorted(set(want) ^ set(got))
    for k in want:
        if k in skip:
            continue
        assert want[k].dtype == got[k].dtype, (k, want[k].dtype,
                                               got[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _jstats(st):
    st = jax.device_get(st)
    return {k: int(getattr(st, k)) for k in
            ("events_processed", "micro_steps", "windows", "fastpath_hit",
             "fastpath_miss")}


@pytest.fixture(scope="module")
def port_serial():
    sim, st = trun(R.pingpong(), app_handlers=(R.tping.handler,),
                   device="cpu")
    return convert.sim_to_numpy(sim), st.as_dict()


def _ref_sharded(n):
    """The reference's run_sharded at n shards, one program for the
    plain and the initial-overflow cases: {(n, case): (leaves,
    stats)}."""
    mesh = JMesh(np.array(jax.devices()[:n]), ("hosts",))
    b = jbuild_pingpong()
    go = jrunner(b, mesh, "hosts", app_handlers=(jping.handler,))
    b3 = jbuild_pingpong()
    sim3 = b3.sim.replace(events=b3.sim.events.replace(
        overflow=jnp.asarray(3, jnp.int32)))
    out = {}
    for name, sim in (("plain", b.sim), ("overflow3", sim3)):
        s, st = go(sim)
        out[n, name] = (_jax_leaves(s), _jstats(st))
    return out


@pytest.fixture(scope="module")
def runs():
    """The reference's programs at 2 and 8 shards, its routes, and the
    port's spawns of 2 and 8 ranks, side by side."""
    ref2, ref8, routes, port = side_by_side([
        lambda: _ref_sharded(2), lambda: _ref_sharded(8), _ref_routes,
        lambda: {n: spawn(R.sharded_pingpong_cases, n, deadline_s=240)[0]
                 for n in (2, 8)}])
    return {"ref": {**ref2, **ref8}, "routes": routes, "port": port}


@pytest.fixture(scope="module")
def port_runs(runs):
    """{shards: rank 0's case results} — one spawn per shard count."""
    return runs["port"]


@pytest.fixture(scope="module")
def ref_runs(runs):
    return runs["ref"]


@pytest.mark.parametrize("nshards", [2, 8])
def test_sharded_matches_single(port_runs, ref_runs, port_serial, nshards):
    leaves, stats = port_runs[nshards]["plain"]
    want, wstats = ref_runs[nshards, "plain"]
    _assert_equal(want, leaves)
    assert stats == wstats
    serial, sstats = port_serial
    _assert_equal(serial, leaves, skip=PER_SHARD_COUNT)
    assert stats["events_processed"] == sstats["events_processed"]
    assert stats["windows"] == sstats["windows"]
    assert int(leaves[".events.overflow"]) == 0
    assert leaves[".app.rcvd"][:R.PING_H // 2].tolist() == [5] * 4
    hit = int(leaves[".outbox.narrow_hit"])
    miss = int(leaves[".outbox.narrow_miss"])
    if R.PING_H // nshards > 1:
        assert hit + miss == stats["windows"] and miss == 0
        assert int(leaves[".outbox.max_occupied"]) > 0
    else:
        assert hit == 0 and miss == 0


def test_exchange_capacity_counts_overflow(port_runs, ref_routes):
    """A too-small per-peer exchange buffer counts the entries it drops
    in events.overflow, never loses them silently: the whole run at one
    slot a peer (4 clients a shard ping 4 servers on the other shard in
    one window), and the route at one slot against the reference's."""
    leaves, stats = port_runs[2]["xcap1"]
    assert int(leaves[".events.overflow"]) > 0
    got = port_runs[2]["routes"]["xcap"][".events.overflow"]
    want = ref_routes["xcap"][".events.overflow"]
    assert got.sum() > 0
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("nshards", [2, 8])
def test_sharded_preserves_initial_scalar_counters(port_runs, ref_runs,
                                                   nshards):
    leaves, stats = port_runs[nshards]["overflow3"]
    want, wstats = ref_runs[nshards, "overflow3"]
    assert int(leaves[".events.overflow"]) == 3
    _assert_equal(want, leaves)
    assert stats == wstats


def _ref_route(nshards, xcap):
    """The reference's route_outbox_sharded under shard_map: (queue,
    outbox, lane) -> the routed pair, each scalar as its per-shard
    values."""
    mesh = JMesh(np.array(jax.devices()[:nshards]), ("hosts",))

    def body(q, out, lane):
        for _ in range(2):
            q, out2 = jroute(q, out, "hosts", nshards, lane, xcap)
            out = out2.replace(dst=out.dst, time=out.time, kind=out.kind,
                               src=out.src, seq=out.seq, words=out.words)
        return q, out2

    spec = P("hosts")
    f = _shard_map(body, mesh=mesh, in_specs=(spec, spec, spec),
                   out_specs=(spec, spec), check_vma=False)
    return jax.jit(f)


def _ref_route_case(fn, planes, H, M, K, W, lane):
    q = JQueue.create(H, K, nwords=W)
    out = JOutbox.create(H, M, nwords=W)
    out = out.replace(**{k: jnp.asarray(v) for k, v in planes.items()})
    nshards = 2
    q = q.replace(overflow=jnp.zeros((nshards,), jnp.int32))
    out = jax.tree.map(lambda x: jnp.zeros((nshards,), x.dtype)
                       if x.ndim == 0 else x, out)
    rq, rout = fn(q, out, jnp.asarray(lane, jnp.int32))
    res = {}
    for part, obj in (("events", rq), ("outbox", rout)):
        for k, v in _jax_leaves(obj).items():
            res[f".{part}{k}"] = v
    return res


@pytest.fixture(scope="module")
def ref_routes(runs):
    return runs["routes"]


def _ref_routes():
    fns = {}
    out = {}
    W = 4
    for name, (seed, H, M, K, fill, bad, xcap) in R.ROUTE_CASES.items():
        if xcap not in fns:
            fns[xcap] = _ref_route(2, xcap)
        fn = fns[xcap]
        planes = R.seeded_outbox(seed, H, M, W, fill, bad)
        out[name] = _ref_route_case(fn, planes, H, M, K, W, np.arange(H))
    planes = R.seeded_outbox(6, 8, 8, W, 2)
    lane = (np.arange(8) + 4) % 8          # each shard owns the other's
    mis = _ref_route_case(fns[None], planes, 8, 8, 8, W, lane)
    out["misrouted_overflow"] = int(mis[".events.overflow"].sum())
    return out


@pytest.mark.parametrize("case", sorted(R.ROUTE_CASES))
def test_route_outbox_sharded_matches_reference(port_runs, ref_routes, case):
    got = port_runs[2]["routes"][case]
    want = ref_routes[case]
    keys = sorted(k for k in want if k in got)
    assert keys == sorted(got), sorted(set(got) ^ set(want))
    for k in keys:
        w = want[k]
        g = got[k]
        if k.endswith(("overflow", "narrow_hit", "narrow_miss",
                       "max_occupied", "route_elided")):
            w = w.astype(np.int64)
        np.testing.assert_array_equal(g, w, err_msg=f"{case} {k}")


def test_route_outbox_sharded_counts_misrouted(port_runs, ref_routes):
    got = port_runs[2]["routes"]["misrouted_overflow"]
    assert got > 0
    assert got == ref_routes["misrouted_overflow"]


def test_hung_collective_fails_within_its_timeout(port_runs):
    """A collective that one rank never joins raises on the other within
    the mesh's timeout (1 s here; at most 60 s), instead of hanging: a
    second group of the 2-rank spawn, rank 1 idle for 4 s."""
    raised, secs = port_runs[2]["hung"]
    assert raised and secs < 4.0
