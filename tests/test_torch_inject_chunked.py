"""The chunked streaming injection path in the port against the
reference's, on the CPU: run_windows(feeder=..., windows_per_dispatch=K)
drives the feeder loop that refills between chunks, and
core/engine.make_chunk_body's horizon clamp and stop inside each chunk.

- the 8-host trace of tests/test_torch_inject.py (40 events through 16
  lanes) at K = 4 and K = 64;
- bench.py's BENCH_INJECT_RATE cell cut to 64 hosts (rate_trace at 321
  events/s over 5 sim-s, 32 staging lanes, capacities 64, seed 1) at
  K = 1 and K = 16. Its trace period does not divide the 50-ms window,
  as the 10,240-host cell's 97,656 ns does not, so the window partition
  depends on the dispatch shape: the reference drains it in 195
  micro-steps one window a dispatch and in 152 at K = 16.

Each run is held to the reference's in full: EngineStats (windows and
micro-steps included), the manifest injection block and every leaf of
the Sim, with no carve-out. Four reference programs are compiled
(the chunk bodies at K = 4, 16 and 64 and the 64-host window step).
Tolerance zero.
"""

import pytest
import torch
from test_torch_inject import (
    _assert_leaves,
    _jax_bundle,
    _jax_leaves,
    _jax_stats,
    _port_bundle,
    _trace,
)

from shadow_tpu.apps import tgen as jtgen
from shadow_tpu.inject import Feeder as JFeeder
from shadow_tpu.inject import manifest_block as jmanifest_block
from shadow_tpu.net import build as jbuild
from shadow_tpu.net.state import NetConfig as JConfig
from shadow_tpu.utils import checkpoint as jckpt
from shadow_tpu_torch import bench, convert
from shadow_tpu_torch.apps import tgen
from shadow_tpu_torch.core import simtime
from shadow_tpu_torch.inject import Feeder, manifest_block
from shadow_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(1)

# the cut of bench.py's injection cell: hosts, rate (events/s), sim-s,
# staging lanes
RATE_H, RATE_R, RATE_S, RATE_LANES = 64, 321, 5, 32
# the reference's counts for the cut at each K (its CPU run)
RATE_EXPECT = {
    1: {"events_processed": 3257, "micro_steps": 195, "windows": 98,
        "fastpath_hit": 0, "fastpath_miss": 0},
    16: {"events_processed": 3257, "micro_steps": 152, "windows": 101,
         "fastpath_hit": 0, "fastpath_miss": 0},
}


def _runs(jb, tb, events, K):
    """(reference leaves, stats, block), (port's) for one trace at K."""
    jf, tf = JFeeder(list(events)), Feeder(list(events))
    jsim, jst, _ = jckpt.run_windows(jb, (jtgen.handler,), feeder=jf,
                                     windows_per_dispatch=K)
    tsim, tst, _ = tckpt.run_windows(tb, (tgen.handler,), feeder=tf,
                                     windows_per_dispatch=K, device="cpu")
    return ((_jax_leaves(jsim), _jax_stats(jst), jmanifest_block(jsim, jf)),
            (convert.sim_to_numpy(tsim), tst.as_dict(),
             manifest_block(tsim, tf)))


def _assert_same(want, got):
    assert got[1] == want[1]
    assert got[2] == want[2]
    _assert_leaves(want[0], got[0])


@pytest.mark.parametrize("K", [4, 64])
def test_chunked_run_is_leaf_equal_to_reference(K):
    want, got = _runs(_jax_bundle(), _port_bundle(), _trace(), K)
    _assert_same(want, got)
    blk = got[2]
    assert blk["injected"] == 40 and blk["deferred"] == 0
    assert blk["backpressure"] > 0         # 16 lanes << 40 events
    assert got[0][".app.rcvd"].sum() == 40


def _rate_bundles():
    cfg = dict(num_hosts=RATE_H, tcp=False,
               end_time=RATE_S * simtime.ONE_SECOND, seed=1,
               event_capacity=64, outbox_capacity=64, router_ring=64,
               in_ring=16, inject_lanes=RATE_LANES)
    hosts = [jbuild.HostSpec(name=f"peer{i}", proc_start_time=0)
             for i in range(RATE_H)]
    jb = jbuild.build(JConfig(**cfg), bench.ONE_VERTEX, hosts)
    jb.sim = jtgen.setup(jb.sim)
    tb = bench.build_inject(RATE_H, RATE_S, 1, 64, RATE_LANES,
                            bench.ONE_VERTEX, "cpu")
    return jb, tb


@pytest.mark.parametrize("K", [1, 16])
def test_rate_cell_cut_is_leaf_equal_to_reference(K):
    """The bench cell at 64 hosts: the port's run at K is the
    reference's, its partition-dependent counts included."""
    events = bench.rate_trace(RATE_H, RATE_R, RATE_S)
    assert len(events) == 1605
    want, got = _runs(*_rate_bundles(), events, K)
    _assert_same(want, got)
    assert got[1] == RATE_EXPECT[K]
    blk = got[2]
    assert (blk["injected"], blk["dropped"], blk["late"],
            blk["deferred"]) == (1605, 0, 0, 0)
