"""Parity of the port's ring model (shadow_tpu_torch.apps.ring, the
smallest end-to-end program: engine + event queues + outbox routing)
with the reference's, run through each package's core.engine.run on
the CPU: the boot state, EngineStats and every final leaf equal
(tolerance zero), plus tests/test_engine.py's conservative-hop checks.
"""

import jax
import numpy as np
import pytest
import torch

from shadow_tpu.apps import ring as jring
from shadow_tpu.core import engine as jengine
from shadow_tpu.core import simtime
from shadow_tpu_torch import convert
from shadow_tpu_torch.apps import ring as tring
from shadow_tpu_torch.core import engine as tengine

torch.set_num_threads(1)

SHAPES = {"4_hosts_100ms": (4, 100 * simtime.ONE_MILLISECOND, 16),
          "8_hosts_1s": (8, simtime.ONE_SECOND, 16),
          "33_hosts_500ms_cap4": (33, 500 * simtime.ONE_MILLISECOND, 4)}


def _jax_leaves(sim):
    flat, _ = jax.tree_util.tree_flatten_with_path(sim)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _assert_leaves_equal(want, got):
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, (k, want[k].dtype, got[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_ring_matches_reference(name):
    H, end, cap = SHAPES[name]
    jsim = jring.make(H, capacity=cap, outbox_capacity=cap)
    tsim = tring.make(H, capacity=cap, outbox_capacity=cap, device="cpu")
    _assert_leaves_equal(_jax_leaves(jsim), convert.sim_to_numpy(tsim))
    jout, jstats = jax.jit(lambda s: jengine.run(
        s, jring.step, end_time=end, min_jump=jring.LATENCY))(jsim)
    tout, tstats = tengine.run(tsim, tring.step, end_time=end,
                               min_jump=tring.LATENCY)
    assert tstats.as_dict() == jstats.as_dict()
    _assert_leaves_equal(_jax_leaves(jout), convert.sim_to_numpy(tout))


def test_ring_hops_conservatively():
    """tests/test_engine.py's first check, on the port."""
    sim, stats = tengine.run(tring.make(4, device="cpu"), tring.step,
                             end_time=100 * simtime.ONE_MILLISECOND,
                             min_jump=tring.LATENCY)
    assert int(stats.events_processed) == 11
    assert int(sim.events.overflow) == 0 and int(sim.outbox.overflow) == 0
    assert int(stats.windows) >= 11
    assert sim.hops.tolist()[0] == 3 and int(sim.hops.sum()) == 11


def test_ring_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behavior without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        tring.make(4)
