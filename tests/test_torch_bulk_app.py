"""Parity of the port's TCP bulk-transfer app (shadow_tpu_torch.apps.bulk)
with the reference's, through each package's config loader: the
built-in `--test` example at tests/test_example_e2e.py's shape (5
clients upload 33 KiB each to one server, 40 sim-s) at seeds 3 and 5,
run to completion. Boot state, EngineStats and every final leaf equal
(tolerance zero).

One JAX TCP program: the reference's runner is built once and runs
both seeds' boot states (they differ in state only).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from shadow_tpu.config import loader as jloader
from shadow_tpu.config import xmlconfig as jxml
from shadow_tpu.net import build as jbuild
from shadow_tpu_torch import convert
from shadow_tpu_torch.apps import bulk as tbulk
from shadow_tpu_torch.config import examples
from shadow_tpu_torch.config import loader as tloader
from shadow_tpu_torch.config import xmlconfig as txml
from shadow_tpu_torch.net import build as tbuild

torch.set_num_threads(1)

CLIENTS = 5
KIB = 33
TEXT = examples.example_config(clients=CLIENTS, kib=KIB, stoptime=40)
SEEDS = (3, 5)


def _jax_leaves(sim):
    flat, _ = jax.tree_util.tree_flatten_with_path(sim)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _assert_leaves_equal(want, got):
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, (k, want[k].dtype, got[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def runs():
    jruns = {s: jloader.load(jxml.parse_config(TEXT), seed=s) for s in SEEDS}
    first = jruns[SEEDS[0]].bundle
    for s in SEEDS[1:]:
        b = jruns[s].bundle
        assert b.min_jump == first.min_jump
        assert dataclasses.replace(b.cfg, seed=first.cfg.seed) == first.cfg
    runner = jbuild.make_runner(first, app_handlers=jruns[SEEDS[0]].handlers,
                                app_bulk=first.app_bulk)
    out = {}
    for s in SEEDS:
        jb = jruns[s].bundle
        boot = _jax_leaves(jb.sim)
        jsim, jstats = runner(jb.sim)
        tl = tloader.load(txml.parse_config(TEXT), seed=s, device="cpu")
        tb = tl.bundle
        tboot = convert.sim_to_numpy(tb.sim)
        tsim, tstats = tbuild.run(tb, app_handlers=tl.handlers,
                                  app_bulk=tb.app_bulk, device="cpu")
        out[s] = {"boot": (boot, tboot),
                  "stats": (jstats.as_dict(), tstats.as_dict()),
                  "final": (_jax_leaves(jsim), convert.sim_to_numpy(tsim)),
                  "handlers": tl.handlers}
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_boot_state_matches_reference(runs, seed):
    _assert_leaves_equal(*runs[seed]["boot"])


@pytest.mark.parametrize("seed", SEEDS)
def test_run_stats_match_reference(runs, seed):
    want, got = runs[seed]["stats"]
    assert got == want


@pytest.mark.parametrize("seed", SEEDS)
def test_run_every_leaf_matches_reference(runs, seed):
    _assert_leaves_equal(*runs[seed]["final"])


@pytest.mark.parametrize("seed", SEEDS)
def test_every_download_completes(runs, seed):
    """tests/test_example_e2e.py's checks on the port: the server holds
    clients x filesize bytes, saw EOF, and nothing overflowed; the
    reference's counts at seed 3 (268 events, 28 windows, 211
    micro-steps)."""
    leaves = runs[seed]["final"][1]
    assert runs[seed]["handlers"] == (tbulk.handler,)
    for k in (".events.overflow", ".outbox.overflow", ".net.rq_overflow"):
        assert int(leaves[k]) == 0, k
    assert int(leaves[".app.rcvd"].sum()) == CLIENTS * KIB * 1024
    srv = leaves[".app.is_server"]
    assert srv.sum() == 1 and leaves[".app.eof"][srv].all()
    assert (leaves[".app.to_send"] == 0).all()
    assert leaves[".app.closed"][leaves[".app.is_client"]].all()
    if seed == 3:
        stats = runs[seed]["stats"][1]
        assert (stats["events_processed"], stats["windows"],
                stats["micro_steps"]) == (268, 28, 211)


def test_loader_hints_size_the_example():
    """The plugin hints size the rings and socket table (a 4-slot table
    cannot hold listener + child + backlog)."""
    b = tloader.load(txml.parse_config(TEXT), seed=3, device="cpu").bundle
    assert b.cfg.num_hosts == CLIENTS + 1
    assert b.cfg.sockets_per_host == 8
    assert b.cfg.event_capacity == b.cfg.router_ring == 64 * CLIENTS
    assert b.cfg.tcp
