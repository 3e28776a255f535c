"""Parity of the port's reftests syscall plugins (shadow_tpu_torch/apps/
reftests.py, registered by config/loader.py) with the reference's: each
of the 13 plugins loads from a small config through both packages'
loaders — one host, or two for the plugins with the TCP stream hints
(epoll-writeable, shutdown: tests/test_torch_reftests_stream.py) — and
runs under each package's ProcessRuntime (tests/torch_vproc_parity.py).
Equal virtual processes (host, start, stop) and NetConfig, and the
port's run equals the reference's, tolerance zero: the final Sim leaf by
leaf, EngineStats, the syscall and dispatch counts, the pool and the
syscall trace; and tests/test_reference_configs.py's checks hold on the
port (every process done, zero overflow, the random and signal
banners).
"""

import pytest

from shadow_tpu_torch.config import loader as tloader
from torch_vproc_parity import REFTESTS, assert_runs_equal, run_reftests

STREAM = ("test_epoll_writeable", "testshutdown")
NAMES = sorted(n for n in REFTESTS if n not in STREAM)


@pytest.fixture(scope="module")
def runs():
    res = {}
    for name in NAMES:
        out: dict = {}
        res[name] = ((run_reftests(name, False, out),
                      run_reftests(name, True, out)), out)
    return res


def test_every_reftests_plugin_is_covered():
    """One case per reftests main; every name of it registered in both
    packages."""
    mains = {tloader._REGISTRY[n].__qualname__ for n in REFTESTS}
    assert len(mains) == 1      # all are _vproc_plugin configures
    from shadow_tpu_torch.apps import reftests

    fns = {n for n in vars(reftests) if n.endswith("_main")}
    assert len(fns) == len(REFTESTS) + 1   # + tgen_main (hostrun only)
    assert set(STREAM) < set(REFTESTS)


@pytest.mark.parametrize("name", NAMES)
def test_loads_like_the_reference(runs, name):
    (_, _), out = runs[name]
    assert out[True]["cfg"] == out[False]["cfg"]
    assert out[True]["vprocs"] == out[False]["vprocs"]
    assert out[True]["vprocs"]


@pytest.mark.parametrize("name", NAMES)
def test_final_state_matches_reference(runs, name):
    assert_runs_equal(*runs[name][0], "state")


@pytest.mark.parametrize("name", NAMES)
def test_stats_counts_and_pool_match_reference(runs, name):
    assert_runs_equal(*runs[name][0], "stats")


@pytest.mark.parametrize("name", NAMES)
def test_syscall_trace_matches_reference(runs, name):
    assert_runs_equal(*runs[name][0], "trace")


@pytest.mark.parametrize("name", NAMES)
def test_reference_config_checks_hold_on_port(runs, name):
    (_, port), out = runs[name]
    assert port.error is None, port.error
    got = out[True]
    assert all(got["done"]) and got["overflow"] == 0
    if name in ("testrandom", "testsignal"):
        assert b"test passed" in got["stdout"], got["stdout"]
