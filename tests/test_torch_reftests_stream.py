"""The stream-hinted half of tests/test_torch_reftests.py, in a file of
its own for the tier-1 time budget (one two-host JAX TCP program):
test_epoll_writeable and testshutdown load through both packages'
loaders on two hosts and run under each package's ProcessRuntime, with
that file's checks (tests/torch_vproc_parity.py).
"""

import pytest

from torch_vproc_parity import REFTESTS, assert_runs_equal, run_reftests

NAMES = ["test_epoll_writeable", "testshutdown"]


@pytest.fixture(scope="module")
def runs():
    res = {}
    for name in NAMES:
        out: dict = {}
        res[name] = ((run_reftests(name, False, out),
                      run_reftests(name, True, out)), out)
    return res


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
