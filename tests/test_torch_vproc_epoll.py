"""Parity of the port's readiness engine and host-side channels with
the reference's: every case of tests/test_epoll.py (level and edge
triggers, oneshot, EPOLLOUT on a full TCP send buffer, nesting),
tests/test_poll_select.py (poll/select transfers and timeouts) and
tests/test_channel.py (pipes, socketpairs, stop-time kills, the
device-side PROC_STOP) runs on both packages
(tests/torch_vproc_parity.py). The port's run equals the reference's,
tolerance zero: the final Sim leaf by leaf, EngineStats, the syscall
and dispatch counts, the pool and the syscall trace; the reference's
assertions hold on the port.
"""

import pytest

from torch_vproc_parity import assert_runs_equal, run_module_cases

MODULES = {
    "test_epoll": ("test_epoll_level_vs_edge_udp", "test_epoll_oneshot",
                   "test_epoll_writable_block_and_wake",
                   "test_epoll_nesting"),
    "test_poll_select": ("test_poll_select_transfer",
                         "test_poll_timeout_semantics"),
    "test_channel": ("test_pipe_blocking_and_eof",
                     "test_pipe_full_buffer_blocks_writer_epipe",
                     "test_socketpair_bidirectional_and_epoll",
                     "test_vproc_stoptime_kills_coroutine",
                     "test_device_proc_stop_masks_app"),
}
CASES = [(m, c) for m, cs in MODULES.items() for c in cs]
IDS = [f"{m[5:]}-{c[5:]}" for m, c in CASES]


@pytest.fixture(scope="module")
def runs():
    out = {}
    for m, cs in MODULES.items():
        for c, pair in run_module_cases(m, cs).items():
            out[(m, c)] = pair
    return out


@pytest.mark.parametrize("stem", sorted(MODULES))
def test_every_reference_case_is_covered(stem):
    import importlib

    ref = importlib.import_module(f"tests.{stem}")
    assert sorted(MODULES[stem]) == sorted(n for n in vars(ref)
                                           if n.startswith("test_"))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_final_state_matches_reference(runs, case):
    assert_runs_equal(*runs[case], "state")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_stats_counts_and_pool_match_reference(runs, case):
    assert_runs_equal(*runs[case], "stats")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_syscall_trace_matches_reference(runs, case):
    assert_runs_equal(*runs[case], "trace")
