"""Parity of the port's payload content and object accounting with the
reference's: every case of tests/test_payload.py (UDP content through
the payload pool, TCP content through the stream FIFOs over lossless and
lossy links, the pool's collection of dropped packets) and the runtime
cases of tests/test_objcount.py runs on both packages
(tests/torch_vproc_parity.py). The port's run equals the reference's,
tolerance zero: the final Sim leaf by leaf, EngineStats, the syscall
and dispatch counts, the pool's total allocations and live bytes and the
syscall trace; the reference's assertions hold on the port, and
utils.objcount's runtime branch counts the same objects in both.
"""

import pytest

from torch_vproc_parity import (
    assert_runs_equal,
    load_module,
    run_case,
    run_module_cases,
)

MODULES = {
    "test_payload": ("test_udp_content_roundtrip",
                     "test_udp_mixed_content_and_synthetic",
                     "test_tcp_content_lossless",
                     "test_dropped_payload_collected",
                     "test_tcp_content_lossy"),
    "test_objcount": ("test_all_objects_freed_clean_run",
                      "test_leaked_socket_is_flagged",
                      "test_tracker_heartbeat_lines"),
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


@pytest.mark.parametrize("leak", [False, True], ids=["clean", "leak"])
def test_objcount_runtime_counts_match_reference(leak):
    """objcount.gather(sim, runtime=rt, stats=stats): the payload,
    channel-fd and process counts join the device counts, equal in both
    packages (and printed the same)."""
    got = {}

    def fn(port):
        mod = load_module("test_objcount", port)
        sim, stats, rt = mod._echo_run(leak=leak)
        oc = mod.objcount.gather(sim, runtime=rt, stats=stats)
        got[port] = (oc.counts, oc.format(), oc.format_diff())

    for port in (False, True):
        res = run_case(port, fn)
        assert res.error is None, res.error
    assert got[True] == got[False]
    assert {"payload", "channel-fd", "process"} <= set(got[True][0])
