"""Parity of the port's virtual processes (shadow_tpu_torch/process/
vproc.py) with the reference's: every case of tests/test_vproc.py runs
on both packages (tests/torch_vproc_parity.py), and the port's run
equals the reference's, tolerance zero — the final Sim leaf by leaf,
EngineStats, the syscall and device-dispatch counts, the syscall trace
(raw and normalized) and the payload pool's counts; the reference's own
assertions hold on the port. Then the port's own surface: a coroutine
yielding the reference's Sys is refused by name, `mesh=` names its
ROADMAP item, and tests/test_vproc_scale.py's 1,000 processes run on
the port with its batching ratio.
"""

import numpy as np
import pytest

from torch_vproc_parity import assert_runs_equal, run_module_cases

CASES = ("test_udp_echo_coroutines", "test_tcp_connect_refused",
         "test_tcp_transfer_coroutines", "test_sockbuf_syscalls",
         "test_timerfd_syscalls", "test_bind_eaddrinuse",
         "test_shutdown_half_close", "test_gethostbyname",
         "test_condition_variables_rpth_semantics",
         "test_fork_exec_system_return_enosys")


@pytest.fixture(scope="module")
def runs():
    return run_module_cases("test_vproc", CASES)


def test_every_reference_case_is_covered():
    import tests.test_vproc as ref

    assert sorted(CASES) == sorted(n for n in vars(ref)
                                   if n.startswith("test_"))


@pytest.mark.parametrize("case", CASES)
def test_final_state_matches_reference(runs, case):
    assert_runs_equal(*runs[case], "state")


@pytest.mark.parametrize("case", CASES)
def test_stats_counts_and_pool_match_reference(runs, case):
    assert_runs_equal(*runs[case], "stats")


@pytest.mark.parametrize("case", CASES)
def test_syscall_trace_matches_reference(runs, case):
    assert_runs_equal(*runs[case], "trace")


def _tiny_build():
    from shadow_tpu_torch.net.build import HostSpec, build
    from shadow_tpu_torch.net.state import NetConfig
    from tests.test_vproc import GRAPH

    return build(NetConfig(num_hosts=2, tcp=False), GRAPH,
                 [HostSpec(name="client"), HostSpec(name="server")],
                 device="cpu")


def test_a_reference_sys_is_refused_by_name():
    """A plugin that imported the reference's vproc yields a Sys the
    port must not run: the scheduler refuses it by name."""
    from shadow_tpu.process import vproc as jvproc
    from shadow_tpu_torch.process import vproc
    from shadow_tpu_torch.process.vproc import ProcessRuntime
    b = _tiny_build()

    def proc(_h):
        yield jvproc.gettime()

    rt = ProcessRuntime(b, device="cpu")
    rt.spawn(0, proc)
    with pytest.raises(TypeError, match="shadow_tpu_torch.process.vproc"):
        rt.run(end_time=10**9)

    def good(_h):
        t = yield vproc.gettime()
        assert t == 0

    rt = ProcessRuntime(b, device="cpu")
    rt.spawn(0, good)
    rt.run(end_time=10**9)
    assert all(p.done for p in rt.procs)


def test_mesh_names_its_roadmap_item():
    from shadow_tpu_torch.process.vproc import ProcessRuntime

    with pytest.raises(NotImplementedError, match="item 9b"):
        ProcessRuntime(_tiny_build(), mesh=object(), device="cpu")


# the reference's counts of tests/test_vproc_scale.py's run (its CPU
# run of the same coroutines): 1,000 processes, 3 rounds
SCALE_EXPECT = {"events_processed": 6000, "micro_steps": 12, "windows": 12,
                "syscalls": 20000, "dispatches": 16}


def test_thousand_vprocs_batched_on_port():
    """tests/test_vproc_scale.py on the port alone (1,000 hosts is past
    the parity tests' width): its own assertions — every pong, zero
    overflow, dispatches < syscalls / 20 — and the reference's counts."""
    from torch_vproc_parity import load_module, world

    made: list = []
    with world(True, made):
        load_module("test_vproc_scale", True).test_thousand_vprocs_batched()
    (rt,) = made
    stats = rt.last[1].as_dict()
    got = {k: stats[k] for k in ("events_processed", "micro_steps",
                                 "windows")}
    got.update(syscalls=rt.stat_syscalls, dispatches=rt.stat_device_dispatches)
    assert got == SCALE_EXPECT
    assert rt.stat_device_dispatches < rt.stat_syscalls / 20
    assert np.all([p.done for p in rt.procs])
