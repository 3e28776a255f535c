"""Parity of the port's virtual processes (shadow_tpu_torch/process/
vproc.py) with the reference's: every case of tests/test_vproc.py runs
on both packages (tests/torch_vproc_parity.py), and the port's run
equals the reference's, tolerance zero — the final Sim leaf by leaf,
EngineStats, the syscall and device-dispatch counts, the syscall trace
(raw and normalized) and the payload pool's counts; the reference's own
assertions hold on the port. Then the port's own surface: a coroutine
yielding the reference's Sys is refused by name, `mesh=` (once
refused) runs, and tests/test_vproc_scale.py's 1,000 processes run on
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
    """`mesh=`, once refused, runs: tests/test_vproc_sharded.py's
    program on a one-rank mesh (the sharded window loop at one shard)
    equals the serial run but for the outbox's per-shard-count
    counters (tests/test_torch_vproc_sharded.py holds 2 ranks to the
    reference), and a device other than the mesh's is refused."""
    import torch_shard_ranks as R
    from shadow_tpu_torch import convert
    from shadow_tpu_torch.parallel import Mesh
    from shadow_tpu_torch.process.vproc import ProcessRuntime

    with pytest.raises(ValueError, match="mesh rank"):
        ProcessRuntime(_tiny_build(), mesh=Mesh(1, device="cpu"),
                       device="cuda")
    (slog, sev, ssim), (mlog, mev, msim) = (
        R.vproc_udp_echo(mesh) for mesh in (None, Mesh(1, device="cpu")))
    assert (mlog, mev) == (slog, sev) and len(slog) == R.VPROC_H
    want, got = convert.sim_to_numpy(ssim), convert.sim_to_numpy(msim)
    per_shard = {".outbox.narrow_hit", ".outbox.narrow_miss",
                 ".outbox.max_occupied", ".outbox.route_elided"}
    assert sorted(want) == sorted(got)
    for k in sorted(set(want) - per_shard):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


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
