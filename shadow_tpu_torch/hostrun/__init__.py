"""The port's copy of shadow_tpu/hostrun/__init__.py, over its own vproc.

Dual-mode conformance subsystem: execute the SAME vproc generator
programs on the real host kernel and diff their normalized syscall
traces against the simulation's (docs/7-conformance.md).

Layout:
- kernel.py   — real-OS primitives: deterministic port mapping,
                portable timerfd stand-in
- executor.py — HostKernelExecutor: one OS thread per virtual
                process, real sockets/epoll/pipes on localhost
- trace.py    — TraceRecorder + normalization (both backends attach
                the same recorder via `runtime.trace`)
- diff.py     — differential checker over normalized traces
- runner.py   — workload catalog + one-call dual runs
"""

from .diff import DiffResult, diff_traces, render
from .executor import HostKernelExecutor
from .kernel import HostTimer, PortAllocator, PortMap, PortsUnavailable
from .runner import (DUAL_WORKLOADS, FAST_DUAL_WORKLOADS,
                     SIM_ONLY_WORKLOADS, WORKLOADS, DualResult,
                     conformance_block, run_dual, run_host, run_sim)
from .trace import TraceRecorder, load

__all__ = [
    "DiffResult", "diff_traces", "render",
    "HostKernelExecutor",
    "HostTimer", "PortAllocator", "PortMap", "PortsUnavailable",
    "DUAL_WORKLOADS", "FAST_DUAL_WORKLOADS", "SIM_ONLY_WORKLOADS",
    "WORKLOADS", "DualResult", "conformance_block",
    "run_dual", "run_host", "run_sim",
    "TraceRecorder", "load",
]
