"""Dual-mode harness (PyTorch port of shadow_tpu/hostrun/runner.py):
run one reference workload (apps/reftests.py) under BOTH backends —
the simulation (ProcessRuntime, on the device the caller names: None
is "cuda", as for every runner of the port) and the real host kernel
(HostKernelExecutor) — with a trace recorder attached to each, and
diff the normalized traces.

The workload registry below is the single catalog of which reference
syscall tests run dual-mode: the program source is SHARED (the point
of the subsystem — apps/ is untouched), only the spawn placement,
arguments, and sim horizon are per-workload. `host_ok=False` marks
the documented sim-only cases (docs/7-conformance.md).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from shadow_tpu_torch.core import simtime
from shadow_tpu_torch.net.build import HostSpec, build
from shadow_tpu_torch.net.state import NetConfig

from .diff import DiffResult, diff_traces
from .executor import HostKernelExecutor
from .kernel import PortAllocator, PortMap
from .trace import TraceRecorder

# the same tiny 2-host topology tests/test_vproc.py exercises — both
# backends build it, so env['resolve'] hands programs identical IPs
GRAPH = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="latency" attr.type="double" for="edge" id="lat" />
  <key attr.name="bandwidthup" attr.type="int" for="node" id="up" />
  <key attr.name="bandwidthdown" attr.type="int" for="node" id="dn" />
  <key attr.name="type" attr.type="string" for="node" id="ty" />
  <graph edgedefault="undirected">
    <node id="a"><data key="up">10240</data><data key="dn">10240</data>
      <data key="ty">client</data></node>
    <node id="b"><data key="up">10240</data><data key="dn">10240</data>
      <data key="ty">server</data></node>
    <edge source="a" target="a"><data key="lat">5.0</data></edge>
    <edge source="a" target="b"><data key="lat">25.0</data></edge>
    <edge source="b" target="b"><data key="lat">5.0</data></edge>
  </graph>
</graphml>"""

HOST_NAMES = ("client", "server")


@dataclass(frozen=True)
class Workload:
    """One reference test in the dual-mode catalog. `procs` places
    generator instances: (host_index, argv, start_seconds)."""

    name: str
    fn_name: str                      # attribute in apps.reftests
    seconds: int = 10
    procs: tuple = ((0, (), 0),)
    host_ok: bool = True
    slow: bool = False
    note: str = ""


WORKLOADS = {
    w.name: w for w in (
        Workload("bind", "bind_main"),
        Workload("epoll", "epoll_main"),
        Workload("poll", "poll_main"),
        Workload("sockbuf", "sockbuf_main",
                 note="getsockopt returns the user-set value on both "
                      "backends (Linux doubling masked)"),
        Workload("timerfd", "timerfd_main", seconds=15),
        Workload("sleep", "sleep_main", host_ok=False,
                 note="asserts an EXACT 1 s virtual delta; a real "
                      "clock cannot satisfy it"),
        Workload("shutdown", "shutdown_main", seconds=20, slow=True),
        Workload("epoll_writeable", "epoll_writeable_main", seconds=40,
                 procs=((1, ("server",), 0), (0, ("client", "server"), 1)),
                 slow=True),
        Workload("file", "file_main"),
        Workload("random", "random_main"),
        Workload("signal", "signal_main"),
        Workload("pthreads", "pthreads_main"),
        Workload("unistd", "unistd_main"),
        # the open-system traffic model (apps/tgen.py): the SAME
        # phase walk that compiles <traffic> injection traces drives
        # real sendto calls here, so the workload's wire behavior is
        # conformance-gated before the injection path replays it
        Workload("tgen", "tgen_main", seconds=10,
                 procs=((1, ("server",), 0),
                        (0, ("client", "server"), 1))),
    )
}

#: catalog slices tests and tools iterate over
DUAL_WORKLOADS = tuple(w.name for w in WORKLOADS.values() if w.host_ok)
FAST_DUAL_WORKLOADS = tuple(w.name for w in WORKLOADS.values()
                            if w.host_ok and not w.slow)
SIM_ONLY_WORKLOADS = tuple(w.name for w in WORKLOADS.values()
                           if not w.host_ok)


def _bundle(seconds: int, seed: int = 1, device=None):
    cfg = NetConfig(num_hosts=2, end_time=seconds * simtime.ONE_SECOND,
                    seed=seed)
    hosts = [HostSpec(name=HOST_NAMES[0], type="client"),
             HostSpec(name=HOST_NAMES[1], type="server")]
    return build(cfg, GRAPH, hosts, device=device)


def _env(bundle, hi: int, args) -> dict:
    # the loader's plugin env contract (config/loader.py:_vproc_entry)
    return {
        "host": bundle.host_names[hi],
        "host_index": hi,
        "args": list(args),
        "resolve": bundle.ip_of,
        "hosts": bundle.host_names,
        "cfg": bundle.cfg,
    }


def _resolve_fn(w: Workload):
    from shadow_tpu_torch.apps import reftests

    return getattr(reftests, w.fn_name)


def _spawn_all(w: Workload, bundle, target):
    fn = _resolve_fn(w)
    for hi, args, start_s in w.procs:
        env = _env(bundle, hi, args)
        target.spawn(hi, (lambda _h, m=fn, e=env: m(e)),
                     start_time=start_s * simtime.ONE_SECOND)


def _recorder(bundle) -> TraceRecorder:
    return TraceRecorder(ip_names={int(bundle.ip_of(n)): n
                                   for n in bundle.host_names})


def run_sim(name: str, seed: int = 1, device=None):
    """Run one cataloged workload under the simulation on `device`;
    returns the attached TraceRecorder."""
    from shadow_tpu_torch.process.vproc import ProcessRuntime

    w = WORKLOADS[name]
    bundle = _bundle(w.seconds, seed, device)
    rt = ProcessRuntime(bundle, device=device)
    rec = _recorder(bundle)
    rt.trace = rec
    _spawn_all(w, bundle, rt)
    rt.run()
    return rec


def run_host(name: str, seed: int = 1, time_scale: float = 0.05,
             device=None):
    """Run one cataloged workload on the real host kernel; returns
    the attached TraceRecorder. Raises PortsUnavailable in sandboxes
    with no bindable loopback ports (callers skip, not flake), and
    ValueError for sim-only workloads. The bundle (the programs' IPs
    and names) is built on `device`."""
    w = WORKLOADS[name]
    if not w.host_ok:
        raise ValueError(
            f"workload {name!r} is sim-only: {w.note or 'see catalog'}")
    PortAllocator.preflight()
    bundle = _bundle(w.seconds, seed, device)
    rec = _recorder(bundle)
    ex = HostKernelExecutor(
        bundle, time_scale=time_scale, trace=rec,
        portmap=PortMap(PortAllocator(seed=seed)))
    _spawn_all(w, bundle, ex)
    ex.run()
    return rec


@dataclass
class DualResult:
    name: str
    diff: DiffResult
    sim: dict = field(default_factory=dict)
    host: dict = field(default_factory=dict)


def run_dual(name: str, seed: int = 1, time_scale: float = 0.05,
             device=None) -> DualResult:
    """Run one workload both ways and diff the normalized traces."""
    sim_rec = run_sim(name, seed, device)
    host_rec = run_host(name, seed, time_scale, device)
    sim_n = sim_rec.normalized()
    host_n = host_rec.normalized()
    return DualResult(name=name, diff=diff_traces(sim_n, host_n),
                      sim=sim_n, host=host_n)


def conformance_block(names, seed: int = 1, time_scale: float = 0.05,
                      results: dict | None = None, device=None) -> dict:
    """Run `names` dual-mode and produce the run-manifest conformance
    block: per-workload verdicts plus agree/diverge counts. Workload
    errors are verdicts too ("error: ..."), not raised — a manifest
    should record a bad run, not abort on it. Pass `results` to
    collect each DualResult for reporting."""
    verdicts = {}
    agree = diverge = 0
    for name in names:
        try:
            res = run_dual(name, seed=seed, time_scale=time_scale,
                           device=device)
        except Exception as e:      # noqa: BLE001 — verdict, not crash
            verdicts[name] = f"error: {type(e).__name__}: {e}"
            diverge += 1
            continue
        if results is not None:
            results[name] = res
        if res.diff.agree:
            verdicts[name] = "agree"
            agree += 1
        else:
            verdicts[name] = "diverge"
            diverge += 1
    return {"workloads": verdicts, "agree": agree, "diverge": diverge,
            "total": len(verdicts)}
