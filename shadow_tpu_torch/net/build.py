"""Build and run a simulation from topology + host specs (PyTorch port
of shadow_tpu/net/build.py: HostSpec, SimBundle, build, make_runner,
make_chunked_runner and its window rules, run).

The startup path of the reference (ref: master.c:161-398): load the
topology, register every host with DNS, attach hosts to vertices from
the seeded draws, derive the conservative window from the minimum path
latency, initialize the struct-of-arrays state on the requested device
and seed PROC_START / PROC_STOP events (ref: process.c:1326-1360).

Every NetConfig setting is taken as the reference takes it, the
observability ones included (the pcap capture ring, per-path counters,
the virtual CPU), and so are its derived defaults (emit_capacity =
nic_drain + 6 with TCP). Runner arguments the port does not implement
yet raise NotImplementedError (refuse_unported). The apps the port
runs through these entry points: PHOLD (apps/phold.py, with its UDP
bulk pass), the disjoint and the shared-relay Tor models
(apps/relay.py, each with its TCP bulk pass), UDP and TCP gossip
(apps/gossip.py) — every workload of tools/scale_run.py — and the
config loader's device apps (config/loader.py: pingpong, bulk, echo,
randdump).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from dataclasses import replace as _dc_replace
from typing import Any, Sequence

import numpy as np
import torch

from shadow_tpu_torch.core.engine import (
    EngineStats,
    global_min_time,
    make_chunk_body,
    make_wend_fn,
    resolve_sparse_lanes,
)
from shadow_tpu_torch.core.engine import run as engine_run
from shadow_tpu_torch.core.events import EventKind, emit_words, push_rows
from shadow_tpu_torch.device import resolve_device, same_device
from shadow_tpu_torch.net.bulk import make_bulk_fn
from shadow_tpu_torch.net.state import (
    NetConfig,
    Sim,
    make_net_state,
    make_sim,
)
from shadow_tpu_torch.net.step import make_step_fn
from shadow_tpu_torch.net.tcp_bulk import make_tcp_bulk_fn
from shadow_tpu_torch.routing.dns import DNS
from shadow_tpu_torch.routing.graphml import parse_graphml
from shadow_tpu_torch.routing.topology import Topology
from shadow_tpu_torch.telemetry.flows import make_flow_fn
from shadow_tpu_torch.telemetry.ring import make_telem_fn


@dataclass
class HostSpec:
    """One virtual host (ref: <host> config element,
    configuration.h:62-101)."""

    name: str
    ip: str | None = None            # requested IP hint
    citycode: str | None = None
    countrycode: str | None = None
    geocode: str | None = None
    type: str | None = None
    bandwidthdown: int | None = None  # KiB/s override
    bandwidthup: int | None = None
    cpufrequency_khz: int | None = None
    proc_start_time: int | None = None  # PROC_START event time (ns)
    proc_stop_time: int | None = None   # PROC_STOP event time (ns)

    def hints(self) -> dict:
        out: dict = {}
        for k in ("ip", "citycode", "countrycode", "geocode", "type",
                  "bandwidthdown", "bandwidthup"):
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        return out


@dataclass
class SimBundle:
    cfg: NetConfig
    sim: Sim
    topology: Topology
    dns: DNS
    min_jump: int
    host_names: list[str]
    name_to_index: dict[str, int] = field(default_factory=dict)
    # Optional net.bulk.AppBulk of the bundle's app (e.g. phold.BULK):
    # utils.checkpoint.run_windows runs the bulk window pass with it.
    app_bulk: Any = None
    device: Any = None
    # Optional faults.plan.FaultPlan attached by faults.install():
    # every runner derives the window-boundary fault_fn from it (and
    # the boot sim) through faults.fault_fn_for(bundle).
    fault_plan: Any = None
    # Optional rebuild(overrides: dict) -> SimBundle: the whole build
    # (topology, app setup, fault install) again with capacity
    # overrides merged in — the escalation path's lever
    # (faults/escalate.py); a grown capacity needs a fresh Sim and
    # fresh step/fault closures. A rebuilt bundle is unspecialized:
    # the caller re-applies compile/specialize.py.
    rebuild: Any = None
    # Optional compile/specialize.Capabilities attached by
    # specialize.apply(): the runner factories pass it to
    # make_step_fn and the bulk passes, which leave out the work of
    # each dropped capability. None = the full (unspecialized) program.
    caps: Any = None

    def ip_of(self, name: str) -> int:
        return self.dns.resolve_name(name).ip

    def host_of(self, name: str) -> int:
        return self.name_to_index[name]


def build(cfg: NetConfig, graphml_text: str, hosts: Sequence[HostSpec],
          app: Any = None, device=None) -> SimBundle:
    """The boot SimBundle on `device` (None -> "cuda"; raises when CUDA
    is missing)."""
    dev = resolve_device(device)
    if len(hosts) != cfg.num_hosts:
        raise ValueError(f"cfg.num_hosts={cfg.num_hosts} != {len(hosts)} specs")
    top = Topology(parse_graphml(graphml_text))
    dns = DNS()
    names = []
    for i, h in enumerate(hosts):
        dns.register(i, h.name, requested_ip=h.ip)
        names.append(h.name)

    # attach draws come from the deterministic seed hierarchy
    # (ref: master.c:417 -> slave.c:301): one uniform per host in
    # registration order.
    draws = np.random.default_rng(cfg.seed).random(len(hosts))
    placement = top.attach_hosts([h.hints() for h in hosts], draws)
    min_jump = top.min_jump_ns(placement)

    # sequentially allocated IPs unlock the arithmetic IP path
    # (state.ip_of_hosts)
    host_ips = dns.host_ips(cfg.num_hosts)
    if cfg.num_hosts and np.array_equal(
            host_ips, host_ips[0] + np.arange(cfg.num_hosts)):
        cfg = _dc_replace(cfg, ip_affine_base=int(host_ips[0]))

    net = make_net_state(
        cfg,
        host_ips=host_ips,
        bw_up_kibps=placement.bw_up_kibps,
        bw_down_kibps=placement.bw_down_kibps,
        vertex_of_host=placement.vertex,
        latency_ns=top.latency_ns,
        reliability=top.reliability,
        cpu_freq_khz=np.array(
            [h.cpufrequency_khz or 0 for h in hosts], np.int64),
        device=dev,
    )
    sim = make_sim(cfg, net, app=app)

    # seed PROC_START / PROC_STOP events (ref: host_boot ->
    # process_schedule, process.c:1326-1360)
    H = cfg.num_hosts
    for attr, kind in ((lambda h: h.proc_start_time, EventKind.PROC_START),
                       (lambda h: h.proc_stop_time, EventKind.PROC_STOP)):
        times = np.full(H, -1, dtype=np.int64)
        for i, h in enumerate(hosts):
            t = attr(h)
            if t is not None:
                times[i] = t
        m = times >= 0
        if m.any():
            mt = torch.as_tensor(m, device=dev)
            q = push_rows(
                sim.events, mt,
                torch.as_tensor(np.where(m, times, 0), device=dev),
                torch.full((H,), kind, dtype=torch.int32, device=dev),
                torch.arange(H, dtype=torch.int32, device=dev),
                sim.events.next_seq,
                emit_words(0, num_hosts=H, device=dev),
            )
            q = q.replace(next_seq=q.next_seq + mt.to(torch.int32))
            sim = sim.replace(events=q)

    return SimBundle(
        cfg=cfg, sim=sim, topology=top, dns=dns, min_jump=min_jump,
        host_names=names, name_to_index={n: i for i, n in enumerate(names)},
        device=dev,
    )


def _resolve_bulk_fn(bundle: SimBundle, app_bulk, app_tcp_bulk=None,
                     tcp_bulk_lossless: bool = False, caps=None):
    """The reference's bulk-pass selection rule: the UDP bulk pass
    (net/bulk.py) wins when both are given and its static
    preconditions hold, else the TCP bulk pass (net/tcp_bulk.py) when
    `app_tcp_bulk` is given and the config supports it, else none.
    `tcp_bulk_lossless` builds the narrow loss-free TCP pass
    (bit-identical for any workload). `caps` is the bundle's capability
    vector (compile/specialize.py): the passes trim their reliability
    draws under it."""
    if app_bulk is not None:
        fn = make_bulk_fn(bundle.cfg, app_bulk, caps=caps)
        if fn is not None:
            return fn
    if app_tcp_bulk is not None:
        return make_tcp_bulk_fn(bundle.cfg, app_tcp_bulk,
                                lossless=tcp_bulk_lossless, caps=caps)
    return None


def _resolve_caps(bundle: SimBundle, caller_fault_fn):
    """The capability vector a runner may trim under. An explicit
    caller fault_fn is OPAQUE — its closure could rewrite any table
    (e.g. bring loss back) where the static analysis cannot see it — so
    a bundle with dropped capabilities refuses it: running the guarded
    sim under the full program would turn any such rewrite into a false
    fatal. The installed-plan path (bundle.fault_plan) stays
    trimmable: derive() already folded the plan's record kinds into
    the vector."""
    caps = getattr(bundle, "caps", None)
    if caller_fault_fn is not None:
        if caps is not None and caps.dropped():
            raise ValueError(
                "explicit fault_fn on a specialized bundle: an opaque "
                "fault rule defeats the static capability analysis — "
                "rebuild with specialize.apply(mode='off') or install "
                "the plan via faults.install()")
        return None
    return caps


def refuse_unported(**off) -> None:
    """NotImplementedError naming each argument given that the port does
    not take yet ({name: (value, its ROADMAP.md Queue 1 item)})."""
    given = [f"{k} (ROADMAP.md Queue 1 item {item})"
             for k, (v, item) in off.items() if v is not None]
    if given:
        raise NotImplementedError(
            "shadow_tpu_torch does not implement these arguments yet: "
            + ", ".join(given))


def adaptive_jump_spec(bundle: SimBundle):
    """Constants of the adaptive window rule (engine.make_wend_fn):
    ``(pair_mask, fault_times)``. pair_mask is the [V,V] bool set of
    vertex pairs that constrain the conservative window — ordered
    pairs of distinct host-bearing vertices, plus the self-path of a
    vertex carrying >= 2 hosts (topology.min_jump_ns's pair rules),
    evaluated against the live tables each window; fault_times is
    plan_times(bundle)."""
    voh = bundle.sim.net.vertex_of_host.cpu().numpy()
    V = int(bundle.sim.net.latency_ns.shape[0])
    mask = np.zeros((V, V), dtype=bool)
    if voh.size:
        verts, counts = np.unique(voh, return_counts=True)
        mask[np.ix_(verts, verts)] = True
        mask[np.arange(V), np.arange(V)] = False
        for v, c in zip(verts, counts):
            if c >= 2:
                mask[v, v] = True
    return mask, plan_times(bundle)


def _resolve_fault_fn(bundle: SimBundle, fault_fn):
    """Every runner applies a bundle's installed fault plan by default —
    a schedule must hold wherever the bundle runs. An explicit fault_fn
    overrides."""
    if fault_fn is not None:
        return fault_fn
    if getattr(bundle, "fault_plan", None) is not None:
        from shadow_tpu_torch.faults.apply import fault_fn_for

        return fault_fn_for(bundle)
    return None


def plan_times(bundle: SimBundle):
    """The installed fault plan's unique record times (None without a
    plan) — the wend clamp every window rule shares, so records land at
    window boundaries exactly."""
    plan = getattr(bundle, "fault_plan", None)
    if plan is not None and getattr(plan, "n", 0):
        return np.unique(np.asarray(plan.t_ns, np.int64))
    return None


def resolve_wend_fn(bundle: SimBundle, end_time: int, adaptive: bool,
                    fault_fn=None):
    """The window-end rule of the chunked runners: the static
    ``wstart + min_jump`` (adaptive=False) or the live-table adaptive
    jump, both clamped at the plan's record times. `fault_fn` is the
    rule the runner resolved: the adaptive jump needs the plan's record
    times to stay conservative, so an opaque fault_fn with no installed
    plan raises ValueError. With a plan the adaptive rule sizes each
    window from the plan replay at ``wstart + 1``
    (faults.apply.make_table_fn, host tables), never from the live
    tables that step_window rewrites only after the span is chosen."""
    if not adaptive:
        return make_wend_fn(min_jump=bundle.min_jump, end_time=end_time,
                            fault_times=plan_times(bundle))
    plan = getattr(bundle, "fault_plan", None)
    if fault_fn is not None and plan is None:
        raise ValueError(
            "adaptive_jump requires the fault plan's record times "
            "(faults.install) — cannot bound an opaque fault_fn's "
            "table rewrites")
    mask, ft = adaptive_jump_spec(bundle)
    tf = None
    if plan is not None:
        from shadow_tpu_torch.faults.apply import make_table_fn

        tf = make_table_fn(plan, bundle.sim)
    return make_wend_fn(min_jump=bundle.min_jump, end_time=end_time,
                        pair_mask=mask, fault_times=ft, table_fn=tf)


def _runner_device(bundle: SimBundle, device):
    dev = resolve_device(device)
    if bundle.device is not None and not same_device(bundle.device, dev):
        raise ValueError(f"bundle was built on {bundle.device}, runner "
                         f"asked for {dev}")
    return dev


def _check_sim_device(sim, dev) -> None:
    if not same_device(sim.events.time.device, dev):
        raise ValueError(f"sim lies on {sim.events.time.device}, runner "
                         f"runs on {dev}")


def make_runner(bundle: SimBundle, app_handlers=(),
                end_time: int | None = None, app_bulk=None,
                app_tcp_bulk=None, tcp_bulk_lossless: bool = False,
                device=None, fault_fn=None):
    """A sim -> (sim, stats) callable for the whole run on `device`
    (None -> "cuda"; raises when CUDA is missing or the bundle was
    built on another device).

    `app_bulk` (a net.bulk.AppBulk, e.g. apps.phold.BULK) turns on the
    UDP bulk window pass; `app_tcp_bulk` (a net.tcp_bulk.TcpAppBulk,
    e.g. apps.relay.TCP_BULK or apps.relay.MUX_TCP_BULK) the TCP bulk
    window pass, narrowed to
    its loss-free model by `tcp_bulk_lossless`. The sparse fast path
    runs at the config's resolved budget
    (core/engine.resolve_sparse_lanes), and a telemetry ring, flow ring
    or causality planes attached to the input sim (telemetry.attach,
    attach_flows, attach_causality) record every window; a lane-isolated
    sim (core.lanes.attach) runs the lane barrier. The
    bundle's installed fault plan (faults.install) applies at every
    window boundary unless an explicit `fault_fn` replaces it.

    The runner's `bulk_fn` attribute is its bulk pass (None without
    one), read at each call: a caller may wrap it, e.g. to time the
    pass.

    A specialized bundle (compile/specialize.py apply) runs its trimmed
    program; an explicit `fault_fn` on one raises ValueError
    (_resolve_caps)."""
    dev = _runner_device(bundle, device)
    caps = _resolve_caps(bundle, fault_fn)
    step = make_step_fn(bundle.cfg, app_handlers, caps=caps)
    end = end_time if end_time is not None else bundle.cfg.end_time
    bulk_fn = _resolve_bulk_fn(bundle, app_bulk, app_tcp_bulk,
                               tcp_bulk_lossless, caps=caps)
    telem_fn = make_telem_fn()
    flow_fn = make_flow_fn()
    sparse = resolve_sparse_lanes(bundle.cfg)
    fault_fn = _resolve_fault_fn(bundle, fault_fn)

    def go(sim):
        _check_sim_device(sim, dev)
        return engine_run(
            sim, step, end_time=end, min_jump=bundle.min_jump,
            emit_capacity=bundle.cfg.emit_capacity,
            lane_id=sim.net.lane_id, bulk_fn=go.bulk_fn, telem_fn=telem_fn,
            sparse_lanes=sparse, fault_times=plan_times(bundle),
            fault_fn=fault_fn, flow_fn=flow_fn)

    go.bulk_fn = bulk_fn
    return go


def make_chunked_runner(bundle: SimBundle, app_handlers=(),
                        end_time: int | None = None, app_bulk=None,
                        app_tcp_bulk=None, chunk_windows: int = 256,
                        tcp_bulk_lossless: bool = False,
                        adaptive_jump: bool = False, device=None,
                        fault_fn=None, warm_start=None,
                        compile_info=None):
    """make_runner's variant that runs `chunk_windows` windows per
    chunk (engine.make_chunk_body) under a host loop — window for
    window the sequence engine.run produces, so the result is the
    same. `adaptive_jump` takes the live-table window rule
    (resolve_wend_fn); on a graph where no latency changes it gives
    the static partition. The caller's sim is left as it was (the
    state is never written in place). Device rules, the fault plan
    and the specialization are make_runner's.

    `warm_start` and `compile_info` (ROADMAP.md Queue 1 item 11b) are
    not ported yet and raise NotImplementedError."""
    if chunk_windows < 1:
        raise ValueError(
            f"chunk_windows must be >= 1, got {chunk_windows} "
            "(0 iterations would spin the host loop forever)")
    refuse_unported(warm_start=(warm_start, "11b"),
                    compile_info=(compile_info, "11b"))
    dev = _runner_device(bundle, device)
    caps = _resolve_caps(bundle, fault_fn)
    step = make_step_fn(bundle.cfg, app_handlers, caps=caps)
    end = int(end_time if end_time is not None else bundle.cfg.end_time)
    bulk_fn = _resolve_bulk_fn(bundle, app_bulk, app_tcp_bulk,
                               tcp_bulk_lossless, caps=caps)
    fault_fn = _resolve_fault_fn(bundle, fault_fn)
    chunk = make_chunk_body(
        step, end_time=end,
        wend_fn=resolve_wend_fn(bundle, end, adaptive_jump, fault_fn),
        chunk_windows=int(chunk_windows),
        emit_capacity=bundle.cfg.emit_capacity,
        lane_fn=lambda s: s.net.lane_id, bulk_fn=bulk_fn,
        telem_fn=make_telem_fn(),
        sparse_lanes=resolve_sparse_lanes(bundle.cfg), fault_fn=fault_fn,
        flow_fn=make_flow_fn())

    def go(sim):
        _check_sim_device(sim, dev)
        stats = EngineStats.create(device=dev)
        # engine.run's first-window rule: staged injection joins it
        wstart = int(global_min_time(sim))
        while wstart <= end:
            sim, stats, wstart = chunk(sim, stats, wstart)
        return sim, stats

    return go


def run(bundle: SimBundle, app_handlers=(), end_time: int | None = None,
        app_bulk=None, app_tcp_bulk=None, tcp_bulk_lossless: bool = False,
        device=None, fault_fn=None):
    """Run the whole simulation; returns (sim, stats)."""
    return make_runner(bundle, app_handlers, end_time, app_bulk=app_bulk,
                       app_tcp_bulk=app_tcp_bulk,
                       tcp_bulk_lossless=tcp_bulk_lossless,
                       device=device, fault_fn=fault_fn)(bundle.sim)
