"""Build and run a simulation from topology + host specs (PyTorch port
of shadow_tpu/net/build.py: HostSpec, SimBundle, build, make_runner,
run).

The startup path of the reference (ref: master.c:161-398): load the
topology, register every host with DNS, attach hosts to vertices from
the seeded draws, derive the conservative window from the minimum path
latency, initialize the struct-of-arrays state on the requested device
and seed PROC_START / PROC_STOP events (ref: process.c:1326-1360).

Settings of NetConfig that the port does not implement yet raise
NotImplementedError here (the list is in ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from dataclasses import replace as _dc_replace
from typing import Any, Sequence

import numpy as np
import torch

from shadow_tpu_torch.core.engine import resolve_sparse_lanes
from shadow_tpu_torch.core.engine import run as engine_run
from shadow_tpu_torch.core.events import EventKind, emit_words, push_rows
from shadow_tpu_torch.device import resolve_device, same_device
from shadow_tpu_torch.net.state import (
    NetConfig,
    QDisc,
    RouterQ,
    Sim,
    make_net_state,
    make_sim,
)
from shadow_tpu_torch.net.step import make_step_fn
from shadow_tpu_torch.routing.dns import DNS
from shadow_tpu_torch.routing.graphml import parse_graphml
from shadow_tpu_torch.routing.topology import Topology


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
    device: Any = None

    def ip_of(self, name: str) -> int:
        return self.dns.resolve_name(name).ip

    def host_of(self, name: str) -> int:
        return self.name_to_index[name]


def check_supported(cfg: NetConfig) -> None:
    """Raise NotImplementedError for settings off the port's path."""
    off = []
    if cfg.tcp:
        off.append("tcp=True")
    if cfg.pcap:
        off.append("pcap=True")
    if cfg.track_paths:
        off.append("track_paths=True")
    if cfg.cpu_threshold_ns >= 0:
        off.append(f"cpu_threshold_ns={cfg.cpu_threshold_ns} (virtual CPU)")
    if resolve_sparse_lanes(cfg) > 0:
        off.append(f"sparse_lanes resolving to {resolve_sparse_lanes(cfg)} "
                   "(set sparse_lanes=0)")
    if cfg.inject_lanes:
        off.append(f"inject_lanes={cfg.inject_lanes} (injection)")
    if cfg.qdisc != QDisc.FIFO:
        off.append(f"qdisc={cfg.qdisc} (round-robin)")
    if cfg.router_qdisc != RouterQ.CODEL:
        off.append(f"router_qdisc={cfg.router_qdisc}")
    if off:
        raise NotImplementedError(
            "shadow_tpu_torch does not implement these settings yet "
            "(see ROADMAP.md): " + ", ".join(off))


def build(cfg: NetConfig, graphml_text: str, hosts: Sequence[HostSpec],
          app: Any = None, device=None) -> SimBundle:
    """The boot SimBundle on `device` (None -> "cuda"; raises when CUDA
    is missing)."""
    dev = resolve_device(device)
    check_supported(cfg)
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


def make_runner(bundle: SimBundle, app_handlers=(),
                end_time: int | None = None, device=None):
    """A sim -> (sim, stats) callable for the whole run on `device`
    (None -> "cuda"; raises when CUDA is missing or the bundle was
    built on another device)."""
    dev = resolve_device(device)
    if bundle.device is not None and not same_device(bundle.device, dev):
        raise ValueError(f"bundle was built on {bundle.device}, runner "
                         f"asked for {dev}")
    check_supported(bundle.cfg)
    step = make_step_fn(bundle.cfg, app_handlers)
    end = end_time if end_time is not None else bundle.cfg.end_time

    def go(sim):
        if not same_device(sim.events.time.device, dev):
            raise ValueError(f"sim lies on {sim.events.time.device}, runner "
                             f"runs on {dev}")
        return engine_run(
            sim, step, end_time=end, min_jump=bundle.min_jump,
            emit_capacity=bundle.cfg.emit_capacity,
            lane_id=sim.net.lane_id)

    return go


def run(bundle: SimBundle, app_handlers=(), end_time: int | None = None,
        device=None):
    """Run the whole simulation; returns (sim, stats)."""
    return make_runner(bundle, app_handlers, end_time,
                       device=device)(bundle.sim)
