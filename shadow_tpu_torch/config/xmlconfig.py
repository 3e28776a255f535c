"""shadow.config.xml parser (a copy of shadow_tpu/config/xmlconfig.py:
the port keeps its own, stdlib only) — format-compatible with the reference's
GMarkup Configuration (ref: configuration.c, configuration.h:24-108),
covering both element generations the reference accepts:
`<node>`/`<application>` (1.x configs, e.g.
src/test/phold/phold.test.shadow.config.xml) and
`<host>`/`<process>`, plus `<kill time="..."/>` and the
`<shadow stoptime bootstraptime>` attributes.

Plugins cannot be ELF .so paths on a TPU (SURVEY.md §7.1): the
`path` of a `<plugin>` names an app model from the plugin registry
(builtin: phold, pingpong, bulk/tgen; extendable via
register_plugin). `arguments` strings are passed through to the
model's configure hook, split shell-style.
"""

from __future__ import annotations

import shlex
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class PluginSpec:
    id: str
    path: str                      # model name (see plugins registry)


@dataclass
class ProcessSpec:
    plugin: str
    starttime: int                 # ns
    stoptime: Optional[int]        # ns
    arguments: list[str] = field(default_factory=list)


@dataclass
class HostElem:
    """One <host>/<node> element (pre-quantity expansion)
    (ref: configuration.h:62-101)."""

    id: str
    quantity: int = 1
    iphint: Optional[str] = None
    citycodehint: Optional[str] = None
    countrycodehint: Optional[str] = None
    geocodehint: Optional[str] = None
    typehint: Optional[str] = None
    bandwidthdown: Optional[int] = None    # KiB/s
    bandwidthup: Optional[int] = None
    socketrecvbuffer: Optional[int] = None
    socketsendbuffer: Optional[int] = None
    interfacebuffer: Optional[int] = None
    qdisc: Optional[str] = None
    loglevel: Optional[str] = None
    heartbeatfrequency: Optional[int] = None  # seconds
    logpcap: bool = False
    processes: list[ProcessSpec] = field(default_factory=list)


@dataclass
class FaultSpec:
    """One <fault> element — an entry in the run's deterministic fault
    schedule (shadow-tpu extension; the reference only has static
    per-path reliability). `a`/`b` are host *names* (resolved to host
    or attachment-vertex indices by faults.plan.records_from_config
    once placement is known) or raw indices. `value` is a loss
    probability (kind="loss") or seconds of added latency
    (kind="latency").

      <fault time="1.5" kind="linkdown" a="client" b="server"/>
      <fault time="2.0" kind="loss"     a="client" b="server" value="0.05"/>
      <fault time="3.0" kind="crash"    a="relay"/>
      <fault time="4.0" kind="restart"  a="relay"/>
    """

    time_ns: int
    kind: str
    a: str
    b: Optional[str] = None
    value: Optional[float] = None


@dataclass
class TrafficPhase:
    """One phase of a <traffic> element's open-loop schedule. Which
    fields mean anything depends on `kind`:

    - stream: `rate` events/s for `count` events or `duration`
      seconds (whichever is given; count wins when both are).
    - pause: silence for `duration` seconds.
    - markov: a two-state on/off chain sampled per send slot at
      `rate` — in ON the slot emits, then flips OFF with p_off; in
      OFF it stays silent, then flips ON with p_on. `seed` makes the
      sampled trace reproducible (and part of the config, so two
      runs of one config inject identical events).
    """

    kind: str                      # stream | pause | markov
    rate: float = 1.0              # events/s (stream, markov)
    count: Optional[int] = None    # stream: stop after N events
    duration_ns: Optional[int] = None
    size: int = 64                 # payload bytes carried per event
    p_on: float = 0.5              # markov OFF->ON per slot
    p_off: float = 0.5             # markov ON->OFF per slot
    seed: int = 0                  # markov sampling stream


@dataclass
class TrafficSpec:
    """One <traffic> element — a tgen-style open-system workload
    (shadow-tpu extension): an external source drives `host` on a
    declarative phase schedule, compiled by apps/tgen.py into an
    injection trace that streams in through inject/feeder.py instead
    of living in the closed-loop event population.

      <traffic id="crowd" host="client" dst="server" start="1.0">
        <stream rate="2000" count="500" size="512"/>
        <pause duration="0.5"/>
        <markov rate="4000" duration="2.0" p_on="0.2" p_off="0.6"/>
      </traffic>

    `host`/`dst` are host names (indices resolved once placement is
    known, like FaultSpec); `dst` defaults to `host` itself (self-
    directed work, the PHOLD shape).
    """

    id: str
    host: str
    dst: Optional[str] = None
    start_ns: int = 0
    port: int = 9100               # UDP dst port tgen sends to
    phases: list[TrafficPhase] = field(default_factory=list)


@dataclass
class ShadowConfig:
    stoptime: int                  # ns
    bootstraptime: int             # ns
    topology_text: Optional[str]   # inline GraphML
    topology_path: Optional[str]
    plugins: dict[str, PluginSpec]
    hosts: list[HostElem]
    faults: list[FaultSpec] = field(default_factory=list)
    traffics: list[TrafficSpec] = field(default_factory=list)

    def expanded_hosts(self):
        """Yield (name, HostElem) with quantity stamped out the way the
        reference does (hostname, hostname2, hostname3, ...; ref:
        master.c host registration loop)."""
        for h in self.hosts:
            for i in range(h.quantity):
                name = h.id if i == 0 else f"{h.id}{i + 1}"
                yield name, h


_SECONDS = 1_000_000_000


def _seconds_attr(elem, *names, default=None):
    for n in names:
        v = elem.get(n)
        if v is not None:
            return int(float(v) * _SECONDS)
    return default


def _int_attr(elem, *names, default=None):
    for n in names:
        v = elem.get(n)
        if v is not None:
            return int(v)
    return default


def parse_config(text: str) -> ShadowConfig:
    root = ET.fromstring(text)
    if root.tag != "shadow":
        raise ValueError(f"root element must be <shadow>, got <{root.tag}>")

    stoptime = _seconds_attr(root, "stoptime", default=None)
    bootstraptime = _seconds_attr(root, "bootstraptime", default=0)

    topology_text = None
    topology_path = None
    plugins: dict[str, PluginSpec] = {}
    hosts: list[HostElem] = []
    faults: list[FaultSpec] = []
    traffics: list[TrafficSpec] = []

    for child in root:
        if child.tag == "kill":
            stoptime = _seconds_attr(child, "time", default=stoptime)
        elif child.tag == "topology":
            topology_path = child.get("path")
            if child.text and child.text.strip():
                topology_text = child.text
        elif child.tag == "plugin":
            pid = child.get("id")
            if pid is None:
                raise ValueError("<plugin> requires id")
            plugins[pid] = PluginSpec(id=pid, path=child.get("path", pid))
        elif child.tag in ("host", "node"):
            hid = child.get("id")
            if hid is None:
                raise ValueError(f"<{child.tag}> requires id")
            he = HostElem(
                id=hid,
                quantity=_int_attr(child, "quantity", default=1),
                iphint=child.get("iphint") or child.get("ip"),
                citycodehint=child.get("citycodehint"),
                countrycodehint=child.get("countrycodehint"),
                geocodehint=child.get("geocodehint"),
                typehint=child.get("typehint"),
                bandwidthdown=_int_attr(child, "bandwidthdown"),
                bandwidthup=_int_attr(child, "bandwidthup"),
                socketrecvbuffer=_int_attr(child, "socketrecvbuffer"),
                socketsendbuffer=_int_attr(child, "socketsendbuffer"),
                interfacebuffer=_int_attr(child, "interfacebuffer"),
                qdisc=child.get("interfacequeue") or child.get("qdisc"),
                loglevel=child.get("loglevel"),
                heartbeatfrequency=_int_attr(child, "heartbeatfrequency"),
                logpcap=child.get("logpcap", "false").lower() == "true",
            )
            for sub in child:
                if sub.tag in ("process", "application"):
                    plugin = sub.get("plugin")
                    if plugin is None:
                        raise ValueError(f"<{sub.tag}> requires plugin")
                    he.processes.append(ProcessSpec(
                        plugin=plugin,
                        starttime=_seconds_attr(sub, "starttime", "time",
                                                default=0),
                        stoptime=_seconds_attr(sub, "stoptime"),
                        arguments=shlex.split(sub.get("arguments", "")),
                    ))
            hosts.append(he)
        elif child.tag == "fault":
            t = _seconds_attr(child, "time", default=None)
            if t is None:
                raise ValueError("<fault> requires time")
            kind = child.get("kind")
            a = child.get("a")
            if kind is None or a is None:
                raise ValueError("<fault> requires kind and a")
            v = child.get("value")
            faults.append(FaultSpec(
                time_ns=t, kind=kind, a=a, b=child.get("b"),
                value=None if v is None else float(v)))
        elif child.tag == "traffic":
            hid = child.get("host") or child.get("src")
            if hid is None:
                raise ValueError("<traffic> requires host")
            phases = []
            for sub in child:
                if sub.tag == "stream":
                    phases.append(TrafficPhase(
                        kind="stream",
                        rate=float(sub.get("rate", "1")),
                        count=_int_attr(sub, "count"),
                        duration_ns=_seconds_attr(sub, "duration"),
                        size=_int_attr(sub, "size", default=64)))
                elif sub.tag == "pause":
                    phases.append(TrafficPhase(
                        kind="pause",
                        duration_ns=_seconds_attr(
                            sub, "duration", default=_SECONDS)))
                elif sub.tag == "markov":
                    phases.append(TrafficPhase(
                        kind="markov",
                        rate=float(sub.get("rate", "1")),
                        duration_ns=_seconds_attr(
                            sub, "duration", default=_SECONDS),
                        size=_int_attr(sub, "size", default=64),
                        p_on=float(sub.get("p_on", "0.5")),
                        p_off=float(sub.get("p_off", "0.5")),
                        seed=_int_attr(sub, "seed", default=0)))
                else:
                    raise ValueError(
                        f"<traffic> phase <{sub.tag}> unknown "
                        f"(stream | pause | markov)")
            if not phases:
                raise ValueError(
                    f"<traffic host={hid!r}> has no phases")
            traffics.append(TrafficSpec(
                id=child.get("id", hid), host=hid,
                dst=child.get("dst"),
                start_ns=_seconds_attr(child, "start", default=0),
                port=_int_attr(child, "port", default=9100),
                phases=phases))
        # unknown elements are ignored (forward compatible)

    if stoptime is None:
        raise ValueError("config must set <shadow stoptime> or <kill time>")
    if topology_text is None and topology_path is None:
        raise ValueError("config must provide a <topology>")
    return ShadowConfig(
        stoptime=stoptime,
        bootstraptime=bootstraptime,
        topology_text=topology_text,
        topology_path=topology_path,
        plugins=plugins,
        hosts=hosts,
        faults=sorted(faults, key=lambda f: f.time_ns),
        traffics=traffics,
    )


def kv_arguments(args: list[str]) -> dict[str, str]:
    """The reference's phold-style `key=value` argument convention
    (test_phold.c argument parsing)."""
    out = {}
    for a in args:
        if "=" in a:
            k, v = a.split("=", 1)
            out[k] = v
    return out
