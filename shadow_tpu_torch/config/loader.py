"""Build a runnable simulation from a parsed ShadowConfig (PyTorch port
of shadow_tpu/config/loader.py) — the analog of master's
load-configuration + register-plugins + register-hosts path (ref:
master.c:161-398): the plugin registry, every device plugin's
configure and capacity hints, the reference's precedence of overrides,
hints and host attributes, the <fault> install and the rebuild closure
of the supervisor's escalation.

<traffic> elements compile to an injection trace before the build
(apps/tgen.py; `LoadedSim.inject_events`, which the CLI streams through
inject.Feeder) and size the staging lanes; a traffic-only config runs
the tgen app on every host.

Plugins the port cannot run yet are refused by name before the device
build, each with the ROADMAP.md item it waits for: `.py` plugins and
the reftests syscall plugins (virtual processes, Queue 1 item 10b). The
reference registers `testrandom` twice and its second registration,
the reftests syscall plugin, wins; so the port refuses it with the
other reftests names, and the randdump model stays reachable as
`testdeterminism`.
"""

from __future__ import annotations

import pathlib
from dataclasses import dataclass
from typing import Callable

import numpy as np

from shadow_tpu_torch.config.xmlconfig import ShadowConfig, kv_arguments
from shadow_tpu_torch.core import simtime
from shadow_tpu_torch.net import tcp_cong
from shadow_tpu_torch.net.build import HostSpec, SimBundle, build
from shadow_tpu_torch.net.state import NetConfig, QDisc, RouterQ

# plugin name -> configure(bundle, assignments) -> handlers tuple.
# assignments: list of (host_index, ProcessSpec). configure must set
# bundle.sim (app state installed) and return the app handler(s). An
# optional `hints(assignments) -> dict of NetConfig overrides` sizes
# the fixed-capacity rings before the build.
_REGISTRY: dict[str, Callable] = {}

# plugin name -> why the port refuses it (names the reference registers
# whose mechanism is not ported yet)
_REFUSED: dict[str, str] = {}

_VPROC_ITEM = ("virtual processes (process/vproc.py) are not ported "
               "yet: ROADMAP.md Queue 1 item 10b")


def register_plugin(name: str, configure: Callable, hints: Callable = None):
    if hints is not None:
        configure.hints = hints
    _REFUSED.pop(name, None)
    _REGISTRY[name] = configure


def plugin_names():
    """The device plugins the port runs."""
    return sorted(_REGISTRY)


def refused_plugins() -> dict[str, str]:
    """{plugin name: reason} of the reference's plugins the port
    refuses."""
    return dict(_REFUSED)


def _roles(bundle: SimBundle, assignments, mode_of, server_of):
    """(client mask, server mask, server name) from each assignment's
    role: mode_of(spec) -> "server" or not; server_of(spec) -> the
    server host's name or None. The last client that names a server
    wins, as in the reference."""
    H = bundle.cfg.num_hosts
    client = np.zeros(H, bool)
    server = np.zeros(H, bool)
    server_name = None
    for hi, spec in assignments:
        if mode_of(spec) == "server":
            server[hi] = True
        else:
            client[hi] = True
            name = server_of(spec)
            if name is not None:
                server_name = name
    return client, server, server_name


def _server_ip(bundle: SimBundle, server, server_name) -> int:
    """The named server's IP; no name means the first server host."""
    if server_name is None:
        si = int(np.argmax(server))
        return int(bundle.dns.host_ips(bundle.cfg.num_hosts)[si])
    return bundle.ip_of(server_name)


def _kv_mode(spec):
    return kv_arguments(spec.arguments).get("mode", "client")


def _kv_server(spec):
    return kv_arguments(spec.arguments).get("server")


def _configure_phold(bundle: SimBundle, assignments):
    from shadow_tpu_torch.apps import phold

    load = 25
    port = 9000
    for _, spec in assignments:
        kv = kv_arguments(spec.arguments)
        load = int(kv.get("load", load))
        port = int(kv.get("port", port))
    bundle.sim = phold.setup(bundle.sim, load=load, port=port)
    bundle.app_bulk = phold.BULK
    return (phold.handler,)


def _configure_pingpong(bundle: SimBundle, assignments):
    from shadow_tpu_torch.apps import pingpong

    port, count, size = 5000, 10, 64
    for _, spec in assignments:
        kv = kv_arguments(spec.arguments)
        port = int(kv.get("port", port))
        count = int(kv.get("count", count))
        size = int(kv.get("size", size))
    client, server, name = _roles(bundle, assignments, _kv_mode, _kv_server)
    bundle.sim = pingpong.setup(
        bundle.sim, client_mask=client, server_mask=server,
        server_ip=_server_ip(bundle, server, name), server_port=port,
        count=count, size=size)
    return (pingpong.handler,)


def _configure_bulk(bundle: SimBundle, assignments):
    from shadow_tpu_torch.apps import bulk

    port, nbytes = 8080, 1 << 20
    for _, spec in assignments:
        kv = kv_arguments(spec.arguments)
        port = int(kv.get("port", port))
        nbytes = int(kv.get("bytes", nbytes))
    client, server, name = _roles(bundle, assignments, _kv_mode, _kv_server)
    bundle.sim = bulk.setup(
        bundle.sim, client_mask=client, server_mask=server,
        server_ip=_server_ip(bundle, server, name), server_port=port,
        total_bytes=nbytes)
    return (bulk.handler,)


def _phold_hints(assignments):
    load = 25
    for _, spec in assignments:
        kv = kv_arguments(spec.arguments)
        load = int(kv.get("load", load))
    # random targeting makes per-host event populations bursty; 4x the
    # mean in-flight count keeps overflow at zero in practice (and
    # overflow is counted, never silent, if it ever isn't)
    cap = max(32, 4 * load)
    return {"event_capacity": cap, "outbox_capacity": cap,
            "router_ring": cap, "in_ring": max(16, 2 * load),
            "tcp": False}


def _tcp_stream_hints(assignments, n_clients=None):
    # A conservative window can deliver a full receive window of
    # in-flight segments at once and a fan-in server absorbs bursts
    # from many concurrent senders: provision the event rows, outbox
    # and router ring for the aggregate burst (overflow is counted,
    # never silent, if these still prove small). A many-client server
    # needs listener + active child + a full accept backlog
    # (ACCEPT_QUEUE=4): 8 socket slots, with SYN-retry backpressure
    # beyond. tcp True: in a mixed config the max-merge over plugin
    # hints must keep the TCP machine.
    if n_clients is None:
        n_clients = sum(1 for _, spec in assignments
                        if _kv_mode(spec) != "server")
    cap = min(4096, max(256, 64 * max(n_clients, 1)))
    return {"event_capacity": cap, "outbox_capacity": cap,
            "router_ring": cap, "sockets_per_host": 8, "tcp": True}


def _udp_only_hints(assignments):
    # pingpong is UDP-only: skip building the TCP machine
    return {"tcp": False}


def _configure_tgen(bundle: SimBundle, assignments):
    """Open-system traffic endpoints (apps/tgen.py): every host binds
    the tgen UDP socket; the send schedule itself comes from the
    config's <traffic> elements (or --inject-trace), not from here."""
    from shadow_tpu_torch.apps import tgen

    port = 9100
    for _, spec in assignments:
        kv = kv_arguments(spec.arguments)
        port = int(kv.get("port", port))
    bundle.sim = tgen.setup(bundle.sim, port=port)
    return (tgen.handler,)


_configure_phold.hints = _phold_hints
_configure_bulk.hints = _tcp_stream_hints
_configure_pingpong.hints = _udp_only_hints
_configure_tgen.hints = _udp_only_hints


def _testtcp_mode(spec):
    args = list(spec.arguments)
    return args[1] if len(args) > 1 else "server"


def _testtcp_server(spec):
    args = list(spec.arguments)
    return args[2] if len(args) > 2 else None


def _configure_testtcp(bundle: SimBundle, assignments):
    """The reference's dual-mode tcp test plugin (shd-test-tcp):
    positional arguments `<iomode> server` / `<iomode> client
    <server-hostname>` (test_tcp.c:28 USAGE). All io modes share one
    wire behavior — a 20,000-byte echo — so they map onto apps/echo.py."""
    from shadow_tpu_torch.apps import echo

    client, server, name = _roles(bundle, assignments, _testtcp_mode,
                                  _testtcp_server)
    if name in ("localhost", "127.0.0.1"):
        # the loopback configs run client and server on ONE host; the
        # 127.0.0.1 address rides the 1 ns loopback path (ref:
        # network_interface.c:546-554)
        server_ip = 0x7F000001
    else:
        server_ip = _server_ip(bundle, server, name)
    # the reference announces an ephemeral port over a message queue
    # (test_tcp.c:197-206); a fixed well-known port is the same wire
    bundle.sim = echo.setup(
        bundle.sim, client_mask=client, server_mask=server,
        server_ip=server_ip, server_port=9999)
    return (echo.handler,)


def _testtcp_hints(assignments):
    # client/server is the SECOND positional argument here; specs too
    # short to say are servers, matching _configure_testtcp
    n_clients = sum(1 for _, spec in assignments
                    if _testtcp_mode(spec) != "server")
    return _tcp_stream_hints(assignments, n_clients=n_clients)


_configure_testtcp.hints = _testtcp_hints


def _configure_testudp(bundle: SimBundle, assignments):
    """The reference's udp test plugin (test-udp): positional arguments
    `client <port>` / `server <port>`; the client sends one datagram
    to the server's port and the server echoes it back (test_udp.c
    test_sendto_one_byte) — the pingpong model with count=1, size=1."""
    from shadow_tpu_torch.apps import pingpong

    port = 5678
    for _, spec in assignments:
        args = list(spec.arguments)
        if len(args) > 1 and args[1].isdigit():
            port = int(args[1])
    client, server, _ = _roles(
        bundle, assignments,
        lambda spec: (list(spec.arguments) or ["server"])[0],
        lambda spec: None)
    bundle.sim = pingpong.setup(
        bundle.sim, client_mask=client, server_mask=server,
        server_ip=_server_ip(bundle, server, None), server_port=port,
        count=1, size=1)
    return (pingpong.handler,)


def _configure_testdeterminism(bundle: SimBundle, assignments):
    """The reference's determinism fixture plugin
    (shadow-plugin-test-determinism): every host dumps values from the
    simulated random sources; two runs must be byte-identical. Maps to
    the randdump model over the per-host counter streams."""
    from shadow_tpu_torch.apps import randdump

    bundle.sim = randdump.setup(bundle.sim)
    return (randdump.handler,)


for _name in ("phold", "shadow-plugin-test-phold"):
    register_plugin(_name, _configure_phold)
for _name in ("testtcp", "shadow-plugin-test-tcp",
              "libshadow-plugin-test-tcp.so"):
    register_plugin(_name, _configure_testtcp)
for _name in ("testdeterminism", "shadow-plugin-test-determinism"):
    register_plugin(_name, _configure_testdeterminism)
for _name in ("testudp", "test-udp"):
    register_plugin(_name, _configure_testudp)
for _name in ("pingpong", "tgen-ping"):
    register_plugin(_name, _configure_pingpong)
for _name in ("bulk", "tgen-bulk", "filetransfer"):
    register_plugin(_name, _configure_bulk)
register_plugin("tgen", _configure_tgen)

# the reference's reftests syscall plugins (virtual processes)
for _name in (
        "testbind", "libshadow-plugin-test-bind.so",
        "testepoll", "libshadow-plugin-test-epoll.so",
        "test_epoll_writeable", "libshadow-plugin-test-epoll-writeable.so",
        "testpoll", "libshadow-plugin-test-poll.so",
        "testsockbuf", "libshadow-plugin-test-sockbuf.so",
        "testtimerfd", "libshadow-plugin-test-timerfd.so",
        "testsleep", "libshadow-plugin-test-sleep.so",
        "testshutdown", "libshadow-plugin-test-shutdown.so",
        "testfile", "libshadow-plugin-test-file.so",
        "testrandom", "shadow-plugin-test-random",
        "testsignal", "libshadow-plugin-test-signal.so",
        "testpthreads", "libshadow-plugin-test-pthreads.so",
        "test-unistd", "testunistd"):
    _REFUSED[_name] = f"the reftests syscall plugin: {_VPROC_ITEM}"


@dataclass
class LoadedSim:
    bundle: SimBundle
    handlers: tuple
    config: ShadowConfig
    # <traffic> elements compiled to an injection trace
    # (apps/tgen.py compile_trace; feed to inject.Feeder)
    inject_events: tuple = ()


def _refuse(model: str) -> None:
    """Raise for a plugin model the port cannot run (before any device
    work); ValueError for a name nobody registers, as the reference."""
    if model.endswith(".py"):
        raise NotImplementedError(
            f"shadow_tpu_torch: .py plugin '{model}': {_VPROC_ITEM}")
    if model in _REFUSED:
        raise NotImplementedError(
            f"shadow_tpu_torch: plugin '{model}' is {_REFUSED[model]}")
    if model not in _REGISTRY:
        raise ValueError(
            f"unknown plugin model '{model}' (registered: "
            f"{plugin_names()}, or a path to a .py plugin file); "
            f"register_plugin() to extend")


def load(config: ShadowConfig, *, seed: int = 1,
         overrides: dict | None = None, base_dir: str | None = None,
         device=None) -> LoadedSim:
    """ShadowConfig -> built SimBundle + app handlers on `device` (None
    -> "cuda"; raises when CUDA is missing). `overrides` carries
    CLI-level settings (qdisc, buffers, runahead, capacities); they beat
    plugin hints, and host element attributes beat the buffer defaults
    (master.c:355-364)."""
    overrides = overrides or {}
    # captured before hint-merging mutates the dict: the rebuild
    # closure replays the caller's overrides, then layers the
    # escalation's capacity bumps on top
    caller_overrides = dict(overrides)

    def _resolve(path: str) -> str:
        # a relative <topology path> is relative to the config file
        if base_dir and not pathlib.Path(path).is_absolute():
            return str(pathlib.Path(base_dir) / path)
        return path

    host_specs: list[HostSpec] = []
    assignments: dict[str, list] = {}
    sndbuf = overrides.get("socket_send_buffer", 131072)
    rcvbuf = overrides.get("socket_recv_buffer", 174760)
    for idx, (name, he) in enumerate(config.expanded_hosts()):
        start = min((p.starttime for p in he.processes), default=None)
        stops = [p.stoptime for p in he.processes if p.stoptime]
        # one device app per host: it stops when the last of the host's
        # processes stops (ref: <process stoptime>, process.c:1286-1324);
        # no stoptime = runs to sim end
        stop = max(stops) if stops and len(stops) == len(he.processes) \
            else None
        host_specs.append(HostSpec(
            name=name,
            ip=he.iphint if he.quantity == 1 else None,
            citycode=he.citycodehint,
            countrycode=he.countrycodehint,
            geocode=he.geocodehint,
            type=he.typehint,
            bandwidthdown=he.bandwidthdown,
            bandwidthup=he.bandwidthup,
            proc_start_time=start,
            proc_stop_time=stop,
        ))
        if he.socketsendbuffer:
            sndbuf = he.socketsendbuffer
        if he.socketrecvbuffer:
            rcvbuf = he.socketrecvbuffer
        for p in he.processes:
            if p.plugin not in config.plugins:
                raise ValueError(f"process references unknown plugin "
                                 f"'{p.plugin}'")
            model = config.plugins[p.plugin].path
            assignments.setdefault(model, []).append((idx, p))
    # validate plugin references before reading the topology or
    # building: a config typo or a refused plugin fails in milliseconds
    for model in assignments:
        _refuse(model)

    if config.topology_text is not None:
        graphml = config.topology_text
    else:
        with open(_resolve(config.topology_path)) as f:
            graphml = f.read()

    # <traffic> elements compile BEFORE the build: host indices follow
    # expanded_hosts() order (the order host_specs was filled in), and
    # the trace length sizes the default staging width the way plugin
    # hints size the rings
    inject_events: tuple = ()
    if config.traffics:
        from shadow_tpu_torch.apps import tgen

        name_to_index = {name: i for i, (name, _)
                         in enumerate(config.expanded_hosts())}
        inject_events = tuple(tgen.compile_trace(
            config.traffics, name_to_index, end_time=config.stoptime))
        overrides.setdefault("inject_lanes",
                             tgen.lanes_for(len(inject_events)))

    # model-provided capacity hints (CLI overrides still win)
    hinted: dict = {}
    for model, asg in assignments.items():
        h = getattr(_REGISTRY[model], "hints", None)
        if h is not None:
            for k, v in h(asg).items():
                hinted[k] = max(hinted.get(k, 0), v)
    for k, v in hinted.items():
        overrides.setdefault(k, v)

    qdisc_name = overrides.get("interface_qdisc", "fifo")
    rq_name = overrides.get("router_qdisc", "codel")
    # any <host logpcap="true"> turns the capture ring on (the CLI
    # drains it into per-host pcap files, utils/pcap.py)
    want_pcap = bool(overrides.get("pcap", False)) or any(
        he.logpcap for _, he in config.expanded_hosts())
    cfg = NetConfig(
        num_hosts=len(host_specs),
        end_time=config.stoptime,
        bootstrap_end=config.bootstraptime,
        seed=seed,
        qdisc=QDisc.RR if qdisc_name == "rr" else QDisc.FIFO,
        router_qdisc={"codel": RouterQ.CODEL, "single": RouterQ.SINGLE,
                      "static": RouterQ.STATIC}[rq_name],
        pcap=want_pcap,
        tcp_cong=tcp_cong.NAMES[
            overrides.get("tcp_congestion_control", "reno")],
        sndbuf=sndbuf,
        rcvbuf=rcvbuf,
        **{k: v for k, v in overrides.items()
           if k in ("sockets_per_host", "event_capacity", "outbox_capacity",
                    "router_ring", "in_ring", "out_ring", "timers_per_host",
                    "emit_capacity", "nic_drain", "tcp", "tcp_ssthresh",
                    "tcp_windows", "cpu_threshold_ns",
                    "cpu_precision_ns", "track_paths",
                    "windows_per_dispatch", "adaptive_jump",
                    "inject_lanes")},
    )

    bundle = build(cfg, graphml, host_specs, device=device)
    if overrides.get("runahead"):
        bundle.min_jump = int(overrides["runahead"]
                              * simtime.ONE_MILLISECOND)

    handlers: list = []
    for model, asg in assignments.items():
        handlers.extend(_REGISTRY[model](bundle, asg))

    if config.faults:
        # resolve names -> indices against the placed bundle and install
        # the compiled plan + wakeup events, after plugin configure
        # (which may replace bundle.sim wholesale)
        from shadow_tpu_torch import faults as faults_mod

        faults_mod.install(bundle, faults_mod.records_from_config(
            config, bundle))

    if config.traffics:
        from shadow_tpu_torch.apps import tgen

        if not handlers:
            # traffic-only config: tgen IS the app
            bundle.sim = tgen.setup(bundle.sim,
                                    port=config.traffics[0].port)
            handlers.append(tgen.handler)
        elif not any(h is tgen.handler for h in handlers):
            raise ValueError(
                "<traffic> elements compile to tgen events, but "
                "another device app owns the app state; run the "
                "traffic hosts under the 'tgen' plugin or drop the "
                "<traffic> elements")

    def _rebuild(new_overrides: dict) -> SimBundle:
        # Full reload — topology placement, app setup, fault install —
        # at the merged capacities. Everything but the overridden shapes
        # is a pure function of (config, seed), so the rebuilt boot
        # state matches the original wherever shapes agree; the
        # escalation transplanter relies on that.
        merged = dict(caller_overrides)
        merged.update(new_overrides)
        return load(config, seed=seed, overrides=merged,
                    base_dir=base_dir, device=bundle.device).bundle

    bundle.rebuild = _rebuild
    return LoadedSim(bundle=bundle, handlers=tuple(handlers), config=config,
                     inject_events=inject_events)
