"""Heartbeat tracker (PyTorch port of shadow_tpu/utils/tracker.py) —
parity with the reference's per-host Tracker
(ref: tracker.c:419-607): periodic `[shadow-heartbeat] [node] ...`
CSV lines with one-time headers, plus `[socket]` per-socket buffer
stats and `[ram]` allocated-memory lines. The reference accumulates
counters imperatively inside each host object; here the counters
already live in the NetState/TcpState device tensors, so a heartbeat is
a (tiny) device->host fetch + delta against the previous snapshot. The
lines are the reference's text for the same state.

Byte accounting matches the reference's packet classes
(tracker.c:51-99): data bytes = payload, control bytes = wire headers
and 0-length control packets, retransmit bytes = wire bytes of
segments whose audit trail carries PDS_SND_TCP_RETRANSMITTED.

Emit cadence: the CLI calls Tracker.heartbeat() once post-run; the
interval matches --heartbeat-frequency (ref: options.c heartbeat
interval).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from shadow_tpu_torch.utils.shadowlog import LogLevel, SimLogger


@dataclass
class _Snap:
    rx_bytes: np.ndarray
    tx_bytes: np.ndarray
    rx_data: np.ndarray
    tx_data: np.ndarray
    tx_retx: np.ndarray
    rx_packets: np.ndarray
    tx_packets: np.ndarray
    retx: np.ndarray
    drops: np.ndarray


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _snapshot(sim) -> _Snap:
    from shadow_tpu_torch.net.state import drop_total

    net = sim.net
    # the same all-classes drop definition the telemetry ring uses
    # (net.state.drop_total) — heartbeats, per-window records and final
    # counters agree by construction
    return _Snap(
        rx_bytes=_host(net.ctr_rx_bytes),
        tx_bytes=_host(net.ctr_tx_bytes),
        rx_data=_host(net.ctr_rx_data_bytes),
        tx_data=_host(net.ctr_tx_data_bytes),
        tx_retx=_host(net.ctr_tx_retx_bytes),
        rx_packets=_host(net.ctr_rx_packets),
        tx_packets=_host(net.ctr_tx_packets),
        retx=_host(sim.tcp.retx_segs) if sim.tcp is not None
        else np.zeros_like(_host(net.ctr_rx_bytes)),
        drops=_host(drop_total(net)),
    )


class Tracker:
    """Formats reference-style heartbeat lines from counter deltas."""

    def __init__(self, logger: SimLogger, host_names: list[str],
                 interval_s: int = 60, level: int = LogLevel.MESSAGE,
                 sections: tuple = ("node", "socket", "ram")):
        self.logger = logger
        self.host_names = host_names
        self.interval_s = interval_s
        self.level = level
        # which heartbeat sections to emit (ref: --heartbeat-log-info,
        # options.c:92: comma list of 'node','socket','ram')
        self.sections = frozenset(sections)
        unknown = self.sections - {"node", "socket", "ram"}
        if unknown:
            raise ValueError(
                f"unknown heartbeat section(s) {sorted(unknown)}; "
                f"valid: node, socket, ram")
        self._prev: _Snap | None = None
        self._did_node_header = False
        self._did_socket_header = False
        self._did_ram_header = False
        self.next_heartbeat_ns = interval_s * 1_000_000_000

    def heartbeat(self, sim, now_ns: int):
        """Log one interval's node/socket/ram lines (ref:
        _tracker_logNode / _tracker_logSocket / _tracker_logRAM,
        tracker.c:419-607; counters reduced to the fields this build
        tracks)."""
        if "node" in self.sections:
            self._node_lines(sim, now_ns)
        if "socket" in self.sections:
            self._socket_lines(sim, now_ns)
        if "ram" in self.sections:
            self._ram_lines(sim, now_ns)
        self.next_heartbeat_ns = now_ns + self.interval_s * 1_000_000_000

    def _node_lines(self, sim, now_ns: int):
        snap = _snapshot(sim)
        prev = self._prev
        self._prev = snap
        if not self._did_node_header:
            self._did_node_header = True
            self.logger.log(
                self.level, now_ns, "shadow-tpu",
                "[shadow-heartbeat] [node-header] interval-seconds,"
                "recv-bytes,send-bytes,recv-data-bytes,send-data-bytes,"
                "recv-control-bytes,send-control-bytes,"
                "send-retransmit-bytes,recv-packets,send-packets,"
                "retransmitted-segments,dropped-packets")

        def d(cur, pre, i):
            return int(cur[i] - (pre[i] if prev is not None else 0))

        for i, name in enumerate(self.host_names):
            rx = d(snap.rx_bytes, prev.rx_bytes if prev else None, i)
            tx = d(snap.tx_bytes, prev.tx_bytes if prev else None, i)
            rxd = d(snap.rx_data, prev.rx_data if prev else None, i)
            txd = d(snap.tx_data, prev.tx_data if prev else None, i)
            txr = d(snap.tx_retx, prev.tx_retx if prev else None, i)
            rxp = d(snap.rx_packets, prev.rx_packets if prev else None, i)
            txp = d(snap.tx_packets, prev.tx_packets if prev else None, i)
            rtx = d(snap.retx, prev.retx if prev else None, i)
            dr = d(snap.drops, prev.drops if prev else None, i)
            if rx or tx or rxp or txp or rtx or dr:
                self.logger.log(
                    self.level, now_ns, name,
                    f"[shadow-heartbeat] [node] {self.interval_s},"
                    f"{rx},{tx},{rxd},{txd},{rx - rxd},{tx - txd},"
                    f"{txr},{rxp},{txp},{rtx},{dr}")

    def _socket_lines(self, sim, now_ns: int):
        """Per-socket buffer occupancy (ref: _tracker_logSocket,
        tracker.c:467-530: inbuf/outbuf length and size per open
        socket)."""
        net = sim.net
        sk_type = _host(net.sk_type)
        in_bytes = _host(net.in_bytes)
        out_bytes = _host(net.out_bytes)
        rcvbuf = _host(net.sk_rcvbuf)
        sndbuf = _host(net.sk_sndbuf)
        port = _host(net.sk_bound_port)
        live_h, live_s = np.nonzero(sk_type != 0)
        if live_h.size == 0:
            return
        if not self._did_socket_header:
            self._did_socket_header = True
            self.logger.log(
                self.level, now_ns, "shadow-tpu",
                "[shadow-heartbeat] [socket-header] descriptor-fd,"
                "protocol,local-port,inbuf-length,inbuf-size,"
                "outbuf-length,outbuf-size")
        for h, s in zip(live_h.tolist(), live_s.tolist()):
            name = self.host_names[h]
            proto = {1: "UDP", 2: "TCP", 3: "PIPE"}.get(
                int(sk_type[h, s]), "?")
            self.logger.log(
                self.level, now_ns, name,
                f"[shadow-heartbeat] [socket] {s},{proto},"
                f"{int(port[h, s])},{int(in_bytes[h, s])},"
                f"{int(rcvbuf[h, s])},{int(out_bytes[h, s])},"
                f"{int(sndbuf[h, s])}")

    def _ram_lines(self, sim, now_ns: int):
        """Per-host simulated-buffer memory (ref: _tracker_logRAM,
        tracker.c:532-570: the allocated-memory map). The device
        analog is the bytes a host's rings currently hold: socket
        input+output buffers plus the upstream router queue."""
        net = sim.net
        held = (_host(net.in_bytes).sum(axis=1)
                + _host(net.out_bytes).sum(axis=1)
                + _host(net.rq_bytes))
        if not self._did_ram_header:
            self._did_ram_header = True
            self.logger.log(
                self.level, now_ns, "shadow-tpu",
                "[shadow-heartbeat] [ram-header] alloc-bytes")
        for i, name in enumerate(self.host_names):
            if held[i]:
                self.logger.log(
                    self.level, now_ns, name,
                    f"[shadow-heartbeat] [ram] {int(held[i])}")
