"""Struct-of-arrays state for the virtual host network stack
(PyTorch port of shadow_tpu/net/state.py).

One NetState holds *all* hosts' kernel state as [H]- and [H,S]-shaped
tensors; sockets are laid out [H, S] so "this host's sockets" is a row.
Field names, shapes and dtypes are the reference's, except that the
u32 planes (``rng_keys``, ``rng_ctr``; see U32_FIELDS) are int64
holding 32-bit values (core/rng.py explains why).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from shadow_tpu_torch.core import rng, simtime
from shadow_tpu_torch.core.events import (
    NWORDS, NWORDS_BASE, EventQueue, Outbox, _Replace)

I32 = torch.int32
I64 = torch.int64

# NetState fields carried as int64 that hold u32 values in the
# reference (converted back at the parity boundary, convert.py).
U32_FIELDS = frozenset({"rng_keys", "rng_ctr"})

# NetState fields that are global lookup tables rather than per-host
# rows: sparse-lane compaction (core/compact.py) passes them through
# whole, as the reference's sharding does.
REPLICATED_FIELDS = frozenset({
    "host_ip", "ip_sorted", "host_of_ip_sorted", "vertex_of_host",
    "latency_ns", "reliability", "bw_up_kibps", "bw_down_kibps",
    "ctr_path_packets",
})


class SocketType:
    NONE = 0
    UDP = 1
    TCP = 2
    # intra-host conduits (pipe/socketpair, ref: channel.c) are modeled
    # as socket pairs with local-only delivery
    PIPE = 3


class SocketFlags:
    """Descriptor status bits (ref: descriptor.h:19-31)."""

    ACTIVE = 1
    READABLE = 2
    WRITABLE = 4
    CLOSED = 8


class QDisc:
    """Interface queuing discipline (ref: options.h:31-34)."""

    FIFO = 0
    RR = 1


class RouterQ:
    """Upstream-router queue manager (ref: QueueManagerHooks vtable,
    router.c; CoDel is the reference default, host.c:205)."""

    CODEL = 0    # RFC-8289 AQM (ref: router_queue_codel.c)
    SINGLE = 1   # one-packet queue (ref: router_queue_single.c)
    STATIC = 2   # drop-tail at ring capacity (ref: router_queue_static.c)


# token-bucket refill interval (ref: network_interface.c:93-95)
TB_REFILL_INTERVAL = simtime.ONE_MILLISECOND

# default socket buffer byte limits (ref: definitions.h:153-159);
# a config that pins a different value disables that direction's TCP
# buffer autotuning (ref: master.c:355-364)
DEFAULT_SNDBUF = 131072
DEFAULT_RCVBUF = 174760


@dataclass(frozen=True)
class NetConfig:
    """Static build-time configuration — a field-for-field copy of the
    reference's NetConfig. Settings off the port's current path raise
    NotImplementedError at net.build.build (see ROADMAP.md)."""

    num_hosts: int
    # When every host's eth IP is base + host_index (the common case:
    # the DNS registry allocates sequentially unless configs pin
    # addresses), IP lookups become arithmetic instead of gathers.
    # -1 = not affine; set by build().
    ip_affine_base: int = -1
    sockets_per_host: int = 4
    in_ring: int = 16            # per-socket input packet ring slots
    out_ring: int = 16           # per-socket output packet ring slots
    router_ring: int = 32       # per-host upstream router queue slots
    timers_per_host: int = 4
    event_capacity: int = 32
    outbox_capacity: int = 32
    # --- virtual CPU model (ref: cpu.c:56-110, event.c:71-89) --------
    # threshold < 0 disables the model entirely (the reference's
    # default, options.c:81-82). The reference charges each event the
    # plugin's MEASURED wall time x frequency ratio — nondeterministic
    # across machines; here the charge is a configured deterministic
    # per-event cost, scaled per host by cpu_raw_freq_khz /
    # host cpufrequency and rounded to cpu_precision_ns (half-up).
    cpu_threshold_ns: int = -1
    cpu_precision_ns: int = 200_000   # 200 us (ref: options.c:82)
    cpu_event_cost_ns: int = 30_000   # deterministic per-event charge
    cpu_raw_freq_khz: int = 3_000_000  # the "physical" CPU baseline
    qdisc: int = QDisc.FIFO
    router_qdisc: int = RouterQ.CODEL  # upstream router queue manager
    # pcap capture (ref: <host logpcap> + pcap_writer.c): when on, the
    # NIC appends every sent/delivered packet to a per-host capture
    # ring the host side drains into libpcap files each window
    pcap: bool = False
    pcap_ring: int = 64          # capture ring slots per host
    autotune: bool = True        # TCP buffer autotuning (ref:
                                 # CONFIG_TCPAUTOTUNE, definitions.h:101).
                                 # Pinning sndbuf/rcvbuf away from the
                                 # defaults disables that direction's
                                 # autotuning (make_net_state), matching
                                 # the reference's user-override rule
                                 # (master.c:355-364)
    tcp_cong: int = 0            # congestion algorithm (tcp_cong.NAMES:
                                 # reno/aimd/cubic — the reference's
                                 # --tcp-congestion-control knob backed
                                 # by the tcp_cong.h vtable design)
    # --tcp-ssthresh (ref: options.c:137): initial slow-start
    # threshold in packets; 0 = discover via loss (the default)
    tcp_ssthresh: int = 0
    # --tcp-windows (ref: options.c:138): pin the initial congestion
    # window; 0 = the reference's effective behavior (reno init
    # resets to 1, tcp_cong_reno.c:176-180)
    tcp_windows: int = 0
    tcp: bool = True             # False: UDP-only, no TcpState
    # Per-path packet counters (ref: topology.c:2053-2063 per-Path
    # packetCount, logged at cache clear): a [V,V] matrix counting
    # remote send attempts per (src vertex, dst vertex). Off by
    # default (not ported yet).
    track_paths: bool = False
    # Active-lane budget S for the reference's sparse-window fast path.
    # None = engine default (DEFAULT_SPARSE_LANES); 0 disables; values
    # >= num_hosts are treated as disabled (core/engine.py
    # resolve_sparse_lanes).
    sparse_lanes: int | None = None
    bootstrap_end: int = 0       # "unlimited bandwidth" period end
                                 # (ref: master.c:261-268)
    end_time: int = simtime.ONE_SECOND
    min_jump: int = 10 * simtime.ONE_MILLISECOND
    # Windows per dispatch for the reference's chunked host loops; the
    # whole-run loop (engine.run) ignores it.
    windows_per_dispatch: int = 1
    # Adaptive time jump of the reference's chunked loops; the
    # whole-run loop (engine.run) ignores it.
    adaptive_jump: bool = False
    # Open-system injection staging lanes (inject/staging.py, attached
    # at build when > 0; a power of two); 0 = off.
    inject_lanes: int = 0
    seed: int = 1
    # Packets drained per micro-step by the NIC send pass (the
    # reference's drain-while-sendable loop, network_interface.c:519-579,
    # bounded); bursts longer than nic_drain chain a same-time NIC_SEND
    # event.
    nic_drain: int = 4
    # Max emissions per host per micro-step. None = derived: the wire
    # packets one drain pass can emit plus headroom for the chain /
    # timer / app / (TCP: rtx + dack + flush) emissions that can
    # coincide. Overflow is counted, never silent.
    emit_capacity: int | None = None

    def __post_init__(self):
        if self.emit_capacity is None:
            object.__setattr__(
                self, "emit_capacity",
                self.nic_drain + (6 if self.tcp else 4))
        elif self.emit_capacity < self.nic_drain + 2:
            # one drain pass alone can emit nic_drain wire packets
            # plus a chain/wait event; a pinned emit_capacity below
            # that would overflow (counted, but on configs that never
            # overflowed before this knob existed) — fail loudly at
            # build instead
            raise ValueError(
                f"emit_capacity={self.emit_capacity} < nic_drain"
                f"={self.nic_drain} + 2: raise emit_capacity or lower "
                f"nic_drain")
    # default socket buffer byte limits (ref: definitions.h:153-159)
    sndbuf: int = DEFAULT_SNDBUF
    rcvbuf: int = DEFAULT_RCVBUF
    # Packet-word width carried by events/rings. None = derive:
    # full TCP-header width when cfg.tcp, else the narrow
    # protocol-independent prefix (see core.events.NWORDS_BASE).
    nwords: int | None = None

    @property
    def words_width(self) -> int:
        if self.nwords is not None:
            # the TCP machine reads/writes header words up to index
            # NWORDS-1; a narrower override would be silently sliced
            if self.tcp and self.nwords < NWORDS:
                raise ValueError(
                    f"nwords={self.nwords} < {NWORDS} requires tcp=False "
                    f"(TCP packets carry header words up to index "
                    f"{NWORDS - 1})")
            if self.nwords < NWORDS_BASE:
                raise ValueError(
                    f"nwords={self.nwords} < NWORDS_BASE={NWORDS_BASE}: "
                    f"every packet needs the protocol-independent words")
            return self.nwords
        return NWORDS if self.tcp else NWORDS_BASE


@dataclass
class NetState(_Replace):
    # --- replicated global lookup tables -----------------------------
    host_ip: torch.Tensor           # [H] i64 eth IP per host (global table)
    ip_sorted: torch.Tensor         # [H] i64 sorted IPs (for ip->host lookup)
    host_of_ip_sorted: torch.Tensor  # [H] i32 host index aligned to ip_sorted
    vertex_of_host: torch.Tensor    # [H] i32 topology attachment (global)
    latency_ns: torch.Tensor        # [V,V] i64
    reliability: torch.Tensor       # [V,V] f32
    # per-host bandwidths, replicated: TCP buffer autotuning sizes
    # buffers from the *bottleneck* of local and peer bandwidth
    # (ref: _tcp_tuneInitialBufferSizes, tcp.c:441-533)
    bw_up_kibps: torch.Tensor       # [H] i64 (global table)
    bw_down_kibps: torch.Tensor     # [H] i64 (global table)
    # --- per-host (sharded) state -------------------------------------
    # Global host id of each local row. Single-shard: arange(H). Under
    # shard_map each shard sees its own slice — handlers use this (not
    # arange) wherever a host's *identity* matters: self-addressed
    # emissions, src-host comparisons, global-table gathers.
    lane_id: torch.Tensor           # [H] i32
    # --- per-host RNG (deterministic seed hierarchy) ------------------
    rng_keys: torch.Tensor          # [H, 2] u32 key data (int64-carried)
    rng_ctr: torch.Tensor           # [H] u32 draw counters (int64-carried)
    # --- NIC token buckets (ref: network_interface.c:93-226) ----------
    tb_send_refill: torch.Tensor    # [H] i64 bytes per interval
    tb_recv_refill: torch.Tensor    # [H] i64
    tb_send_tokens: torch.Tensor    # [H] i64
    tb_recv_tokens: torch.Tensor    # [H] i64
    tb_quantum: torch.Tensor        # [H] i64 last analytic refill quantum
    nic_send_pending: torch.Tensor  # [H] bool — a future NIC_SEND exists
    nic_recv_pending: torch.Tensor  # [H] bool
    # Transient intra-micro-step flag: data was enqueued on a socket
    # this micro-step and the send drain (which runs last in the
    # handler pipeline) should pick it up NOW — the device form of the
    # reference's synchronous networkinterface_wantsSend call
    # (network_interface.c:583-...) instead of a same-time event
    # round-trip. Always consumed by handle_nic_send in the same
    # micro-step; host-side syscall paths must flush it explicitly
    # (vproc flush_wants_send).
    nic_send_now: torch.Tensor      # [H] bool
    # TCP buffer autotuning enabled per host+direction (off when the
    # user pinned explicit buffer sizes — ref: master.c:355-364,
    # options --socket-send/recv-buffer)
    autotune_snd: torch.Tensor      # [H] bool
    autotune_rcv: torch.Tensor      # [H] bool
    # --- virtual CPU (ref: cpu.c timeCPUAvailable) -------------------
    cpu_avail: torch.Tensor         # [H] i64 absolute time the CPU frees up
    cpu_cost: torch.Tensor          # [H] i64 per-event charge, pre-scaled
                                 # by the host's frequency ratio and
                                 # pre-rounded to precision
    ctr_cpu_blocked: torch.Tensor   # [H] i64 events delayed by the CPU
    ctr_cpu_delay_ns: torch.Tensor  # [H] i64 total virtual processing delay
                                 # (ref: tracker_addVirtualProcessingDelay)
    # per-host executed-event count — the device-meaningful analog of
    # the reference's per-host execution GTimer logged at shutdown
    # (host.c:114-116,314-317; wall seconds make no sense for a host
    # that is one lane of a fused device step)
    ctr_events_exec: torch.Tensor   # [H] i64
    # [V,V] remote send attempts per vertex pair when
    # cfg.track_paths, else [1,1] (ref: topology.c:2053-2063)
    ctr_path_packets: torch.Tensor  # [Vp,Vp] i64
    # --- process lifetime (ref: process.c:1286-1360) ------------------
    # True once the host's PROC_STOP event fired: app handlers are
    # masked off from then on (the device analog of process_stop
    # aborting the plugin main thread). The netstack keeps running —
    # in-flight TCP state unwinds via its own timers, as the
    # reference's descriptors do after plugin death.
    proc_stopped: torch.Tensor      # [H] bool
    rr_ptr: torch.Tensor            # [H] i32 round-robin qdisc cursor
    port_ctr: torch.Tensor          # [H] i32 ephemeral port allocator
                                 # (counter analog of host.c:1058-1110)
    priority_ctr: torch.Tensor     # [H] i64 per-host packet priority
                                 # (ref: host.c packet priority counter)
    # --- upstream router ring + CoDel (ref: router_queue_codel.c) -----
    rq_src: torch.Tensor            # [H,R] i32 source host of queued packet
    rq_enq_ts: torch.Tensor         # [H,R] i64 enqueue time (sojourn calc)
    rq_words: torch.Tensor          # [H,R,NWORDS] i32 packet words
    rq_head: torch.Tensor           # [H] i32 ring head
    rq_count: torch.Tensor          # [H] i32 ring occupancy
    rq_bytes: torch.Tensor          # [H] i64 queued wire bytes
    codel_interval_expire: torch.Tensor  # [H] i64 (0 = good state)
    codel_next_drop: torch.Tensor   # [H] i64
    codel_dropping: torch.Tensor    # [H] bool drop mode
    codel_drop_count: torch.Tensor  # [H] i32
    codel_drop_count_last: torch.Tensor  # [H] i32
    # --- sockets [H,S] ------------------------------------------------
    sk_type: torch.Tensor           # [H,S] i32 SocketType
    sk_flags: torch.Tensor          # [H,S] i32 SocketFlags bits
    sk_bound_ip: torch.Tensor       # [H,S] i64 (0 = INADDR_ANY wildcard)
    sk_bound_port: torch.Tensor     # [H,S] i32 (0 = unbound)
    sk_peer_ip: torch.Tensor        # [H,S] i64 (0 = unconnected)
    sk_peer_port: torch.Tensor      # [H,S] i32
    sk_sndbuf: torch.Tensor         # [H,S] i32 byte limits
    sk_rcvbuf: torch.Tensor         # [H,S] i32
    # Monotonic readiness generations: bumped every time new input
    # data/EOF raises READABLE (in) or freed capacity raises WRITABLE
    # (out). Edge-triggered epoll watches key off these — a new
    # arrival on an already-readable socket is still an edge, exactly
    # like the reference's per-status-change notify
    # (descriptor_adjustStatus -> epoll.c:583).
    sk_in_gen: torch.Tensor         # [H,S] i32
    sk_out_gen: torch.Tensor        # [H,S] i32
    # input ring: packets delivered, waiting for app recv
    in_src_ip: torch.Tensor         # [H,S,BI] i64
    in_src_port: torch.Tensor       # [H,S,BI] i32
    in_len: torch.Tensor            # [H,S,BI] i32
    in_payref: torch.Tensor         # [H,S,BI] i32
    in_status: torch.Tensor         # [H,S,BI] i32 delivery-status trail
                                 # (ref: packet.h:18-40 audit)
    in_head: torch.Tensor           # [H,S] i32
    in_count: torch.Tensor          # [H,S] i32
    in_bytes: torch.Tensor          # [H,S] i32
    # output ring: fully-formed packets waiting for the NIC. Protocols
    # write complete packet words at enqueue time; volatile TCP header
    # fields (ack/window/ts) are re-stamped at wire time by the NIC
    # (ref: tcp_networkInterfaceIsAboutToSendPacket, tcp.c:1090-1120).
    out_words: torch.Tensor         # [H,S,BO,NWORDS] i32
    out_priority: torch.Tensor      # [H,S,BO] i64
    out_head: torch.Tensor          # [H,S] i32
    out_count: torch.Tensor         # [H,S] i32
    out_bytes: torch.Tensor         # [H,S] i32
    # --- timers (timerfd analog, ref: timer.c) ------------------------
    tm_expire: torch.Tensor         # [H,T] i64 next expiry (INVALID = off)
    tm_interval: torch.Tensor       # [H,T] i64 (0 = one-shot)
    tm_gen: torch.Tensor            # [H,T] i32 generation (stale-expiry guard)
    tm_expirations: torch.Tensor    # [H,T] i64 count since last read
    # --- counters (tracker-lite; full tracker in utils) ---------------
    ctr_drop_reliability: torch.Tensor  # [H] i64 packets dropped by path loss
    ctr_drop_codel: torch.Tensor    # [H] i64
    ctr_drop_nosocket: torch.Tensor  # [H] i64
    ctr_drop_bufferfull: torch.Tensor  # [H] i64
    ctr_rx_bytes: torch.Tensor      # [H] i64
    ctr_tx_bytes: torch.Tensor      # [H] i64
    ctr_rx_packets: torch.Tensor    # [H] i64
    ctr_tx_packets: torch.Tensor    # [H] i64
    # data/control/retransmit byte split (ref: tracker.c:51-99 — the
    # tracker accounts interface bytes by packet class): data = payload
    # bytes, control = wire - data (headers + 0-len control packets),
    # retransmit = wire bytes of segments whose audit trail carries
    # PDS_SND_TCP_RETRANSMITTED
    ctr_rx_data_bytes: torch.Tensor  # [H] i64
    ctr_tx_data_bytes: torch.Tensor  # [H] i64
    ctr_tx_retx_bytes: torch.Tensor  # [H] i64
    # object accounting (ref: object_counter.c — new/free counts
    # diffed at shutdown; a nonzero diff is a logical descriptor leak)
    ctr_sk_alloc: torch.Tensor      # [H] i64 sockets allocated
    ctr_sk_free: torch.Tensor       # [H] i64 sockets freed
    # trail word of the host's most recently dropped packet, with the
    # drop-stage bit set — the debugging hook the reference gets from
    # dumping a dropped packet's status list (packet_toString)
    last_drop_status: torch.Tensor  # [H] i32
    # --- pcap capture ring (ref: network_interface.c:337-373) ---------
    # Shapes are [H,1,...] when cfg.pcap is off (dead weight ~0).
    # cap_count is a monotonic write counter; slot = count % C. The
    # host drains between windows (utils/pcap.py); count jumping by
    # more than C since the last drain = dropped capture records.
    cap_time: torch.Tensor          # [H,C] i64 capture timestamp
    cap_words: torch.Tensor         # [H,C,NWORDS] i32 packet words
    cap_meta: torch.Tensor          # [H,C] i32: src_host | dir<<24 (1=in)
    cap_count: torch.Tensor         # [H] i32 monotonic
    rq_overflow: torch.Tensor       # [] i32 router ring overflow (grow R!)
    # Optional per-host attribution plane for rq_overflow ([H] i32),
    # attached by core/lanes.attach for lane-isolated ensemble runs —
    # None (the default) contributes no pytree leaves, so checkpoints
    # and compiled programs without lane isolation are byte-identical.
    # Invariant when attached: rq_overflow == sum(rq_overflow_h).
    rq_overflow_h: Any = None


@dataclass
class Sim(_Replace):
    """Top-level simulation state: engine queues + netstack + app."""

    events: EventQueue
    outbox: Outbox
    net: NetState
    app: Any = None
    # Opt-in layers of the reference. None contributes no leaf, as in
    # the reference. Ported: the TCP sockets' state (net/tcp.py
    # TcpState, set when cfg.tcp), the window telemetry ring
    # (telemetry/ring.py attach), the injection staging buffer
    # (inject/staging.py, cfg.inject_lanes), the lane health planes and
    # the resident lease planes (core/lanes.py attach,
    # attach_admission), the flow ring (telemetry/flows.py
    # attach_flows), the causality planes (telemetry/causality.py
    # attach_causality) and the specialization guard latch
    # (compile/specialize.py GuardState, attached by specialize.apply
    # when a capability was trimmed). Not yet (ROADMAP.md): sentinel
    # (item 9), which stays None.
    tcp: Any = None
    telem: Any = None
    inject: Any = None
    lanes: Any = None
    flows: Any = None
    admission: Any = None
    causality: Any = None
    guard: Any = None
    sentinel: Any = None


def drop_total(net: NetState) -> torch.Tensor:
    """[H] i64 total packets dropped per host, all drop classes (the
    telemetry ring's per-window delta reads it)."""
    return (net.ctr_drop_reliability + net.ctr_drop_codel
            + net.ctr_drop_nosocket + net.ctr_drop_bufferfull)


def ip_of_hosts(cfg: NetConfig, net: "NetState", idx) -> torch.Tensor:
    """eth IP of host index tensor `idx` (any shape). Junk indices on
    masked lanes are tolerated: arithmetic on them is harmless in the
    affine fast path (cfg.ip_affine_base), and the table path clips
    before gathering."""
    if cfg.ip_affine_base >= 0:
        return cfg.ip_affine_base + idx.to(I64)
    GH = net.host_ip.shape[0]
    return net.host_ip[idx.clamp(0, GH - 1).to(I64)]


def make_net_state(
    cfg: NetConfig,
    host_ips: np.ndarray,       # [H] i64
    bw_up_kibps: np.ndarray,    # [H]
    bw_down_kibps: np.ndarray,  # [H]
    vertex_of_host: np.ndarray,  # [H] i32
    latency_ns: np.ndarray,     # [V,V] i64
    reliability: np.ndarray,    # [V,V] f32
    cpu_freq_khz: np.ndarray | None = None,  # [H] (0 = unspecified)
    device=None,
) -> NetState:
    H, S = cfg.num_hosts, cfg.sockets_per_host
    BI, BO, R, T = cfg.in_ring, cfg.out_ring, cfg.router_ring, cfg.timers_per_host
    num_vertices = int(np.asarray(latency_ns).shape[0])
    from shadow_tpu_torch.net.packetfmt import MTU

    # bytes per refill interval (ref: network_interface.c:196-203)
    tf = simtime.ONE_SECOND // TB_REFILL_INTERVAL
    send_refill = np.asarray(bw_up_kibps, np.int64) * 1024 // tf
    recv_refill = np.asarray(bw_down_kibps, np.int64) * 1024 // tf

    # per-event CPU charge: cost x (rawFreq / hostFreq), rounded
    # half-up to precision (ref: cpu.c:85-110 cpu_addDelay)
    if cpu_freq_khz is None:
        freq = np.zeros(H, np.int64)
    else:
        freq = np.asarray(cpu_freq_khz, np.int64)
    freq = np.where(freq > 0, freq, cfg.cpu_raw_freq_khz)
    cost = np.asarray(cfg.cpu_event_cost_ns, np.int64) \
        * cfg.cpu_raw_freq_khz // np.maximum(freq, 1)
    p = cfg.cpu_precision_ns
    if p > 0:
        cost = (cost + p // 2) // p * p

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), device=device).to(dtype)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    C = cfg.pcap_ring if cfg.pcap else 1
    return NetState(
        host_ip=t(host_ips, I64),
        ip_sorted=t(np.sort(host_ips), I64),
        host_of_ip_sorted=t(np.argsort(host_ips), I32),
        vertex_of_host=t(vertex_of_host, I32),
        latency_ns=t(latency_ns, I64),
        reliability=t(np.asarray(reliability).astype(np.float32),
                      torch.float32),
        bw_up_kibps=t(bw_up_kibps, I64),
        bw_down_kibps=t(bw_down_kibps, I64),
        autotune_snd=full((H,), bool(
            cfg.autotune and cfg.sndbuf == DEFAULT_SNDBUF), torch.bool),
        autotune_rcv=full((H,), bool(
            cfg.autotune and cfg.rcvbuf == DEFAULT_RCVBUF), torch.bool),
        cpu_avail=zeros((H,), I64),
        cpu_cost=t(cost, I64),
        ctr_cpu_blocked=zeros((H,), I64),
        ctr_cpu_delay_ns=zeros((H,), I64),
        ctr_events_exec=zeros((H,), I64),
        ctr_path_packets=zeros(
            (num_vertices, num_vertices) if cfg.track_paths else (1, 1), I64),
        lane_id=torch.arange(H, dtype=I32, device=device),
        rng_keys=rng.host_streams(cfg.seed, H, device=device),
        rng_ctr=zeros((H,), I64),
        tb_send_refill=t(send_refill, I64),
        tb_recv_refill=t(recv_refill, I64),
        # buckets start at capacity = refill + MTU
        # (ref: network_interface.c:219-226)
        tb_send_tokens=t(send_refill + MTU, I64),
        tb_recv_tokens=t(recv_refill + MTU, I64),
        tb_quantum=zeros((H,), I64),
        nic_send_pending=zeros((H,), torch.bool),
        nic_recv_pending=zeros((H,), torch.bool),
        nic_send_now=zeros((H,), torch.bool),
        proc_stopped=zeros((H,), torch.bool),
        rr_ptr=zeros((H,), I32),
        port_ctr=zeros((H,), I32),
        priority_ctr=zeros((H,), I64),
        rq_src=zeros((H, R), I32),
        rq_enq_ts=zeros((H, R), I64),
        rq_words=zeros((H, R, cfg.words_width), I32),
        rq_head=zeros((H,), I32),
        rq_count=zeros((H,), I32),
        rq_bytes=zeros((H,), I64),
        codel_interval_expire=zeros((H,), I64),
        codel_next_drop=zeros((H,), I64),
        codel_dropping=zeros((H,), torch.bool),
        codel_drop_count=zeros((H,), I32),
        codel_drop_count_last=zeros((H,), I32),
        sk_type=zeros((H, S), I32),
        sk_flags=zeros((H, S), I32),
        sk_bound_ip=zeros((H, S), I64),
        sk_bound_port=zeros((H, S), I32),
        sk_peer_ip=zeros((H, S), I64),
        sk_peer_port=zeros((H, S), I32),
        sk_sndbuf=full((H, S), cfg.sndbuf, I32),
        sk_rcvbuf=full((H, S), cfg.rcvbuf, I32),
        sk_in_gen=zeros((H, S), I32),
        sk_out_gen=zeros((H, S), I32),
        in_src_ip=zeros((H, S, BI), I64),
        in_src_port=zeros((H, S, BI), I32),
        in_len=zeros((H, S, BI), I32),
        in_payref=zeros((H, S, BI), I32),
        in_status=zeros((H, S, BI), I32),
        in_head=zeros((H, S), I32),
        in_count=zeros((H, S), I32),
        in_bytes=zeros((H, S), I32),
        out_words=zeros((H, S, BO, cfg.words_width), I32),
        out_priority=zeros((H, S, BO), I64),
        out_head=zeros((H, S), I32),
        out_count=zeros((H, S), I32),
        out_bytes=zeros((H, S), I32),
        tm_expire=full((H, T), simtime.INVALID, I64),
        tm_interval=zeros((H, T), I64),
        tm_gen=zeros((H, T), I32),
        tm_expirations=zeros((H, T), I64),
        ctr_drop_reliability=zeros((H,), I64),
        ctr_drop_codel=zeros((H,), I64),
        ctr_drop_nosocket=zeros((H,), I64),
        ctr_drop_bufferfull=zeros((H,), I64),
        ctr_rx_bytes=zeros((H,), I64),
        ctr_tx_bytes=zeros((H,), I64),
        ctr_rx_packets=zeros((H,), I64),
        ctr_tx_packets=zeros((H,), I64),
        ctr_rx_data_bytes=zeros((H,), I64),
        ctr_tx_data_bytes=zeros((H,), I64),
        ctr_tx_retx_bytes=zeros((H,), I64),
        ctr_sk_alloc=zeros((H,), I64),
        ctr_sk_free=zeros((H,), I64),
        last_drop_status=zeros((H,), I32),
        cap_time=zeros((H, C), I64),
        cap_words=zeros((H, C, cfg.words_width), I32),
        cap_meta=zeros((H, C), I32),
        cap_count=zeros((H,), I32),
        rq_overflow=zeros((), I32),
    )


def make_sim(cfg: NetConfig, net: NetState, app: Any = None) -> Sim:
    """The boot Sim: empty queues/outbox on the NetState's device, the
    TCP sockets' state when cfg.tcp and the injection staging buffer
    when cfg.inject_lanes."""
    dev = net.host_ip.device
    tcp = None
    if cfg.tcp:
        from shadow_tpu_torch.net.tcp import (
            TcpState, initial_cwnd, initial_ssthresh)

        tcp = TcpState.create(
            cfg.num_hosts, cfg.sockets_per_host,
            init_cwnd=initial_cwnd(cfg),
            init_ssthresh=initial_ssthresh(cfg), device=dev)
    sim = Sim(
        events=EventQueue.create(cfg.num_hosts, cfg.event_capacity,
                                 cfg.words_width, device=dev),
        outbox=Outbox.create(cfg.num_hosts, cfg.outbox_capacity,
                             cfg.words_width, device=dev),
        net=net,
        app=app,
        tcp=tcp,
    )
    if cfg.inject_lanes:
        from shadow_tpu_torch.inject.staging import attach

        sim = attach(sim, cfg.inject_lanes)
    return sim


def host_of_ip(net: NetState, ip: torch.Tensor) -> torch.Tensor:
    """ip -> host-index lookup ([...] i64 -> [...] i32, -1 when
    unknown), by binary search over the sorted IP table."""
    idx = torch.searchsorted(net.ip_sorted, ip.contiguous())
    idx = idx.clamp(0, net.ip_sorted.shape[0] - 1)
    hit = net.ip_sorted[idx] == ip
    return torch.where(hit, net.host_of_ip_sorted[idx], -1)
