"""Packet layout inside event payload words.

The reference's Packet object (ref: packet.c:22-37, packet.h:66-86)
carries protocol headers and a refcounted payload; on device a packet
in flight is just the event's NWORDS int32 words. Payload bytes are
never on device — `W_PAYREF` indexes the host-side payload pool
(mirrors Payload sharing, ref: payload.c:17-30); synthetic traffic
uses PAYREF_NONE and only lengths are modeled.

The event's `src` field is the source *host index*; source IP is
derived via the host IP table when needed.
"""

import torch

# word indices. Protocol-independent words come FIRST so UDP-only
# configs can carry narrow events (core.events.NWORDS_BASE = 6 words)
# instead of the full TCP-header width (events.NWORDS = 17) — the
# window cost is linear in bytes moved, so dead header words divide
# throughput directly. Code touching an index >= NWORDS_BASE must be
# gated on cfg.tcp (a static out-of-range index fails at trace time,
# never silently).
W_PROTO = 0    # protocol | tcp-flags<<8  (see below)
W_LEN = 1      # payload length in bytes
W_PORTS = 2    # src_port | dst_port<<16
W_PAYREF = 3   # host-side payload pool index, PAYREF_NONE = synthetic
W_DSTIP = 4    # destination IP (distinguishes loopback vs eth delivery)
# Delivery-status audit trail: a bitmask ORed at every pipeline stage
# the packet passes (the device form of the reference's append-only
# PacketDeliveryStatusFlags trail, packet.h:18-40 /
# packet_addDeliveryStatus). Decode host-side with pds_decode().
W_STATUS = 5
# --- TCP header words (indices >= events.NWORDS_BASE) ----------------
W_SEQ = 6      # TCP sequence number
W_ACK = 7      # TCP acknowledgment
W_WIN = 8      # TCP advertised window
W_TSVAL = 9    # TCP timestamp value (ms)
W_TSECHO = 10  # TCP timestamp echo (ms)
W_SACKL = 11   # TCP selective-ack range 1 left edge
W_SACKR = 12   # TCP selective-ack range 1 right edge
# full SACK list: ranges 2 and 3 (the reference carries a full
# selective-ack list in its TCP header, packet.h:52,77; three ranges
# cover Linux's practical SACK option limit)
W_SACKL2 = 13
W_SACKR2 = 14
W_SACKL3 = 15
W_SACKR3 = 16

PAYREF_NONE = -1

# --- delivery-status bits (ref: packet.h:18-40 PDS_* enum) -----------
PDS_SND_CREATED = 1 << 0
PDS_SND_TCP_ENQUEUE_THROTTLED = 1 << 1
PDS_SND_TCP_ENQUEUE_RETRANSMIT = 1 << 2
PDS_SND_TCP_DEQUEUE_RETRANSMIT = 1 << 3
PDS_SND_TCP_RETRANSMITTED = 1 << 4
PDS_SND_SOCKET_BUFFERED = 1 << 5
PDS_SND_INTERFACE_SENT = 1 << 6
PDS_INET_SENT = 1 << 7
PDS_INET_DROPPED = 1 << 8          # reliability (path loss) drop
PDS_ROUTER_ENQUEUED = 1 << 9
PDS_ROUTER_DEQUEUED = 1 << 10
PDS_ROUTER_DROPPED = 1 << 11       # CoDel AQM drop
PDS_RCV_INTERFACE_RECEIVED = 1 << 12
PDS_RCV_INTERFACE_DROPPED = 1 << 13
PDS_RCV_SOCKET_PROCESSED = 1 << 14
PDS_RCV_SOCKET_DROPPED = 1 << 15   # no bound socket / rcvbuf full
PDS_RCV_SOCKET_BUFFERED = 1 << 16
PDS_RCV_SOCKET_DELIVERED = 1 << 17

PDS_NAMES = {
    PDS_SND_CREATED: "SND_CREATED",
    PDS_SND_TCP_ENQUEUE_THROTTLED: "SND_TCP_ENQUEUE_THROTTLED",
    PDS_SND_TCP_ENQUEUE_RETRANSMIT: "SND_TCP_ENQUEUE_RETRANSMIT",
    PDS_SND_TCP_DEQUEUE_RETRANSMIT: "SND_TCP_DEQUEUE_RETRANSMIT",
    PDS_SND_TCP_RETRANSMITTED: "SND_TCP_RETRANSMITTED",
    PDS_SND_SOCKET_BUFFERED: "SND_SOCKET_BUFFERED",
    PDS_SND_INTERFACE_SENT: "SND_INTERFACE_SENT",
    PDS_INET_SENT: "INET_SENT",
    PDS_INET_DROPPED: "INET_DROPPED",
    PDS_ROUTER_ENQUEUED: "ROUTER_ENQUEUED",
    PDS_ROUTER_DEQUEUED: "ROUTER_DEQUEUED",
    PDS_ROUTER_DROPPED: "ROUTER_DROPPED",
    PDS_RCV_INTERFACE_RECEIVED: "RCV_INTERFACE_RECEIVED",
    PDS_RCV_INTERFACE_DROPPED: "RCV_INTERFACE_DROPPED",
    PDS_RCV_SOCKET_PROCESSED: "RCV_SOCKET_PROCESSED",
    PDS_RCV_SOCKET_DROPPED: "RCV_SOCKET_DROPPED",
    PDS_RCV_SOCKET_BUFFERED: "RCV_SOCKET_BUFFERED",
    PDS_RCV_SOCKET_DELIVERED: "RCV_SOCKET_DELIVERED",
}


def pds_decode(status: int) -> list:
    """Host-side decoder: status word -> ordered stage names (the
    analog of packet_toString's trail dump)."""
    return [name for bit, name in sorted(PDS_NAMES.items())
            if status & bit]

# protocols (ref: packet.h protocol enum {LOCAL, UDP, TCP})
PROTO_LOCAL = 0
PROTO_UDP = 1
PROTO_TCP = 2

# TCP header flags, stored shifted by 8 in W_PROTO
TCPF_SYN = 1
TCPF_ACK = 2
TCPF_FIN = 4
TCPF_RST = 8

# Header sizes added to payload length for bandwidth accounting
# (ref: definitions.h:176-183).
HDR_UDP = 42
HDR_TCP = 66
MTU = 1500  # ref: definitions.h:188


def proto_of(words):
    return words[:, W_PROTO] & 0xFF


def tcp_flags_of(words):
    return (words[:, W_PROTO] >> 8) & 0xFF


def pack_proto(proto, flags=0):
    return proto | (flags << 8)


def ports_of(words):
    w = words[:, W_PORTS]
    return w & 0xFFFF, (w >> 16) & 0xFFFF


def pack_ports(src_port, dst_port):
    return (src_port & 0xFFFF) | ((dst_port & 0xFFFF) << 16)


def wire_length(proto, payload_len):
    """Total on-wire bytes used for token-bucket accounting
    (ref: network_interface.c:443,545: payload + header size)."""
    hdr = torch.where(proto == PROTO_TCP, HDR_TCP, HDR_UDP).to(payload_len.dtype)
    return payload_len + hdr
