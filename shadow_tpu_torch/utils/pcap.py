"""libpcap-format capture files from the device capture ring (the port
of shadow_tpu/utils/pcap.py; ref: pcap_writer.c — the reference writes
per-interface pcap files with fabricated ethernet/IP/TCP headers when
<host logpcap> is set; hooks at network_interface.c:337-373).

The device side appends (time, packet words, src/dir meta) to a
per-host ring (net/nic.py _capture, cfg.pcap); CaptureSession.drain()
runs between windows and appends the new records, as wire-format
frames, to one pcap file per host. Payload bytes come from the payload
pool (native/pool.py) when the packet carries a payref; synthetic
(length-only) traffic is written as zeros of the advertised length,
truncated to SNAPLEN like any real capture.

The files are byte for byte the reference's CaptureSession's. The
drain is vectorised: one host read of cap_count, one gather of the new
records on the device and one copy of them to the host; the headers
ahead of every record's payload are filled as numpy structured arrays
(one per transport), placed into one buffer per drain, and each host's
slice of it is appended to its file.
"""

from __future__ import annotations

import pathlib
import struct

import numpy as np
import torch

from shadow_tpu_torch.net import packetfmt as pf

SNAPLEN = 65535
LINKTYPE_EN10MB = 1
# the whole RECORD stays within SNAPLEN: 54 bytes of fabricated
# eth + ip + tcp headers is the worst case
MAX_PAYLOAD = SNAPLEN - 54

_GLOBAL_HDR = struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0,
                          SNAPLEN, LINKTYPE_EN10MB)
_REC, _ETH, _IP, _UDP, _TCP = 16, 14, 20, 8, 20


def _header_dtype(l4: dict, itemsize: int) -> np.dtype:
    """One record's bytes ahead of its payload, as a structured dtype:
    the record header (little-endian), then the fabricated ethernet and
    IPv4 headers and the UDP or TCP header `l4` (big-endian, at offset
    50). Bytes no field names stay zero."""
    fields = {
        "ts_sec": ("<u4", 0), "ts_usec": ("<u4", 4), "incl": ("<u4", 8),
        "orig": ("<u4", 12),
        # MACs (ref: address.c uniqueMAC): 02:00:hh:hh:hh:01 of the
        # source host, 02:00:00:00:00:01 for the destination
        "src_mac0": ("u1", 16), "src_host_hi": ("u1", 18),
        "src_host_lo": (">u2", 19), "src_mac5": ("u1", 21),
        "dst_mac0": ("u1", 22), "dst_mac5": ("u1", 27),
        "ethertype": (">u2", 28),
        "ver_ihl": ("u1", 30), "total": (">u2", 32), "ttl": ("u1", 38),
        "proto": ("u1", 39), "src_ip": (">u4", 42), "dst_ip": (">u4", 46),
        "sport": (">u2", 50), "dport": (">u2", 52), **l4}
    return np.dtype({"names": list(fields),
                     "formats": [f for f, _ in fields.values()],
                     "offsets": [o for _, o in fields.values()],
                     "itemsize": itemsize})


_UDP_HDR = _header_dtype({"ulen": (">u2", 54)}, _REC + _ETH + _IP + _UDP)
_TCP_HDR = _header_dtype({"seq": (">u4", 54), "ack": (">u4", 58),
                          "data_off": ("u1", 62), "flags": ("u1", 63),
                          "win": (">u2", 64)}, _REC + _ETH + _IP + _TCP)


def _allow_open_files(n: int) -> None:
    """Let the process hold `n` more open files (a capture file per
    host stays open for the session): raise the soft RLIMIT_NOFILE
    toward the hard limit when it is lower."""
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    want = n + 256
    if soft != resource.RLIM_INFINITY and soft < want:
        if hard != resource.RLIM_INFINITY:
            want = min(want, hard)
        resource.setrlimit(resource.RLIMIT_NOFILE, (want, hard))


class CaptureSession:
    """One pcap file per host, drained from the device ring between
    windows (the per-interface PCapWriter of the reference). `pool` is
    an optional native.pool.PayloadPool holding the payload bytes of
    packets that carry a payref."""

    def __init__(self, bundle, directory: str, pool=None):
        if not bundle.cfg.pcap:
            raise ValueError("build the bundle with NetConfig(pcap=True)")
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.names = bundle.host_names
        self.host_ip = bundle.sim.net.host_ip.cpu().numpy().astype(np.int64)
        self.pool = pool
        self._last = np.zeros(len(self.names), np.int64)
        _allow_open_files(len(self.names))
        self.dropped = 0
        # bytes of ring records copied from the device, over all drains
        self.bytes_copied = 0
        self._files = {}

    def _file(self, h: int):
        f = self._files.get(h)
        if f is None:
            p = self.dir / f"{self.names[h]}-eth.pcap"
            f = open(p, "wb")
            f.write(_GLOBAL_HDR)
            self._files[h] = f
        return f

    def _records(self, net):
        """(host, time, words, meta) of the records appended since the
        last drain, host-major and in append order; overruns (more than
        C new records on one host) counted in self.dropped."""
        C = net.cap_time.shape[1]
        count = net.cap_count.to(torch.int64).cpu().numpy()
        new = count - self._last
        hosts = np.flatnonzero(new > 0)
        # a host whose count went back (a restored snapshot) keeps its
        # mark, as the reference's drain does
        self._last[hosts] = count[hosts]
        if len(hosts) == 0:
            return None
        n = new[hosts]
        self.dropped += int(np.maximum(n - C, 0).sum())
        n = np.minimum(n, C)
        host = np.repeat(hosts, n)
        first = np.repeat(count[hosts] - n - (np.cumsum(n) - n), n)
        slot = (first + np.arange(len(host))) % C
        dev = net.cap_time.device
        hi = torch.from_numpy(host).to(dev)
        si = torch.from_numpy(slot).to(dev)
        rec = torch.cat([net.cap_time[hi, si][:, None],
                         net.cap_meta[hi, si].to(torch.int64)[:, None],
                         net.cap_words[hi, si].to(torch.int64)], dim=1)
        rec = rec.cpu().numpy()
        self.bytes_copied += rec.nbytes
        return host, rec[:, 0], rec[:, 2:], rec[:, 1]

    def _payload_lengths(self, words, length):
        """Each record's captured payload length, and the pool bytes of
        the records whose payref the pool holds ({index: bytes})."""
        cap = np.clip(length, 0, MAX_PAYLOAD)
        pooled = {}
        if self.pool is not None:
            for i in np.flatnonzero(words[:, pf.W_PAYREF] >= 0):
                try:
                    data = self.pool.get(int(words[i, pf.W_PAYREF]))
                except KeyError:
                    continue
                pooled[int(i)] = data[:MAX_PAYLOAD]
                cap[i] = len(pooled[int(i)])
        return cap, pooled

    def drain(self, sim) -> int:
        """Write records appended since the last drain; returns how
        many. Ring overruns (more than C new records on one host) are
        counted in self.dropped — never silent."""
        got = self._records(sim.net)
        if got is None:
            return 0
        host, t, words, meta = got
        N = len(host)
        tcp = (words[:, pf.W_PROTO] & 0xFF) == pf.PROTO_TCP
        length = words[:, pf.W_LEN]
        src_host = meta & 0xFFFFFF
        H = len(self.host_ip)
        peer_ip = np.where((src_host >= 0) & (src_host < H),
                           self.host_ip[np.clip(src_host, 0, H - 1)], 0)
        src_ip = np.where(meta >> 24 == 0, self.host_ip[host], peer_ip)
        paylen, pooled = self._payload_lengths(words, length)
        hlen = np.where(tcp, _TCP_HDR.itemsize, _UDP_HDR.itemsize)
        size = hlen + paylen
        off = np.cumsum(size) - size
        buf = np.zeros(int(size.sum()), np.uint8)
        l4 = hlen - _REC - _ETH - _IP
        for sel, dt in ((~tcp, _UDP_HDR), (tcp, _TCP_HDR)):
            if not sel.any():
                continue
            w = words[sel]
            h = np.zeros(int(sel.sum()), dt)
            h["ts_sec"] = t[sel] // 1_000_000_000
            h["ts_usec"] = (t[sel] % 1_000_000_000) // 1000
            h["incl"] = size[sel] - _REC
            h["orig"] = _ETH + _IP + l4[sel] + length[sel]
            h["src_mac0"] = h["dst_mac0"] = 0x02
            h["src_host_hi"] = src_host[sel] >> 16
            h["src_host_lo"] = src_host[sel] & 0xFFFF
            h["src_mac5"] = h["dst_mac5"] = 0x01
            h["ethertype"] = 0x0800
            h["ver_ihl"] = 0x45
            h["total"] = np.minimum(_IP + l4[sel] + length[sel], 0xFFFF)
            h["ttl"] = 64
            h["src_ip"] = src_ip[sel] & 0xFFFFFFFF
            h["dst_ip"] = w[:, pf.W_DSTIP] & 0xFFFFFFFF
            h["sport"] = w[:, pf.W_PORTS] & 0xFFFF
            h["dport"] = (w[:, pf.W_PORTS] >> 16) & 0xFFFF
            if dt is _UDP_HDR:
                h["proto"] = 17
                h["ulen"] = np.minimum(8 + length[sel], 0xFFFF)
            else:
                f = (w[:, pf.W_PROTO] >> 8) & 0xFF
                h["proto"] = 6
                h["seq"] = w[:, pf.W_SEQ] & 0xFFFFFFFF
                h["ack"] = w[:, pf.W_ACK] & 0xFFFFFFFF
                h["data_off"] = 5 << 4
                h["flags"] = (np.where(f & pf.TCPF_ACK, 0x10, 0)
                              | np.where(f & pf.TCPF_SYN, 0x02, 0)
                              | np.where(f & pf.TCPF_FIN, 0x01, 0)
                              | np.where(f & pf.TCPF_RST, 0x04, 0))
                h["win"] = np.minimum(w[:, pf.W_WIN], 0xFFFF)
            np.put(buf, off[sel][:, None] + np.arange(dt.itemsize),
                   h.view(np.uint8).reshape(len(h), dt.itemsize))
        for i, data in pooled.items():
            at = int(off[i] + hlen[i])
            buf[at:at + len(data)] = np.frombuffer(data, np.uint8)

        # each host's records are contiguous: one write per host
        ends = np.flatnonzero(np.diff(host)) + 1
        starts = np.concatenate(([0], ends))
        stops = np.concatenate((ends, [N]))
        byte_end = off + size
        view = memoryview(buf)
        for a, z in zip(starts, stops):
            self._file(int(host[a])).write(view[off[a]:byte_end[z - 1]])
        return N

    def close(self):
        for f in self._files.values():
            f.close()
        self._files.clear()
