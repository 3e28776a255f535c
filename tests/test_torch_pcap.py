"""Parity of the port's pcap capture (net/nic.py _capture, the
[H, C] ring of net/state.py, utils/pcap.py CaptureSession; ref:
pcap_writer.c and the logpcap hooks, network_interface.c:337-373) with
the reference's:

- tests/test_pcap.py's UDP pingpong (2 hosts, 3 pings of 120 bytes,
  2 sim-s) through checkpoint.run_windows with a drain after every
  window, at a 4-slot ring: EngineStats and every leaf equal, the
  files byte-equal to the reference CaptureSession's (on the
  reference's run and on the port's), and the reference test's checks
  on the port's files; drained only at the end, the ring overruns and
  `dropped` equals the reference's;
- the TCP frame branch: the built-in example (one client downloading
  8 KiB from the server, 3 sim-s) loaded with logpcap="true" on the
  server only. Both packages write a file for the client too: the
  drain writes every host that has records.

Two reference programs are compiled (one UDP, one TCP). Tolerance:
zero (integers and bytes).
"""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.apps import pingpong as jping
from shadow_tpu.config import loader as jloader
from shadow_tpu.config import xmlconfig as jxml
from shadow_tpu.core import simtime
from shadow_tpu.net import build as jbuild
from shadow_tpu.net.state import NetConfig as JConfig
from shadow_tpu.utils import checkpoint as jckpt
from shadow_tpu.utils.pcap import CaptureSession as JCapture
from shadow_tpu_torch import convert
from shadow_tpu_torch.apps import pingpong as tping
from shadow_tpu_torch.config import examples
from shadow_tpu_torch.config import loader as tloader
from shadow_tpu_torch.config import xmlconfig as txml
from shadow_tpu_torch.native.pool import PayloadPool
from shadow_tpu_torch.net import build as tbuild
from shadow_tpu_torch.net.state import NetConfig as TConfig
from shadow_tpu_torch.utils import checkpoint as tckpt
from shadow_tpu_torch.utils.pcap import CaptureSession
from test_pcap import GRAPH, PORT, SIZE, _read_pcap

torch.set_num_threads(1)

RING = 4


def _jax_leaves(sim):
    flat, _ = jax.tree_util.tree_flatten_with_path(sim)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _assert_leaves_equal(want, got):
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, (k, want[k].dtype, got[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.glob("*.pcap"))}


def _pingpong(pkg):
    """tests/test_pcap.py's build, in either package, at a 4-slot ring."""
    mod, Cfg, app, kw = ((jbuild, JConfig, jping, {}) if pkg == "jax"
                         else (tbuild, TConfig, tping, {"device": "cpu"}))
    cfg = Cfg(num_hosts=2, tcp=False, pcap=True, pcap_ring=RING,
              end_time=2 * simtime.ONE_SECOND)
    b = mod.build(cfg, GRAPH, [
        mod.HostSpec(name="cl", type="client", proc_start_time=0),
        mod.HostSpec(name="sv", type="server")], **kw)
    client, server = np.array([True, False]), np.array([False, True])
    sip = np.array([b.ip_of("sv"), 0], np.int64)
    conv = jnp.asarray if pkg == "jax" else torch.as_tensor
    b.sim = app.setup(b.sim, client_mask=conv(client),
                      server_mask=conv(server), server_ip=conv(sip),
                      server_port=PORT, count=3, size=SIZE)
    return b


def _drained_run(pkg, b, handlers, tmp, name):
    """run_windows with a drain after every window: (stats, leaves,
    {session name: session}). The port's run is drained by the port's
    session and by the reference's on the same states."""
    d = tmp / name
    caps = {"main": (JCapture if pkg == "jax" else CaptureSession)(
        b, str(d / "main"))}
    if pkg == "port":
        caps["ref_writer"] = JCapture(b, str(d / "ref_writer"))

    def drain(s, wend):
        for c in caps.values():
            c.drain(s)

    if pkg == "jax":
        sim, stats, _ = jckpt.run_windows(b, app_handlers=handlers,
                                          on_window=drain)
        leaves = _jax_leaves(sim)
    else:
        sim, stats, _ = tckpt.run_windows(b, app_handlers=handlers,
                                          on_window=drain, device="cpu")
        leaves = convert.sim_to_numpy(sim)
    # drained once more at the end, as the reference test does
    drain(sim, None)
    for c in caps.values():
        c.close()
    return stats.as_dict(), leaves, sim, caps


@pytest.fixture(scope="module")
def udp(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pcap_udp")
    return {pkg: _drained_run(pkg, _pingpong(pkg),
                              ((jping if pkg == "jax" else tping).handler,),
                              tmp, pkg)
            for pkg in ("jax", "port")}


def test_udp_run_matches_reference(udp):
    jstats, jleaves = udp["jax"][:2]
    tstats, tleaves = udp["port"][:2]
    assert tstats == jstats
    _assert_leaves_equal(jleaves, tleaves)


def test_udp_files_are_the_references_bytes(udp):
    want = _files(udp["jax"][3]["main"].dir)
    assert sorted(want) == ["cl-eth.pcap", "sv-eth.pcap"]
    for c in udp["port"][3].values():
        assert c.dropped == 0
        assert _files(c.dir) == want


def test_udp_pingpong_frames(udp):
    """tests/test_pcap.py's checks on the port's files."""
    d = udp["port"][3]["main"].dir
    assert int(udp["port"][1][".app.rcvd"][0]) == 3
    cl, sv = _read_pcap(d / "cl-eth.pcap"), _read_pcap(d / "sv-eth.pcap")
    assert len(cl) == 6 and len(sv) == 6
    frame = sv[0][2]
    assert frame[12:14] == b"\x08\x00"
    ver_ihl, _, total_len = struct.unpack(">BBH", frame[14:18])
    assert ver_ihl == 0x45 and frame[23] == 17
    assert struct.unpack(">HHHH", frame[34:42])[1:3] == (PORT, 8 + SIZE)
    assert total_len == 20 + 8 + SIZE and len(frame) == 14 + 20 + 8 + SIZE
    # the first reply comes back >= 2 x 25 ms after the first ping
    t0 = cl[0][0] * 1_000_000 + cl[0][1]
    assert cl[1][0] * 1_000_000 + cl[1][1] - t0 >= 50_000


def test_overrun_is_counted_like_the_reference(udp, tmp_path):
    """Drained only at the end, 6 records per host overrun the 4-slot
    ring: 2 lost per host, and the 4 kept written as the reference's
    session writes them."""
    jsim, tsim = udp["jax"][2], udp["port"][2]
    bj, bt = _pingpong("jax"), _pingpong("port")
    j = JCapture(bj, str(tmp_path / "ref"))
    t = CaptureSession(bt, str(tmp_path / "port"))
    assert j.drain(jsim) == t.drain(tsim) == 2 * RING
    j.close()
    t.close()
    assert t.dropped == j.dropped == 4
    assert _files(t.dir) == _files(j.dir)


def test_pool_payloads_are_written(udp, tmp_path):
    """A payref the pool holds is written as its bytes (the rest stay
    zeros of the advertised length), as the reference writes them."""
    tsim = udp["port"][2]
    words = tsim.net.cap_words.clone()
    words[0, :, 3] = 0                     # W_PAYREF of the client's ring
    sim = tsim.replace(net=tsim.net.replace(cap_words=words))
    pool = PayloadPool()
    assert pool.put(bytes(range(100))) == 0
    out = []
    for cls, name in ((JCapture, "ref"), (CaptureSession, "port")):
        c = cls(_pingpong("port"), str(tmp_path / name), pool=pool)
        c.drain(sim)
        c.close()
        out.append(_files(c.dir))
    assert out[0] == out[1]
    assert bytes(range(100)) in out[1]["cl-eth.pcap"]


TCP_TEXT = examples.example_config(clients=1, kib=8, stoptime=3).replace(
    '<host id="server"', '<host id="server" logpcap="true"')


@pytest.fixture(scope="module")
def tcp(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pcap_tcp")
    jl = jloader.load(jxml.parse_config(TCP_TEXT), seed=1)
    tl = tloader.load(txml.parse_config(TCP_TEXT), seed=1, device="cpu")
    assert tl.bundle.cfg.pcap and jl.bundle.cfg.pcap and tl.bundle.cfg.tcp
    return {"jax": _drained_run("jax", jl.bundle, jl.handlers, tmp, "jax"),
            "port": _drained_run("port", tl.bundle, tl.handlers, tmp,
                                 "port")}


def test_tcp_run_and_files_match_reference(tcp):
    jstats, jleaves, _, jcaps = tcp["jax"]
    tstats, tleaves, _, tcaps = tcp["port"]
    assert tstats == jstats
    _assert_leaves_equal(jleaves, tleaves)
    want = _files(jcaps["main"].dir)
    assert sorted(want) == ["client-eth.pcap", "server-eth.pcap"]
    for c in tcaps.values():
        assert c.dropped == jcaps["main"].dropped == 0
        assert _files(c.dir) == want
    # the TCP branch: a SYN from the client, data and ACKs both ways
    frames = [f for *_, f in _read_pcap(tcaps["main"].dir
                                         / "server-eth.pcap")]
    assert all(f[23] == 6 for f in frames)
    assert any(f[47] & 0x02 for f in frames)           # SYN
    assert sum(len(f) - 54 for f in frames) >= 8192     # the payload
