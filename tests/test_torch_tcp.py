"""Function-level parity of the port's TCP modules
(shadow_tpu_torch/net/tcp_cong.py, net/tcp.py) with the reference's, on
seeded numpy inputs handed to both packages. The reference's functions
run eagerly here (no whole-run program is compiled).

- tcp_cong: ssthresh_on_loss, cwnd_on_recovery_entry, ca_update and
  on_loss_event for reno, aimd and cubic over a seeded sweep of cwnd,
  ssthresh, accumulator, acked-packet, W_max, epoch and time inputs
  (cubic's epochs both unset and set, times before and after K);
  cubic's K for every integer W_max below 2**20.
- sack_clip_len, and sack_advert with tied left edges, empty ranges and
  fully empty rows.
- _seg_words and stamp_at_wire with peer IPs above 2**31.
- TcpState.create at initial_cwnd / initial_ssthresh of configs with
  tcp_windows / tcp_ssthresh pinned and unpinned.

Tolerance: zero (integer state; cubic's float32 arithmetic compared at
its integer outputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.core import simtime
from shadow_tpu.net import build as jbuild
from shadow_tpu.net import tcp as jtcp
from shadow_tpu.net import tcp_cong as jcong
from shadow_tpu.net.state import NetConfig as JConfig
from shadow_tpu_torch import convert
from shadow_tpu_torch.net import build as tbuild
from shadow_tpu_torch.net import tcp as ttcp
from shadow_tpu_torch.net import tcp_cong as tcong
from shadow_tpu_torch.net.state import NetConfig as TConfig

torch.set_num_threads(1)

GRAPH = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="latency" attr.type="double" for="edge" id="lat" />
  <key attr.name="bandwidthup" attr.type="int" for="node" id="up" />
  <key attr.name="bandwidthdown" attr.type="int" for="node" id="dn" />
  <graph edgedefault="undirected">
    <node id="poi"><data key="up">10240</data><data key="dn">10240</data>
    </node>
    <edge source="poi" target="poi"><data key="lat">25.0</data></edge>
  </graph>
</graphml>"""

N = 4096


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _cong_inputs(seed):
    r = np.random.default_rng(seed)
    i32 = np.int32
    cwnd = r.integers(1, 4000, N).astype(i32)
    wmax = np.where(r.random(N) < 0.1, r.integers(0, 3, N),
                    r.integers(2, 1 << 16, N)).astype(i32)
    epoch = np.where(r.random(N) < 0.3, -1,
                     r.integers(0, 60_000, N)).astype(i32)
    now_ms = (np.maximum(epoch, 0) + r.integers(0, 200_000, N)).astype(i32)
    return dict(
        mask=r.random(N) < 0.8, cwnd=cwnd,
        ca_acc=r.integers(0, 4000, N).astype(i32),
        n_acked=r.integers(0, 64, N).astype(i32),
        wmax=wmax, epoch=epoch, now_ms=now_ms)


@pytest.mark.parametrize("alg", ["reno", "aimd", "cubic"])
@pytest.mark.parametrize("seed", [0, 1])
def test_tcp_cong_matches_reference(alg, seed):
    a = tcong.NAMES[alg]
    assert jcong.NAMES[alg] == a
    x = _cong_inputs(seed)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    _eq(tcong.ssthresh_on_loss(a, t["cwnd"]),
        jcong.ssthresh_on_loss(a, j["cwnd"]))
    _eq(tcong.cwnd_on_recovery_entry(a, t["cwnd"]),
        jcong.cwnd_on_recovery_entry(a, j["cwnd"]))
    args = ("mask", "cwnd", "ca_acc", "n_acked", "wmax", "epoch", "now_ms")
    for got, want in zip(tcong.ca_update(a, *(t[k] for k in args)),
                         jcong.ca_update(a, *(j[k] for k in args))):
        _eq(got, want)
    args = ("mask", "cwnd", "wmax", "epoch")
    for got, want in zip(tcong.on_loss_event(a, *(t[k] for k in args)),
                         jcong.on_loss_event(a, *(j[k] for k in args))):
        _eq(got, want)


def test_cubic_cube_root_matches_reference_for_every_window():
    """K = cbrt(W_max * (1 - beta) / C) is the reference's, bit for bit,
    for every integer W_max in [2, 2**20): the reference's jnp.cbrt is
    libm's powf on the CPU, which is not correctly rounded."""
    w = np.arange(2, 1 << 20, dtype=np.int32)
    want = jnp.cbrt(jnp.asarray(w).astype(jnp.float32)
                    * (1.0 - jcong.CUBIC_BETA) / jcong.CUBIC_C)
    x = tcong._div(torch.as_tensor(w).to(torch.float32)
                   * (1.0 - tcong.CUBIC_BETA), tcong.CUBIC_C)
    _eq(tcong._cbrt_f32(x), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sack_clip_len_matches_reference(seed):
    r = np.random.default_rng(seed)
    una = r.integers(0, 50_000, N).astype(np.int32)
    seg = r.integers(0, ttcp.MSS + 1, N).astype(np.int32)
    sl = (una[:, None] + r.integers(-3000, 6000, (N, 3))).astype(np.int32)
    sr = (sl + r.integers(-500, 3000, (N, 3))).astype(np.int32)
    sl[r.random((N, 3)) < 0.2] = 0
    want = jtcp.sack_clip_len(*map(jnp.asarray, (una, seg, sl, sr)))
    got = ttcp.sack_clip_len(*map(torch.as_tensor, (una, seg, sl, sr)))
    _eq(got, want)


H, S = 16, 4


@pytest.fixture(scope="module")
def bundles():
    """A 16-host TCP bundle in each package with seeded socket and
    receive-side state: peer IPs above 2**31, ports, buffers, and
    reassembly ranges with tied left edges, empty slots and empty
    rows."""
    cfg_kw = dict(num_hosts=H, sockets_per_host=S,
                  end_time=simtime.ONE_SECOND)
    hosts = [jbuild.HostSpec(name=f"n{i}") for i in range(H)]
    jb = jbuild.build(JConfig(**cfg_kw), GRAPH, hosts)
    tb = tbuild.build(TConfig(**cfg_kw), GRAPH,
                      [tbuild.HostSpec(name=f"n{i}") for i in range(H)],
                      device="cpu")
    r = np.random.default_rng(7)
    hs = (H, S)
    net = dict(
        sk_peer_ip=r.integers(2**31, 2**32, hs).astype(np.int64),
        sk_peer_port=r.integers(1, 65536, hs).astype(np.int32),
        sk_bound_port=r.integers(1, 65536, hs).astype(np.int32),
        sk_rcvbuf=r.integers(0, 200_000, hs).astype(np.int32))
    ool = r.integers(0, 4, (H, S, ttcp.OO_RANGES)) * 1000
    oor = ool + r.integers(-1, 3, ool.shape) * 700
    oor[:4] = ool[:4]                      # rows with no parked range
    tcp = dict(
        rcv_nxt=r.integers(0, 1 << 30, hs).astype(np.int32),
        app_rbytes=r.integers(0, 250_000, hs).astype(np.int32),
        ts_recent=r.integers(0, 1 << 30, hs).astype(np.int32),
        oo_l=ool.astype(np.int32), oo_r=oor.astype(np.int32))
    jnet = jb.sim.net.replace(**{k: jnp.asarray(v) for k, v in net.items()})
    jt = jb.sim.tcp.replace(**{k: jnp.asarray(v) for k, v in tcp.items()})
    tnet = tb.sim.net.replace(**{k: torch.as_tensor(v)
                                 for k, v in net.items()})
    tt = tb.sim.tcp.replace(**{k: torch.as_tensor(v) for k, v in tcp.items()})
    return (jnet, jt), (tnet, tt), r


def _slots(r):
    slot = r.integers(-1, S, H).astype(np.int64)
    mask = r.random(H) < 0.75
    return slot, mask


def test_sack_advert_matches_reference(bundles):
    (_, jt), (_, tt), r = bundles
    for _ in range(4):
        slot, _ = _slots(r)
        want = jtcp.sack_advert(jt, jnp.asarray(slot))
        got = ttcp.sack_advert(tt, torch.as_tensor(slot))
        for (gl, gr), (wl, wr) in zip(got, want):
            _eq(gl, wl)
            _eq(gr, wr)


def test_seg_words_and_stamp_at_wire_match_reference(bundles):
    (jnet, jt), (tnet, tt), r = bundles
    for flags in (ttcp.pf.TCPF_SYN, ttcp.pf.TCPF_ACK,
                  ttcp.pf.TCPF_FIN | ttcp.pf.TCPF_ACK):
        slot, mask = _slots(r)
        seq = r.integers(0, 1 << 30, H).astype(np.int32)
        length = r.integers(0, ttcp.MSS + 1, H).astype(np.int32)
        now = r.integers(0, 100 * simtime.ONE_SECOND, H).astype(np.int64)
        jw = jtcp._seg_words(jnet, jnp.asarray(mask), jnp.asarray(slot),
                             flags, jnp.asarray(seq), jnp.asarray(length))
        tw = ttcp._seg_words(tnet, torch.as_tensor(mask),
                             torch.as_tensor(slot), flags,
                             torch.as_tensor(seq), torch.as_tensor(length))
        _eq(tw, jw)
        assert (np.asarray(jw)[:, ttcp.pf.W_DSTIP] < 0).any()
        _eq(ttcp.stamp_at_wire(tnet, tt, torch.as_tensor(mask),
                               torch.as_tensor(slot), tw,
                               torch.as_tensor(now)),
            jtcp.stamp_at_wire(jnet, jt, jnp.asarray(mask),
                               jnp.asarray(slot), jw, jnp.asarray(now)))


@pytest.mark.parametrize("windows,ssthresh", [(0, 0), (10, 0), (0, 40),
                                              (4, 8)])
def test_tcp_state_create_matches_reference(windows, ssthresh):
    kw = dict(num_hosts=3, sockets_per_host=5, tcp_windows=windows,
              tcp_ssthresh=ssthresh)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    assert ttcp.initial_cwnd(tcfg) == jtcp.initial_cwnd(jcfg)
    assert ttcp.initial_ssthresh(tcfg) == jtcp.initial_ssthresh(jcfg)
    want = jtcp.TcpState.create(3, 5, init_cwnd=jtcp.initial_cwnd(jcfg),
                                init_ssthresh=jtcp.initial_ssthresh(jcfg))
    got = ttcp.TcpState.create(3, 5, init_cwnd=ttcp.initial_cwnd(tcfg),
                               init_ssthresh=ttcp.initial_ssthresh(tcfg))
    flat, _ = jax.tree_util.tree_flatten_with_path(want)
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}
    got = {k.replace(".tcp", "", 1): v for k, v in convert.sim_to_numpy(
        tbuild.Sim(events=None, outbox=None, net=None, tcp=got)).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        _eq(got[k], want[k])
