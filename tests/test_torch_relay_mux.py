"""Parity of the port's shared-relay (multiplexed) Tor model
(shadow_tpu_torch/apps/relay.py setup_shared, mux_handler,
RelayMuxTcpBulk / MUX_TCP_BULK, consensus_circuits) with the reference
(shadow_tpu) on the CPU.

The shape is the reference test's (tests/test_relay_mux.py): 10 hosts
(6 clients, 3 relays, 1 server), 4 two-relay circuits drawn by
consensus weight that share relays, SLOTS = 4 circuit slots per host,
2 + 2*SLOTS sockets, capacities 64, 20,000 bytes per circuit, the
one-vertex 50 ms topology of tests/test_tcp_bulk.py, 10 sim-s — once
lossless and once with 1% loss on the self-edge. Each case runs through
the TCP bulk pass in both packages (EngineStats and every state leaf
equal), and serial in the port (equal to the reference's bulk run
under the reference's bulk-vs-serial contract, with the same events
and windows). One reference runner is compiled for the file: the loss
is topology data, so the cases differ only in state; the reference's
runs and the port's go side by side. Tolerance: zero.
"""

import dataclasses
from collections import Counter

import jax
import numpy as np
import pytest
import torch

from shadow_tpu.apps import relay as jrelay
from shadow_tpu.core import simtime
from shadow_tpu.net import build as jbuild
from shadow_tpu.net.state import NetConfig as JConfig
from shadow_tpu_torch import convert
from shadow_tpu_torch.apps import relay as trelay
from shadow_tpu_torch.net import build as tbuild
from shadow_tpu_torch.net.state import NetConfig as TConfig
from tests.test_torch_tcp_bulk import (
    GRAPH, _assert_contract, _assert_leaves_equal, _jax_leaves)
from torch_parity import side_by_side

torch.set_num_threads(1)

H = 10
SLOTS = 4
TOTAL = 20_000
END = 10 * simtime.ONE_SECOND
CAP = 64
# name -> path loss on the self-edge
CASES = {"lossless": 0.0, "loss1pct": 0.01}


def _chains(relay):
    """6 clients, 3 relays, 1 server; 2-relay circuits drawn by
    consensus weight (the reference test's draw)."""
    rng = np.random.default_rng(5)
    return relay.consensus_circuits(
        rng, n_circuits=4, clients=list(range(6)), relays=[6, 7, 8],
        servers=[9], hops=2, max_slots=SLOTS)


def _bundle(mod, cfg_cls, relay, name, **kw):
    cfg = cfg_cls(num_hosts=H, seed=1, end_time=END,
                  sockets_per_host=2 + 2 * SLOTS, event_capacity=CAP,
                  outbox_capacity=CAP, router_ring=CAP)
    hosts = [mod.HostSpec(name=f"n{i}", proc_start_time=simtime.ONE_SECOND)
             for i in range(H)]
    b = mod.build(cfg, GRAPH % {"bw": 102400, "loss": CASES[name]}, hosts,
                  **kw)
    b.sim = relay.setup_shared(b.sim, circuits=_chains(relay),
                               total_bytes=TOTAL, max_slots=SLOTS)
    return b


def _port_run(tb, **kw):
    return tbuild.make_runner(tb, app_handlers=(trelay.mux_handler,),
                              device="cpu", **kw)(tb.sim)


@pytest.fixture(scope="module")
def runs():
    """Each case's reference run and the port's bulk and serial runs;
    the reference's runs and the port's go side by side."""
    jbs = {name: _bundle(jbuild, JConfig, jrelay, name) for name in CASES}
    tbs = {name: _bundle(tbuild, TConfig, trelay, name, device="cpu")
           for name in CASES}

    def ref():
        runner = jbuild.make_runner(next(iter(jbs.values())),
                                    app_handlers=(jrelay.mux_handler,),
                                    app_tcp_bulk=jrelay.MUX_TCP_BULK)
        out = {}
        for name, jb in jbs.items():
            jsim, jstats = runner(jb.sim)
            out[name] = {"jax_stats": jstats.as_dict(),
                         "jax_final": _jax_leaves(jsim)}
        return out

    def port():
        out = {}
        for name, tb in tbs.items():
            bsim, bstats = _port_run(tb, app_tcp_bulk=trelay.MUX_TCP_BULK)
            ssim, sstats = _port_run(tb)
            out[name] = {"bulk": (bsim, bstats.as_dict()),
                         "serial": (ssim, sstats.as_dict())}
        return out

    refs, ports = side_by_side([ref, port])
    return {name: {"boot": _jax_leaves(jbs[name].sim),
                   "port_boot": convert.sim_to_numpy(tbs[name].sim),
                   **refs[name], **ports[name]} for name in CASES}


def test_chains_share_relays():
    chains = _chains(trelay)
    assert chains == _chains(jrelay)
    relay_use = Counter(h for ch in chains for h in ch[1:-1])
    assert max(relay_use.values()) > 1, relay_use


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_consensus_circuits_match_reference(seed):
    """The Tor shape of tools/scale_run.py at 1,000 hosts: 60% clients,
    30% relays, 10% servers, 3 hops, 8 slots — the same chains from the
    same generator, which ends in the same state."""
    args = dict(n_circuits=600, clients=range(600), relays=range(600, 900),
                servers=range(900, 1000), hops=3, max_slots=8)
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    want = jrelay.consensus_circuits(rj, **args)
    got = trelay.consensus_circuits(rt, **args)
    assert got == want and len(got) == 600
    assert rj.integers(2**62) == rt.integers(2**62)


@pytest.mark.parametrize("name", list(CASES))
def test_boot_state_matches_reference(runs, name):
    _assert_leaves_equal(runs[name]["boot"], runs[name]["port_boot"])


def test_setup_shared_refuses_an_overfull_host():
    with pytest.raises(ValueError, match="max_slots"):
        cfg = TConfig(num_hosts=H, sockets_per_host=4)
        b = tbuild.build(cfg, GRAPH % {"bw": 102400, "loss": 0.0},
                         [tbuild.HostSpec(name=f"n{i}") for i in range(H)],
                         device="cpu")
        trelay.setup_shared(b.sim, circuits=[[0, 2, 9], [1, 2, 9]],
                            total_bytes=TOTAL, max_slots=1)


@pytest.mark.parametrize("name", list(CASES))
def test_bulk_stats_match_reference(runs, name):
    assert runs[name]["bulk"][1] == runs[name]["jax_stats"]


@pytest.mark.parametrize("name", list(CASES))
def test_bulk_every_leaf_matches_reference(runs, name):
    _assert_leaves_equal(runs[name]["jax_final"],
                         convert.sim_to_numpy(runs[name]["bulk"][0]))


@pytest.mark.parametrize("name", list(CASES))
def test_serial_contract_with_reference_bulk(runs, name):
    """The port's serial mux handler ends where the reference's bulk
    pass ends, under the reference's contract, with the same events
    and windows and more micro-steps (the pass engages)."""
    r = runs[name]
    sim, st = r["serial"]
    _assert_contract(r["jax_final"], convert.sim_to_numpy(sim))
    assert st["events_processed"] == r["jax_stats"]["events_processed"]
    assert st["windows"] == r["jax_stats"]["windows"]
    assert r["bulk"][1]["micro_steps"] < st["micro_steps"]


@pytest.mark.parametrize("mode", ["bulk", "serial"])
@pytest.mark.parametrize("name", list(CASES))
def test_every_stream_completes(runs, name, mode):
    sim, _ = runs[name][mode]
    rcvd = sim.app.rcvd.numpy()
    assert rcvd.sum() == 4 * TOTAL
    # the server's per-slot streams each completed in full
    assert sorted(rcvd[9][rcvd[9] > 0].tolist()) == [TOTAL] * 4
    assert int(sim.events.overflow) == 0 and int(sim.outbox.overflow) == 0
    assert int(sim.net.rq_overflow) == 0
    if CASES[name] > 0:
        assert int(sim.tcp.retx_segs.sum()) > 0


def _app_tensors(app):
    return {f.name: getattr(app, f.name) for f in dataclasses.fields(app)}


def test_bulk_hooks_build_new_tensors(runs):
    """on_data and on_eof leave the app they are given untouched (the
    TCP bulk pass reverts by object identity) and equal the reference's
    hooks on the same inputs: every live slot connected with an
    upstream child, a delivery and then an EOF on each host's slot 1."""
    tapp = convert.sim_from_numpy(runs["lossless"]["boot"],
                                  device="cpu").app
    up = torch.arange(H * SLOTS, dtype=torch.int32).reshape(H, SLOTS)
    tapp = tapp.replace(up_conn=torch.where(tapp.s_role > 0, up, -1),
                        connected=tapp.s_role > 0)
    before = {k: v.clone() for k, v in _app_tensors(tapp).items()}
    japp = jrelay.RelayMuxApp(**{k: jax.numpy.asarray(v.numpy())
                                 for k, v in _app_tensors(tapp).items()})
    mask = torch.ones(H, dtype=torch.bool)
    slot = tapp.up_conn[:, 1].clone()
    nread = torch.full((H,), 1434, dtype=torch.int32)
    now = torch.full((H,), 5 * simtime.ONE_SECOND, dtype=torch.int64)

    def j(*ts):
        return [jax.numpy.asarray(t.numpy()) for t in ts]

    pairs = (
        (jrelay.MUX_TCP_BULK.on_data(None, japp, *j(mask, slot, nread, now)),
         trelay.MUX_TCP_BULK.on_data(None, tapp, mask, slot, nread, now)),
        (jrelay.MUX_TCP_BULK.on_eof(None, japp, *j(mask, slot, now)),
         trelay.MUX_TCP_BULK.on_eof(None, tapp, mask, slot, now)),
    )
    for k, v in _app_tensors(tapp).items():
        assert torch.equal(v, before[k]), k
    for jo, to in pairs:
        for f in dataclasses.fields(to[0]):
            np.testing.assert_array_equal(
                getattr(to[0], f.name).numpy(),
                np.asarray(getattr(jo[0], f.name)), err_msg=f.name)
        for a, b in zip(jo[1:], to[1:]):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    (_, _, fwd, _, _), (_, eof_ok, _, _, _, _) = (p[1] for p in pairs)
    assert bool(fwd.any()) and bool(eof_ok.all())
