"""The loss trim on the TCP paths of the port, against the reference, on
the CPU: an 8-host relay (4 circuits x 2 hops, 30,000 bytes, lossless
one-vertex 50 ms graph, 4 sockets, capacities 64, the ring on)
specialized with relay's handler and its TCP bulk pass.

- the vector drops the loss capability alone (relay declares no
  emit kinds, so timers stay live), as the reference's does;
- through the TCP bulk pass (net/tcp_bulk.py `rel_dead`: both draw
  sites skipped, the draw bookkeeping kept) the trimmed run equals the
  port's untrimmed run in every leaf (the guard aside) and the
  reference's trimmed run in every leaf;
- through the serial NIC drain (the bulk pass off: nic._drain_one's
  arithmetic counter advance) the trimmed run equals the untrimmed one;
- both again from a boot state whose rng_ctr is 2**32 - 2 on every
  host, so the masked advance wraps (the bulk case also against the
  reference, whose u32 counters wrap natively);
- no reliability draw of the netstack runs in a trimmed run.

One reference program (the TCP bulk whole run) is compiled for the
file. Tolerance zero.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu import telemetry as jtel
from shadow_tpu.apps import relay as jrelay
from shadow_tpu.compile import specialize as jspec
from shadow_tpu.net import build as jbuild
from shadow_tpu.net.state import NetConfig as JConfig
from shadow_tpu_torch import convert
from shadow_tpu_torch import telemetry as ttel
from shadow_tpu_torch.apps import relay as trelay
from shadow_tpu_torch.compile import specialize as tspec
from shadow_tpu_torch.core import rng, simtime
from shadow_tpu_torch.net import build as tbuild
from shadow_tpu_torch.net.state import NetConfig as TConfig
from torch_parity import assert_leaves_equal, jax_leaves

torch.set_num_threads(1)

GRAPH = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="latency" attr.type="double" for="edge" id="lat" />
  <key attr.name="bandwidthup" attr.type="int" for="node" id="up" />
  <key attr.name="bandwidthdown" attr.type="int" for="node" id="dn" />
  <graph edgedefault="undirected">
    <node id="v0"><data key="up">102400</data><data key="dn">102400</data>
    </node>
    <edge source="v0" target="v0"><data key="lat">50.0</data></edge>
  </graph>
</graphml>"""

H = 8
HOP = 2
TOTAL = 30_000
END = 4 * simtime.ONE_SECOND
CAP = 64
WRAP = 2**32 - 2
GUARD = (".guard.loss_trips", ".guard.timer_trips")


def _bundle(pkg):
    mod, C, relay, tel, dev = (
        (jbuild, JConfig, jrelay, jtel, {}) if pkg == "jax"
        else (tbuild, TConfig, trelay, ttel, {"device": "cpu"}))
    cfg = C(num_hosts=H, end_time=END, sockets_per_host=4,
            event_capacity=CAP, outbox_capacity=CAP, router_ring=CAP)
    hosts = [mod.HostSpec(name=f"n{i}", proc_start_time=simtime.ONE_SECOND)
             for i in range(H)]
    b = mod.build(cfg, GRAPH, hosts, **dev)
    circuits = [list(range(c * HOP, (c + 1) * HOP)) for c in range(H // HOP)]
    b.sim = tel.attach(relay.setup(b.sim, circuits=circuits,
                                   total_bytes=TOTAL))
    return b


def _specialized(pkg):
    spec, relay = (jspec, jrelay) if pkg == "jax" else (tspec, trelay)
    b = spec.apply(_bundle(pkg), (relay.handler,),
                   app_tcp_bulk=relay.TCP_BULK)
    assert b.caps.dropped() == ("loss",)
    return b


def _wrapped(sim):
    """The sim with every host's draw counter at 2**32 - 2."""
    ctr = sim.net.rng_ctr
    new = (jnp.full_like(ctr, WRAP) if isinstance(ctr, jax.Array)
           else torch.full_like(ctr, WRAP))
    return sim.replace(net=sim.net.replace(rng_ctr=new))


def _port(trimmed, bulk, wrap):
    b = _specialized("port") if trimmed else _bundle("port")
    sim0 = _wrapped(b.sim) if wrap else b.sim
    sim, stats = tbuild.make_runner(
        b, app_handlers=(trelay.handler,),
        app_tcp_bulk=trelay.TCP_BULK if bulk else None,
        device="cpu")(sim0)
    # the port carries the u32 counters in int64: they must stay below
    # 2**32 on the tensor itself (the numpy leaves are cast to uint32,
    # which would hide an unmasked advance)
    assert 0 <= int(sim.net.rng_ctr.min()) <= int(sim.net.rng_ctr.max()) \
        < 2**32
    return convert.sim_to_numpy(sim), stats.as_dict()


@pytest.fixture(scope="module")
def reference():
    """The reference's trimmed TCP bulk run from the boot state and from
    the wrapped one (one compiled runner, two inputs)."""
    b = _specialized("jax")
    runner = jbuild.make_runner(b, app_handlers=(jrelay.handler,),
                                app_tcp_bulk=jrelay.TCP_BULK)
    out = {}
    for wrap in (False, True):
        sim, stats = runner(_wrapped(b.sim) if wrap else b.sim)
        sim, stats = jax.device_get((sim, stats))
        out[wrap] = (jax_leaves(sim), stats.as_dict())
    return out


def test_relay_vector_drops_loss_only_like_the_reference():
    want = _specialized("jax")
    got = _specialized("port")
    assert got.caps.as_dict() == want.caps.as_dict()
    assert got.caps.timers and not got.caps.loss
    assert got.sim.guard.watched() == ("loss",)
    assert tspec.specialization_block(got.caps, got.sim) == \
        jspec.specialization_block(want.caps, want.sim)


def _unguarded(leaves):
    return {k: v for k, v in leaves.items() if k not in GUARD}


@pytest.mark.parametrize("wrap", [False, True], ids=["boot", "wrap"])
def test_trimmed_tcp_bulk_run_equals_untrimmed_and_reference(reference,
                                                             wrap):
    got, gstats = _port(True, True, wrap)
    full, fstats = _port(False, True, wrap)
    want, wstats = reference[wrap]
    assert gstats == fstats == wstats
    assert_leaves_equal(want, got)
    assert_leaves_equal(full, _unguarded(got))
    assert int(got[".guard.loss_trips"]) == 0
    assert int(got[".net.ctr_drop_reliability"].sum()) == 0
    # every stream complete by the end
    servers = np.arange(HOP - 1, H, HOP)
    assert (got[".app.rcvd"][servers] == TOTAL).all()
    if wrap:
        # the counters wrapped past 2**32 and back to small values
        assert (got[".net.rng_ctr"] < WRAP).all()


@pytest.mark.parametrize("wrap", [False, True], ids=["boot", "wrap"])
def test_trimmed_serial_drain_equals_untrimmed(wrap):
    got, gstats = _port(True, False, wrap)
    full, fstats = _port(False, False, wrap)
    assert gstats == fstats and gstats["micro_steps"] > 0
    assert_leaves_equal(full, _unguarded(got))
    if wrap:
        assert (got[".net.rng_ctr"] < WRAP).all()


def test_no_netstack_draw_in_a_trimmed_tcp_run(monkeypatch):
    n = {"draws": 0}
    for name in ("uniform", "uniform_at"):
        orig = getattr(rng, name)

        def counted(*a, _orig=orig, **kw):
            caller = sys._getframe(1).f_globals.get("__name__", "")
            if caller.startswith("shadow_tpu_torch.net."):
                n["draws"] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(rng, name, counted)
    for trimmed in (False, True):
        n["draws"] = 0
        _port(trimmed, True, False)
        assert (n["draws"] == 0) == trimmed, n
