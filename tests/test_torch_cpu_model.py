"""Parity of the port's virtual CPU (net/step.py _cpu_gate, the
cpu_cost of net/state.py, the blocked-event count in core/engine.py)
with the reference's, on tests/test_cpu_model.py's shape: two ping
clients and two servers, server1 on a CPU 100x slower, 1 ms charged
per event, 20 pings, 8 sim-s.

- the slow host: blocked events are re-queued with their identity, so
  EngineStats (events_processed counting each deferred event once) and
  every leaf equal the reference's, and the reference test's checks
  hold on the port's run;
- the gate off by default: equal again, nothing blocked or charged;
- the CLI's default `--specialize auto` trims the program: the trimmed
  slow-host run equals the untrimmed one leaf for leaf.

One reference program is compiled per case. Tolerance: zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.apps import pingpong as jping
from shadow_tpu.core import simtime
from shadow_tpu.net import build as jbuild
from shadow_tpu.net.state import NetConfig as JConfig
from shadow_tpu_torch import convert
from shadow_tpu_torch.apps import pingpong as tping
from shadow_tpu_torch.compile import specialize
from shadow_tpu_torch.net import build as tbuild
from shadow_tpu_torch.net.state import NetConfig as TConfig
from test_cpu_model import GRAPH

torch.set_num_threads(1)

SLOW_KHZ = 30_000


def _jax_leaves(sim):
    flat, _ = jax.tree_util.tree_flatten_with_path(sim)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _assert_leaves_equal(want, got, skip=()):
    assert sorted(k for k in want if k not in skip) == sorted(
        k for k in got if k not in skip)
    for k in want:
        if k in skip:
            continue
        assert want[k].dtype == got[k].dtype, (k, want[k].dtype, got[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _build(pkg, cpu_threshold_ns, slow_freq_khz, count=20):
    """tests/test_cpu_model.py's _build, in either package."""
    if pkg == "jax":
        build, HostSpec, Cfg, app, kw = (jbuild.build, jbuild.HostSpec,
                                         JConfig, jping, {})
    else:
        build, HostSpec, Cfg, app, kw = (tbuild.build, tbuild.HostSpec,
                                         TConfig, tping, {"device": "cpu"})
    cfg = Cfg(num_hosts=4, tcp=False, end_time=8 * simtime.ONE_SECOND,
              seed=1, cpu_threshold_ns=cpu_threshold_ns,
              cpu_event_cost_ns=1_000_000, cpu_precision_ns=200_000)
    hosts = [HostSpec(name="client0", proc_start_time=simtime.ONE_SECOND),
             HostSpec(name="client1", proc_start_time=simtime.ONE_SECOND),
             HostSpec(name="server0"),
             HostSpec(name="server1", cpufrequency_khz=slow_freq_khz)]
    b = build(cfg, GRAPH, hosts, **kw)
    client, server = np.arange(4) < 2, np.arange(4) >= 2
    sip = np.zeros(4, np.int64)
    sip[0], sip[1] = b.ip_of("server0"), b.ip_of("server1")
    if pkg == "jax":
        client, server, sip = (jnp.asarray(client), jnp.asarray(server),
                               jnp.asarray(sip))
    else:
        client, server, sip = (torch.as_tensor(client),
                               torch.as_tensor(server), torch.as_tensor(sip))
    b.sim = app.setup(b.sim, client_mask=client, server_mask=server,
                      server_ip=sip, server_port=7000, count=count, size=64)
    return b


CASES = {"slow_host": 2_000_000, "disabled": -1}


@pytest.fixture(scope="module")
def runs():
    out = {}
    for name, thr in CASES.items():
        slow = SLOW_KHZ if name == "slow_host" else 300_000
        jb, tb = _build("jax", thr, slow), _build("port", thr, slow)
        jsim, jstats = jbuild.run(jb, app_handlers=(jping.handler,))
        tsim, tstats = tbuild.run(tb, app_handlers=(tping.handler,),
                                  device="cpu")
        out[name] = (jstats.as_dict(), _jax_leaves(jsim), tstats.as_dict(),
                     convert.sim_to_numpy(tsim), tb)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_matches_reference(runs, name):
    jstats, jleaves, tstats, tleaves, _ = runs[name]
    assert tstats == jstats
    _assert_leaves_equal(jleaves, tleaves)


def test_cost_is_scaled_and_rounded_like_the_reference(runs):
    """cpu_cost: 1 ms scaled by raw/host frequency (100x on server1),
    rounded half-up to the 200-us precision, as the boot leaves."""
    jb = _build("jax", 2_000_000, SLOW_KHZ)
    tb = runs["slow_host"][4]
    want = np.asarray(jb.sim.net.cpu_cost)
    got = tb.sim.net.cpu_cost.numpy()
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [1_000_000, 1_000_000, 1_000_000, 100_000_000]


def test_slow_host_lags_deterministically(runs):
    """The reference test's checks on the port's run: events blocked
    (more on the slow server), every ping answered, and the executed
    count excludes the re-queued pops."""
    _, _, tstats, leaves, tb = runs["slow_host"]
    blocked = leaves[".net.ctr_cpu_blocked"]
    assert blocked.sum() > 0
    assert leaves[".app.rcvd"][:2].tolist() == [20, 20]
    assert blocked[tb.host_of("server1")] > blocked[tb.host_of("server0")]
    assert leaves[".net.ctr_events_exec"].sum() == tstats["events_processed"]
    assert leaves[".net.ctr_cpu_delay_ns"].sum() > 0


def test_disabled_by_default_costs_nothing(runs):
    leaves = runs["disabled"][3]
    assert leaves[".net.ctr_cpu_blocked"].sum() == 0
    assert leaves[".net.cpu_avail"].max() == 0


def test_trimmed_program_equals_the_untrimmed(runs):
    """specialize.apply (mode auto, the CLI's default) on the slow-host
    bundle: the same EngineStats and leaves as the full program."""
    tb = _build("port", 2_000_000, SLOW_KHZ)
    tb = specialize.apply(tb, (tping.handler,), mode="auto")
    assert tb.caps is not None and "loss" in tb.caps.dropped()
    sim, stats = tbuild.run(tb, app_handlers=(tping.handler,), device="cpu")
    _, _, tstats, tleaves, _ = runs["slow_host"]
    assert stats.as_dict() == tstats
    got = convert.sim_to_numpy(sim)
    guard = [k for k in got if k.startswith(".guard")]
    assert all(got[k].sum() == 0 for k in guard)
    _assert_leaves_equal(tleaves, got, skip=guard)
