"""Parity of the port's config layer (shadow_tpu_torch.config) with the
reference's, on the CPU:

- parse_config and kv_arguments give equal results in both packages on
  the reference PHOLD XML, the built-in example, a config with <fault>
  elements and a decimal stop time;
- loader.load gives equal NetConfig fields, hosts and boot leaves for
  phold, pingpong, testudp, randdump (testdeterminism) and the faults
  config, equal capacity hints for every plugin, and equal runs
  (EngineStats and every leaf, tolerance zero) for phold, pingpong,
  randdump and the faults config;
- the port refuses no plugin; the ones it once refused (a `.py`
  plugin, the reftests syscall plugins, `testrandom`) load in both
  packages with equal virtual processes (host, start, stop), NetConfig
  and boot leaves; the tgen plugin, <traffic> elements, inject_lanes,
  a logpcap host and the track_paths and virtual-CPU overrides load as
  the reference loads them.

One JAX TCP program: randdump's (testdeterminism has no hints, so the
TCP machine stays on, as in the reference).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from shadow_tpu.config import loader as jloader
from shadow_tpu.config import xmlconfig as jxml
from shadow_tpu.net import build as jbuild
from shadow_tpu_torch import convert
from shadow_tpu_torch.config import examples as texamples
from shadow_tpu_torch.config import loader as tloader
from shadow_tpu_torch.config import xmlconfig as txml
from shadow_tpu_torch.net import build as tbuild
from test_config_cli import REFERENCE_PHOLD_XML

torch.set_num_threads(1)

GRAPH = texamples.EXAMPLE_GRAPHML


def _config(body: str, stoptime="3") -> str:
    return (f'<shadow stoptime="{stoptime}">\n  <topology><![CDATA['
            f'{GRAPH}]]></topology>\n{body}\n</shadow>')


FAULTS_XML = REFERENCE_PHOLD_XML.replace(
    '<kill time="3"/>',
    '<kill time="3"/>\n'
    '  <fault time="1.5" kind="loss" a="peer" b="peer2" value="0.5"/>\n'
    '  <fault time="2.0" kind="loss" a="peer" b="peer2" value="0"/>\n'
    '  <fault time="1.2" kind="crash" a="peer3"/>\n'
    '  <fault time="1.7" kind="restart" a="peer3"/>\n'
    '  <fault time="2.2" kind="latency" a="peer4" b="peer5" value="0.02"/>')

PINGPONG_XML = _config('''  <plugin id="pp" path="tgen-ping"/>
  <host id="server">
    <process plugin="pp" starttime="1" arguments="mode=server port=6000"/>
  </host>
  <host id="client" quantity="3">
    <process plugin="pp" starttime="1"
      arguments="mode=client server=server port=6000 count=5 size=100"/>
  </host>''')

TESTUDP_XML = _config('''  <plugin id="udp" path="test-udp"/>
  <host id="testserver">
    <process plugin="udp" starttime="1" arguments="server 5678"/>
  </host>
  <host id="testclient">
    <process plugin="udp" starttime="2" arguments="client 5678"/>
  </host>''')

RANDDUMP_XML = _config(
    '''  <plugin id="det" path="shadow-plugin-test-determinism"/>
  <host id="det" quantity="6">
    <process plugin="det" starttime="1"/>
  </host>''', stoptime="2.5")

PARSE = {
    "phold": REFERENCE_PHOLD_XML,
    "example": texamples.example_config(clients=7, kib=5, stoptime=9),
    "faults": FAULTS_XML,
    "decimal_stop": texamples.example_config(clients=3, stoptime=2.05),
}

LOAD = {
    "phold": REFERENCE_PHOLD_XML,
    "pingpong": PINGPONG_XML,
    "testudp": TESTUDP_XML,
    "randdump": RANDDUMP_XML,
    "faults": FAULTS_XML,
}
RUN = ("phold", "pingpong", "randdump", "faults")


def _jax_leaves(sim):
    flat, _ = jax.tree_util.tree_flatten_with_path(sim)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _assert_leaves_equal(want, got):
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, (k, want[k].dtype, got[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(PARSE))
def test_parse_config_matches_reference(name):
    want = dataclasses.asdict(jxml.parse_config(PARSE[name]))
    got = dataclasses.asdict(txml.parse_config(PARSE[name]))
    assert got == want
    if name == "decimal_stop":
        # the reference's int(float(v) * 1e9): 2.05 s is 2,049,999,999 ns
        assert got["stoptime"] == 2_049_999_999
    if name == "faults":
        assert [f["kind"] for f in got["faults"]] == [
            "crash", "loss", "restart", "loss", "latency"]


def test_kv_arguments_matches_reference():
    args = ["loglevel=info", "load=25", "a=b=c", "bare", "x="]
    assert txml.kv_arguments(args) == jxml.kv_arguments(args)
    assert txml.kv_arguments(args)["a"] == "b=c"


def _load_both(name, seed=3):
    jl = jloader.load(jxml.parse_config(LOAD[name]), seed=seed)
    tl = tloader.load(txml.parse_config(LOAD[name]), seed=seed, device="cpu")
    return jl, tl


@pytest.fixture(scope="module")
def loads():
    return {name: _load_both(name) for name in LOAD}


@pytest.mark.parametrize("name", sorted(LOAD))
def test_load_matches_reference(loads, name):
    """Equal NetConfig, hosts, window and boot state."""
    jl, tl = loads[name]
    jb, tb = jl.bundle, tl.bundle
    assert dataclasses.asdict(tb.cfg) == dataclasses.asdict(jb.cfg)
    assert tb.host_names == jb.host_names
    assert tb.name_to_index == jb.name_to_index
    assert tb.min_jump == jb.min_jump
    np.testing.assert_array_equal(tb.dns.host_ips(tb.cfg.num_hosts),
                                  jb.dns.host_ips(jb.cfg.num_hosts))
    assert [h.__name__ for h in tl.handlers] == [
        h.__name__ for h in jl.handlers]
    assert (tb.app_bulk is None) == (jb.app_bulk is None)
    assert (tb.fault_plan is None) == (jb.fault_plan is None)
    if jb.fault_plan is not None:
        for f in ("t_ns", "kind", "a", "b", "value"):
            want = np.asarray(getattr(jb.fault_plan, f))
            np.testing.assert_array_equal(getattr(tb.fault_plan, f), want)
    _assert_leaves_equal(_jax_leaves(jb.sim), convert.sim_to_numpy(tb.sim))


@pytest.fixture(scope="module")
def runs(loads):
    out = {}
    for name in RUN:
        jl, tl = loads[name]
        jsim, jstats = jbuild.run(jl.bundle, app_handlers=jl.handlers,
                                  app_bulk=jl.bundle.app_bulk)
        tsim, tstats = tbuild.run(tl.bundle, app_handlers=tl.handlers,
                                  app_bulk=tl.bundle.app_bulk, device="cpu")
        out[name] = (jstats.as_dict(), _jax_leaves(jsim), tstats.as_dict(),
                     convert.sim_to_numpy(tsim))
    return out


@pytest.mark.parametrize("name", RUN)
def test_loaded_run_matches_reference(runs, name):
    jstats, jleaves, tstats, tleaves = runs[name]
    assert tstats == jstats
    assert tstats["events_processed"] > 0
    _assert_leaves_equal(jleaves, tleaves)


def test_loaded_runs_do_their_work(runs):
    """The reference tests' checks, on the port's runs: PHOLD injected
    every message, every ping answered, every host dumped its draws,
    and the faults config dropped packets and crashed a host."""
    leaves = {name: runs[name][3] for name in RUN}
    assert leaves["phold"][".app.remaining"].sum() == 0
    assert leaves["phold"][".app.rcvd"].sum() > 0
    pp = leaves["pingpong"]
    client = pp[".app.role"] == 1
    assert client.sum() == 3 and (pp[".app.rcvd"][client] == 5).all()
    rd = leaves["randdump"]
    assert (rd[".app.start_at"] == 1_000_000_000).all()
    assert (rd[".app.samples"] > 0).all()
    assert len({tuple(r) for r in rd[".app.samples"]}) == 6
    f = leaves["faults"]
    assert f[".net.ctr_drop_reliability"].sum() > 0
    assert runs["faults"][2] != runs["phold"][2]
    for name in RUN:
        assert leaves[name][".events.overflow"] == 0


@pytest.mark.parametrize("name", sorted(tloader.plugin_names()))
def test_plugin_hints_match_reference(name):
    """Every device plugin's capacity hints, for a server and two
    clients (kv and positional argument styles)."""
    specs = [(0, txml.ProcessSpec("p", 0, None, ["mode=server"])),
             (1, txml.ProcessSpec("p", 0, None, ["mode=client", "load=7"])),
             (2, txml.ProcessSpec("p", 0, None, ["blocking", "client", "s"]))]
    jh = getattr(jloader._REGISTRY[name], "hints", None)
    th = getattr(tloader._REGISTRY[name], "hints", None)
    assert (jh is None) == (th is None)
    if jh is not None:
        assert th(specs) == jh(specs)


def test_registry_covers_the_reference():
    """Every name the reference registers is a plugin of the port and
    none is refused; testrandom is the reftests plugin (its second
    registration wins, as in the reference)."""
    ported = set(tloader.plugin_names())
    assert tloader.refused_plugins() == {}
    assert ported == set(jloader.plugin_names())
    assert "testrandom" in ported and "testdeterminism" in ported
    for name in ("testrandom", "testdeterminism"):
        assert (tloader._REGISTRY[name].__qualname__
                == jloader._REGISTRY[name].__qualname__)


# the plugins the port once refused (virtual processes): each now
# loads in both packages
REFUSED = {
    "py_plugin": '<plugin id="p" path="client.py"/>',
    "reftests": '<plugin id="p" path="libshadow-plugin-test-epoll.so"/>',
    "testrandom": '<plugin id="p" path="testrandom"/>',
}
PY_PLUGIN = """from shadow_tpu.process import vproc


def main(env):
    t = yield vproc.gettime()
    assert t >= 0
"""
# the observability settings the port once refused (a logpcap host, and
# the overrides the CLI passes for --track-paths and --cpu-threshold):
# each now loads as in the reference
SETTINGS = {"logpcap": {},
            "track_paths": {"track_paths": True},
            "cpu_threshold": {"cpu_threshold_ns": 0}}

_TRAFFIC = ('  <traffic id="t" host="h" dst="h3" start="0.5">'
            '<stream rate="10" count="5" size="80"/><pause duration="0.2"/>'
            '<markov rate="40" duration="0.5" p_on="0.5" p_off="0.4" '
            'seed="2"/></traffic>')
# the plugin, <traffic> and setting the port once refused, each loaded
# in both packages: (config text, loader overrides)
LIFTED = {
    "tgen": (_config('  <plugin id="p" path="tgen"/>\n  <host id="h" '
                     'quantity="4"><process plugin="p" starttime="1" '
                     'arguments="port=9300"/></host>\n' + _TRAFFIC), {}),
    # traffic-only: no process, so tgen is the app on every host
    "traffic": (_config('  <host id="h" quantity="4"/>\n' + _TRAFFIC), {}),
    # <traffic> beside another device app: both packages refuse it
    "traffic_with_phold": (_config(
        '  <plugin id="p" path="phold"/>\n  <host id="h" quantity="4">'
        '<process plugin="p" starttime="1"/></host>\n' + _TRAFFIC), {}),
    "inject_lanes": (REFERENCE_PHOLD_XML, {"inject_lanes": 8}),
}


@pytest.mark.parametrize("name", sorted(LIFTED))
def test_lifted_setting_loads_like_the_reference(name):
    """Equal NetConfig, boot state (staging planes included), handlers
    and compiled trace — or the same refusal."""
    text, overrides = LIFTED[name]
    try:
        jl = jloader.load(jxml.parse_config(text), seed=3,
                          overrides=dict(overrides))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tloader.load(txml.parse_config(text), seed=3,
                         overrides=dict(overrides), device="cpu")
        assert str(got.value) == str(e) and name == "traffic_with_phold"
        return
    tl = tloader.load(txml.parse_config(text), seed=3,
                      overrides=dict(overrides), device="cpu")
    jb, tb = jl.bundle, tl.bundle
    assert dataclasses.asdict(tb.cfg) == dataclasses.asdict(jb.cfg)
    assert tb.cfg.inject_lanes > 0
    assert [h.__name__ for h in tl.handlers] == [
        h.__name__ for h in jl.handlers]
    assert list(tl.inject_events) == list(jl.inject_events)
    assert bool(tl.inject_events) == name.startswith(("tgen", "traffic"))
    _assert_leaves_equal(_jax_leaves(jb.sim), convert.sim_to_numpy(tb.sim))


@pytest.mark.parametrize("name", sorted(REFUSED) + sorted(SETTINGS))
def test_refused_before_the_build(name, tmp_path):
    """A plugin or setting the port once refused loads as in the
    reference: a plugin (REFUSED) gives equal NetConfig, handlers,
    virtual processes (host, start, stop) and boot state — a `.py`
    plugin rendered for each package, the port's importing
    shadow_tpu_torch; a setting (SETTINGS) the reference's NetConfig,
    handlers and boot state."""
    plugin = REFUSED.get(name, '<plugin id="p" path="phold"/>')
    pcap = ' logpcap="true"' if name == "logpcap" else ""
    text = _config(f'{plugin}\n  <host id="h" quantity="4"{pcap}><process '
                   f'plugin="p" starttime="1" stoptime="2"/></host>')
    if name in REFUSED:
        dirs = {}
        for pkg, src in (("jax", PY_PLUGIN), ("port", PY_PLUGIN.replace(
                "shadow_tpu.", "shadow_tpu_torch."))):
            dirs[pkg] = tmp_path / pkg
            dirs[pkg].mkdir()
            (dirs[pkg] / "client.py").write_text(src)
        jl = jloader.load(jxml.parse_config(text), seed=3,
                          base_dir=str(dirs["jax"]))
        tl = tloader.load(txml.parse_config(text), seed=3,
                          base_dir=str(dirs["port"]), device="cpu")
        jb, tb = jl.bundle, tl.bundle
        assert dataclasses.asdict(tb.cfg) == dataclasses.asdict(jb.cfg)
        assert tl.handlers == () and jl.handlers == ()
        assert [(h, st, sp) for h, _, st, sp in tl.vprocs] == [
            (h, st, sp) for h, _, st, sp in jl.vprocs] == [
            (i, 10**9, 2 * 10**9) for i in range(4)]
        if name == "py_plugin":
            gen = tl.vprocs[0][1](0)
            assert type(next(gen)).__module__ == \
                "shadow_tpu_torch.process.vproc"
        _assert_leaves_equal(_jax_leaves(jb.sim),
                             convert.sim_to_numpy(tb.sim))
        return
    if name in SETTINGS:
        overrides = SETTINGS[name]
        jl = jloader.load(jxml.parse_config(text), seed=3,
                          overrides=dict(overrides))
        tl = tloader.load(txml.parse_config(text), seed=3,
                          overrides=dict(overrides), device="cpu")
        jb, tb = jl.bundle, tl.bundle
        assert dataclasses.asdict(tb.cfg) == dataclasses.asdict(jb.cfg)
        assert (tb.cfg.pcap, tb.cfg.track_paths, tb.cfg.cpu_threshold_ns
                >= 0) == (name == "logpcap", name == "track_paths",
                          name == "cpu_threshold")
        assert [h.__name__ for h in tl.handlers] == [
            h.__name__ for h in jl.handlers]
        _assert_leaves_equal(_jax_leaves(jb.sim),
                             convert.sim_to_numpy(tb.sim))
        return


def test_unknown_plugin_is_a_value_error():
    cfg = txml.parse_config(_config(
        '<plugin id="p" path="no-such-model"/>\n'
        '  <host id="h"><process plugin="p"/></host>'))
    with pytest.raises(ValueError, match="unknown plugin model"):
        tloader.load(cfg, device="cpu")


def test_rebuild_replays_the_load_with_grown_capacities(loads):
    """The escalation's rebuild closure: the same bundle at the merged
    capacities, on the same device; overrides beat plugin hints."""
    _, tl = loads["phold"]
    b2 = tl.bundle.rebuild({"event_capacity": 256})
    assert b2.cfg.event_capacity == 256
    assert b2.cfg.outbox_capacity == tl.bundle.cfg.outbox_capacity
    assert b2.device == tl.bundle.device
    assert b2.min_jump == tl.bundle.min_jump
    direct = tloader.load(txml.parse_config(LOAD["phold"]), seed=3,
                          overrides={"event_capacity": 256}, device="cpu")
    _assert_leaves_equal(convert.sim_to_numpy(direct.bundle.sim),
                         convert.sim_to_numpy(b2.sim))


def test_load_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behavior without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        tloader.load(txml.parse_config(LOAD["phold"]))
