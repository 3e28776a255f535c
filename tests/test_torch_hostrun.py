"""Parity of the port's dual-mode executor (shadow_tpu_torch/hostrun/)
and `.py` plugins with the reference's:

- tests/test_dualmode.py's units (the differential checker, the trace
  normalizer, the port allocator and map, the host timer, the catalog
  and the conformance block) pass on the port's hostrun, rendered for
  it, and on the reference's (tests/torch_vproc_parity.py);
- every FAST_DUAL_WORKLOADS entry agrees on the port's simulation
  against the real OS, and the port's simulated run equals the
  reference's run_sim of it, tolerance zero: the final Sim leaf by leaf,
  EngineStats, syscall and dispatch counts, pool and syscall trace;
- tests/test_py_plugins.py's echo config, its plugin rendered for each
  package, runs through both CLIs with equal reports and equal runs,
  and a plugin without main(env) is refused with the reference's text.

Needs bindable localhost ports (skips without them, as
tests/test_dualmode.py does).
"""

import contextlib
import io
import json

import pytest

from shadow_tpu import cli as jcli
from shadow_tpu import hostrun as jhostrun
from shadow_tpu.hostrun.kernel import PortAllocator, PortsUnavailable
from shadow_tpu_torch import cli as tcli
from shadow_tpu_torch import hostrun as thostrun
from torch_vproc_parity import (
    assert_runs_equal,
    load_module,
    render,
    run_case,
    run_module_cases,
)


@pytest.fixture(scope="module", autouse=True)
def ports():
    try:
        PortAllocator.preflight()
    except PortsUnavailable as e:
        pytest.skip(f"no bindable localhost ports: {e}")


UNITS = ("test_catalog_shape", "test_conformance_block",
         "test_diff_detects_record_mismatch",
         "test_diff_detects_structure_mismatch",
         "test_diff_agrees_on_identical",
         "test_trace_coalesces_partial_transfers",
         "test_trace_folds_repeated_ready_sets",
         "test_trace_fd_tokens_survive_slot_reuse",
         "test_trace_payloads_digested_not_dropped",
         "test_port_allocator_deterministic_and_distinct",
         "test_portmap_sticky_and_reverse",
         "test_host_timer_fires_and_disarms")


@pytest.fixture(scope="module")
def units():
    return run_module_cases("test_dualmode", UNITS)


@pytest.mark.parametrize("case", UNITS)
def test_dualmode_unit_holds_on_port(units, case):
    ref, port = units[case]
    assert ref.error is None, ref.error
    assert port.error is None, port.error


def test_trace_dump_load_roundtrip_on_port(tmp_path):
    load_module("test_dualmode", True).test_trace_dump_load_roundtrip(
        tmp_path)


def test_catalog_matches_reference():
    assert thostrun.DUAL_WORKLOADS == jhostrun.DUAL_WORKLOADS
    assert thostrun.FAST_DUAL_WORKLOADS == jhostrun.FAST_DUAL_WORKLOADS
    assert thostrun.SIM_ONLY_WORKLOADS == jhostrun.SIM_ONLY_WORKLOADS


@pytest.fixture(scope="module")
def duals():
    out = {}
    for name in thostrun.FAST_DUAL_WORKLOADS:
        res = {}
        ref = run_case(False, lambda _p, n=name: jhostrun.run_sim(n))
        port = run_case(True, lambda _p, n=name: res.setdefault(
            "dual", thostrun.run_dual(n)))
        out[name] = (ref, port, res.get("dual"))
    return out


@pytest.mark.parametrize("name", thostrun.FAST_DUAL_WORKLOADS)
def test_dual_mode_agreement_on_port(duals, name):
    """tests/test_dualmode.py's claim on the port's simulation."""
    _, port, res = duals[name]
    assert port.error is None, port.error
    assert res.diff.agree, "\n" + thostrun.render(res.diff)
    assert res.sim and any(res.sim.values())


@pytest.mark.parametrize("name", thostrun.FAST_DUAL_WORKLOADS)
def test_simulated_run_matches_reference(duals, name):
    ref, port, _ = duals[name]
    for what in ("state", "stats", "trace"):
        assert_runs_equal(ref, port, what)


@pytest.fixture(scope="module")
def plugin_cli(tmp_path_factory):
    """(reference CaseRun, port CaseRun, {port: report}) of the .py
    plugin echo config through each package's CLI."""
    from test_py_plugins import CONFIG, GRAPH, PLUGIN

    reports = {}

    def go(port):
        d = tmp_path_factory.mktemp("port" if port else "ref")
        (d / "echo_plugin.py").write_text(render(PLUGIN, port))
        (d / "one.graphml.xml").write_text(GRAPH)
        (d / "shadow.config.xml").write_text(CONFIG)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = (tcli if port else jcli).main(
                [str(d / "shadow.config.xml"), "-l", "warning",
                 "--platform", "cpu", "-d", str(d / "data")])
        assert rc == 0
        reports[port] = json.loads(out.getvalue().splitlines()[-1])

    return run_case(False, go), run_case(True, go), reports


def test_py_plugin_through_both_clis(plugin_cli):
    ref, port, reports = plugin_cli
    assert ref.error is None, ref.error
    assert port.error is None, port.error
    for k in ("events", "windows", "sim_seconds", "overflow"):
        assert reports[True][k] == reports[False][k], k
    assert reports[True]["overflow"] == 0 and reports[True]["events"] > 0


@pytest.mark.parametrize("what", ["state", "stats", "trace"])
def test_py_plugin_run_matches_reference(plugin_cli, what):
    ref, port, _ = plugin_cli
    assert_runs_equal(ref, port, what)


def test_py_plugin_requires_main(tmp_path):
    from shadow_tpu_torch.config.loader import load
    from shadow_tpu_torch.config.xmlconfig import parse_config
    from test_py_plugins import CONFIG

    (tmp_path / "bad.py").write_text("x = 1\n")
    cfg = parse_config(CONFIG.replace("echo_plugin.py", "bad.py"))
    with pytest.raises(ValueError, match="main"):
        load(cfg, base_dir=str(tmp_path), device="cpu")
