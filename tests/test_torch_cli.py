"""The port's command-line entry point (shadow_tpu_torch.cli) against the
reference's (shadow_tpu.cli), on the CPU:

- make_parser accepts every option string of the reference's parser,
  with equal defaults;
- `main([config, "--platform", "cpu"])` on the reference PHOLD XML
  (tests/test_config_cli.py) prints a report equal to
  shadow_tpu.cli.main's in events, windows, app_rcvd and overflow, and
  the same tracker heartbeat, object-count and executed-event lines;
- `--supervise` (with snapshots), `--chunk-windows` and `--resume`
  give the plain run's report;
- every refused flag exits 2 and names its ROADMAP.md item;
  `--host-kernel run` (at the default and at `--host-time-scale 1.0`)
  runs a `.py`-plugin config as the reference's CLI does, and the
  port's `--host-kernel diff` agrees (the manifest's conformance
  block; tests/test_torch_hostrun.py holds its simulated run to the
  reference's);
  `--track-paths`, `--cpu-threshold` and a logpcap config give the
  reference's report, log and pcap files; the
  injection and telemetry flags (`--inject-trace`, `--inject-lanes`,
  `--trace-out`, `--metrics-out`, `--telemetry-capacity`) give the
  reference's report, manifest and files;
- `--platform auto` and `gpu` without CUDA fail, and never run on the
  CPU;
- the logger's time-sorted flush and the tracker's section filter
  behave as the reference's, and config_hash equals the reference's.
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from shadow_tpu import cli as jcli
from shadow_tpu.config import loader as jloader
from shadow_tpu.config import xmlconfig as jxml
from shadow_tpu.telemetry.export import config_hash as jconfig_hash
from shadow_tpu.utils import shadowlog as jlog
from shadow_tpu_torch import cli as tcli
from shadow_tpu_torch.config import loader as tloader
from shadow_tpu_torch.config import xmlconfig as txml
from shadow_tpu_torch.utils import shadowlog as tlog
from test_config_cli import REFERENCE_PHOLD_XML

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPORT_KEYS = ("events", "windows", "sim_seconds", "app_rcvd", "overflow")


def _ref_actions():
    return [a for a in jcli.make_parser()._actions
            if a.dest not in ("help", "version")]


@pytest.mark.parametrize("dest", [a.dest for a in _ref_actions()])
def test_parser_takes_the_reference_option_with_its_default(dest):
    want = next(a for a in _ref_actions() if a.dest == dest)
    got = {a.dest: a for a in tcli.make_parser()._actions}[dest]
    assert set(want.option_strings) <= set(got.option_strings)
    assert got.default == want.default
    assert got.nargs == want.nargs
    assert got.type == want.type
    if want.choices is not None and dest != "platform":
        assert list(got.choices) == list(want.choices)


def test_reference_compat_flags_parse():
    """tests/test_config_cli.py's invocations parse with the port."""
    p = tcli.make_parser()
    a = p.parse_args([
        "conf.xml", "-w", "4", "--seed", "7", "--scheduler-policy", "steal",
        "--runahead", "10", "--interface-qdisc", "rr",
        "--socket-recv-buffer", "100000", "--preload", "/usr/lib/libfoo.so",
        "--gdb", "--valgrind", "--data-template", "shadow.data.template",
        "--interface-batch", "5000", "--interface-buffer", "1024000",
        "--tcp-ssthresh", "64", "--tcp-windows", "10",
        "--cpu-threshold", "1000", "--cpu-precision", "200", "-i", "node,ram",
    ])
    assert a.workers == 4 and a.seed == 7 and a.runahead == 10
    assert a.tcp_ssthresh == 64 and a.cpu_threshold == 1000
    assert tcli.overrides_from_args(a) == jcli.overrides_from_args(
        jcli.make_parser().parse_args([
            "conf.xml", "--runahead", "10", "--interface-qdisc", "rr",
            "--socket-recv-buffer", "100000", "--tcp-ssthresh", "64",
            "--tcp-windows", "10", "--cpu-threshold", "1000"]))


def _main(mod, argv):
    """(exit code, stdout lines, stderr) of mod.main(argv)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = mod.main(argv)
    return code, out.getvalue().splitlines(), err.getvalue()


@pytest.fixture(scope="module")
def xml(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "phold.shadow.config.xml"
    path.write_text(REFERENCE_PHOLD_XML)
    return str(path)


@pytest.fixture(scope="module")
def cli_runs(xml, tmp_path_factory):
    """The reference's and the port's CLI on the PHOLD XML, -l info."""
    out = {}
    for name, mod, extra in (("ref", jcli, []), ("port", tcli, []),
                             ("supervise", tcli, [
                                 "--supervise",
                                 "--checkpoint-every-windows", "8"]),
                             ("chunked", tcli, ["--chunk-windows", "4"])):
        d = str(tmp_path_factory.mktemp(name))
        code, lines, err = _main(mod, [xml, "--platform", "cpu", "-d", d,
                                       "-l", "info", *extra])
        assert code == 0, err
        out[name] = (lines, json.loads(lines[-1]), d)
    return out


def _body(lines):
    """Log lines without the wall-clock, build and progress lines (the
    report is compared separately)."""
    return [ln for ln in lines[:-1]
            if not any(s in ln for s in ("wall_seconds", "] built ",
                                         "progress"))]


def test_cli_report_matches_reference(cli_runs):
    want, got = cli_runs["ref"][1], cli_runs["port"][1]
    assert sorted(got) == sorted(want)
    for k in REPORT_KEYS:
        assert got[k] == want[k], k
    assert got["events"] > 0 and got["app_rcvd"] > 0


def test_tracker_objcount_and_executed_lines_match_reference(cli_runs):
    want, got = _body(cli_runs["ref"][0]), _body(cli_runs["port"][0])
    assert got == want
    for tag in ("[shadow-heartbeat] [node-header]",
                "[shadow-heartbeat] [node]", "[socket]",
                "ObjectCounter: counter values",
                "ObjectCounter: leak diff", "executed"):
        assert any(tag in ln for ln in got), tag


@pytest.mark.parametrize("name", ["supervise", "chunked"])
def test_dispatch_flags_give_the_plain_report(cli_runs, name):
    want, got = cli_runs["port"][1], cli_runs[name][1]
    for k in REPORT_KEYS:
        assert got[k] == want[k], k
    assert _body(cli_runs[name][0]) == _body(cli_runs["port"][0])
    snaps = [f for f in os.listdir(cli_runs[name][2])
             if f.startswith("checkpoint")]
    assert bool(snaps) == (name == "supervise")


def test_resume_continues_to_the_plain_report(cli_runs, xml):
    """--resume <data directory> picks the newest snapshot and runs the
    rest of the chain: the same totals as the uninterrupted run."""
    d = cli_runs["supervise"][2]
    code, lines, err = _main(tcli, [xml, "--platform", "cpu", "-d", d,
                                    "--resume", d])
    assert code == 0, err
    got, want = json.loads(lines[-1]), cli_runs["port"][1]
    for k in REPORT_KEYS:
        assert got[k] == want[k], k
    assert "resume_of" in got


REFUSED = {
    "workers": (["-w", "2"], "item 9"),
    "profile_dir": (["--profile-dir", "prof"], "jax.profiler"),
}
# the host-kernel flags the port once refused: run on
# tests/test_py_plugins.py's .py-plugin echo config, rendered for each
# package, against the reference's CLI
LIFTED_HK = {
    "host_kernel": ["--host-kernel", "run"],
    "host_time_scale": ["--host-time-scale", "1.0", "--host-kernel", "run"],
}
# flags the port once refused: run against the reference's CLI on the
# PHOLD XML with every host logpcap="true", cut to 1.2 sim-s (5
# windows), at -l info; a 30-us event cost, so any backlog blocks
OBSERVED = ["--track-paths", "--cpu-threshold", "0", "--cpu-precision", "10"]
LIFTED_OBS = {"track_paths": "path 0->0: ", "cpu_threshold": None}


@pytest.fixture(scope="module")
def observed_cli(tmp_path_factory):
    """(lines, report, pcap files) of the reference's and the port's CLI
    with OBSERVED on the logpcap XML, and of the port's with no flag."""
    d = tmp_path_factory.mktemp("observed")
    path = d / "pcap.xml"
    path.write_text(REFERENCE_PHOLD_XML.replace(
        '<kill time="3"/>', '<kill time="1.2"/>').replace(
        '<node id="peer" quantity="10">',
        '<node id="peer" quantity="10" logpcap="true">'))
    out = {}
    for name, mod, flags in (("ref", jcli, OBSERVED), ("port", tcli, OBSERVED),
                             ("plain", tcli, [])):
        dd = d / name
        code, lines, err = _main(mod, [str(path), "--platform", "cpu", "-d",
                                       str(dd), "-l", "info", *flags])
        assert code == 0, err
        files = {p.name: p.read_bytes() for p in sorted(dd.glob("*.pcap"))}
        out[name] = (lines, json.loads(lines[-1]), files)
    return out


def _host_kernel_run(tmp_path, name):
    """{"ref", "port"[, "diff"]: (exit code, the JSON line, manifest or
    None, stderr)} of the reference's and the port's CLI with
    LIFTED_HK[name], and for host_time_scale the port's with
    `--host-kernel diff` at that scale."""
    from shadow_tpu.hostrun.kernel import PortAllocator, PortsUnavailable
    from test_py_plugins import CONFIG, GRAPH, PLUGIN

    try:
        PortAllocator.preflight()
    except PortsUnavailable as e:
        pytest.skip(f"no bindable localhost ports: {e}")
    runs = [("ref", jcli, LIFTED_HK[name]), ("port", tcli, LIFTED_HK[name])]
    if name == "host_time_scale":
        runs.append(("diff", tcli, LIFTED_HK[name][:-1] + ["diff"]))
    out = {}
    for key, mod, flags in runs:
        d = tmp_path / key
        d.mkdir()
        plugin = PLUGIN if key == "ref" else PLUGIN.replace(
            "shadow_tpu.", "shadow_tpu_torch.")
        (d / "echo_plugin.py").write_text(plugin)
        (d / "one.graphml.xml").write_text(GRAPH)
        (d / "shadow.config.xml").write_text(CONFIG)
        code, lines, err = _main(mod, [str(d / "shadow.config.xml"),
                                       "--platform", "cpu", "-l", "warning",
                                       "-d", str(d / "data"), *flags])
        man = d / "data" / "run_manifest.json"
        out[key] = (code, json.loads(lines[-1]) if lines else None,
                    json.loads(man.read_text()) if man.exists() else None,
                    err)
    return out


@pytest.mark.parametrize("name", sorted(REFUSED) + sorted(LIFTED_OBS)
                         + sorted(LIFTED_HK))
def test_refused_flag_exits_and_names_its_item(xml, observed_cli, name,
                                               tmp_path):
    """A flag still refused exits 2 naming its ROADMAP item. The flags
    the port took over (LIFTED_OBS) give the reference CLI's report
    and log: the per-path lines, and the events the gate defers. The
    host-kernel flags (LIFTED_HK) run the .py-plugin config as the
    reference's CLI does: `run` exits 0 with the processes' count; at a
    time scale of 1.0 the port's `diff` also agrees and writes the
    conformance block."""
    if name in LIFTED_HK:
        runs = _host_kernel_run(tmp_path, name)
        (rc, rrep, _, rerr), (pc, prep, _, perr) = (runs["ref"],
                                                    runs["port"])
        assert rc == 0, rerr
        assert pc == 0, perr
        assert prep["mode"] == rrep["mode"] == "host-kernel-run"
        assert prep["processes"] == rrep["processes"] == 2
        if name == "host_time_scale":
            dc, drep, dman, derr = runs["diff"]
            assert dc == 0, derr
            assert drep["mode"] == "host-kernel-diff" and drep["agree"]
            assert dman["conformance"] == {
                "workloads": {"shadow.config.xml": "agree"}, "agree": 1,
                "diverge": 0, "total": 1}
        return
    if name in LIFTED_OBS:
        want, got = observed_cli["ref"], observed_cli["port"]
        assert tcli.refused_flags(tcli.make_parser().parse_args(
            [xml, *OBSERVED])) == []
        for k in REPORT_KEYS:
            assert got[1][k] == want[1][k], k
        assert _body(got[0]) == _body(want[0])
        if name == "track_paths":
            paths = [ln for ln in got[0] if LIFTED_OBS[name] in ln]
            assert len(paths) == 1
            assert paths[0].endswith(f" {got[1]['events']} packets")
        else:
            # blocked events wait: fewer executed by the cut than
            # without the gate
            assert got[1]["events"] < observed_cli["plain"][1]["events"]
        return
    flags, item = REFUSED[name]
    code, lines, err = _main(tcli, [xml, "--platform", "cpu", *flags])
    assert code == 2
    assert item in err and flags[0] in err
    assert lines == []


# flags the port once refused, run against the reference's CLI on the
# PHOLD XML: "{trace}" is an 8-event tgen trace, "{d}" the run's data
# directory
LIFTED = {
    "inject_trace": ["--inject-trace", "{trace}"],
    "inject_lanes": ["--inject-lanes", "16"],
    "trace_out": ["--trace-out", "{d}/t.json"],
    "metrics_out": ["--metrics-out", "{d}/m.prom"],
    "telemetry_capacity": ["--telemetry-capacity", "64"],
}
# report fields measured on the wall clock; manifest blocks of the
# compile store (ROADMAP.md Queue 1 item 11b) and the wall-clock ones
WALL = ("wall_seconds", "events_per_second",
        "simulated_seconds_per_wall_second")
UNPORTED_MANIFEST = ("compile", "wall_seconds", "wall_phases_s")


def _lifted_run(mod, xml, tmp_path, name, trace):
    d = tmp_path / f"{name}_{mod.__name__.split('.')[0]}"
    d.mkdir()
    flags = [f.format(d=d, trace=trace) for f in LIFTED[name]]
    code, lines, err = _main(mod, [xml, "--platform", "cpu", "-d", str(d),
                                   *flags])
    assert code == 0, err
    man = None
    if (d / "run_manifest.json").exists():
        man = json.loads((d / "run_manifest.json").read_text())
        man = {k: v for k, v in man.items() if k not in UNPORTED_MANIFEST}
    return json.loads(lines[-1]), man, d


@pytest.mark.parametrize("name", sorted(LIFTED))
def test_lifted_flag_runs_like_the_reference(xml, tmp_path, name):
    """Each flag the port took over from the refusals gives the
    reference's report, manifest and files."""
    from shadow_tpu.inject import write_trace

    trace = str(tmp_path / "eight.trace")
    write_trace(trace, [{"t_ns": (2 + i) * 100_000_000, "host": i,
                         "kind": 24, "payload": [i + 1, 9100, 64]}
                        for i in range(8)])
    want, wman, wd = _lifted_run(jcli, xml, tmp_path, name, trace)
    got, gman, gd = _lifted_run(tcli, xml, tmp_path, name, trace)
    assert sorted(got) == sorted(want)
    for k in want:
        if k not in WALL:
            assert got[k] == want[k], k
    assert gman == wman
    assert (gman is None) == (name.startswith("inject"))
    if name == "inject_trace":
        assert got["injection"]["injected"] == 8
    if name == "trace_out":
        sim_track = [[e for e in json.loads((d / "t.json").read_text())[
            "traceEvents"] if e["pid"] == 0] for d in (wd, gd)]
        assert sim_track[1] == sim_track[0] and len(sim_track[1]) > 2
    if name == "metrics_out":
        prom = [[ln for ln in (d / "m.prom").read_text().splitlines()
                 if "wall_phase" not in ln and "compile" not in ln]
                for d in (wd, gd)]
        assert prom[1] == prom[0]


# flags the port once refused that attach lanes, the admission planes
# and the recorders: their runs are held to the reference in
# tests/test_torch_lanes_cli.py; here each parses to the reference's
# value, is refused no more, and a value the reference rejects before
# the run (10 hosts do not split into 3 lanes; a negative capacity)
# exits as the reference's CLI does
LANE_FLAGS = {
    "flow_sample": ["--flow-sample", "4", "--flow-capacity", "-1"],
    "flow_capacity": ["--flow-sample", "1", "--flow-capacity", "-8"],
    "causality_sample": ["--causality-sample", "4",
                         "--causality-capacity", "-1"],
    "causality_capacity": ["--causality-sample", "1",
                           "--causality-capacity", "-8"],
    "lane_isolation": ["--lane-isolation", "3"],
    "resident": ["--lane-isolation", "3", "--resident"],
}


@pytest.mark.parametrize("name", sorted(LANE_FLAGS))
def test_lifted_lane_flag_parses_and_errors_like_the_reference(
        xml, tmp_path, name):
    flags = LANE_FLAGS[name]
    want = vars(jcli.make_parser().parse_args([xml, *flags]))
    got = vars(tcli.make_parser().parse_args([xml, *flags]))
    assert got[name] == want[name] and got[name] not in (None, False)
    assert tcli.refused_flags(tcli.make_parser().parse_args(
        [xml, *flags])) == []
    runs = []
    for mod in (jcli, tcli):
        d = tmp_path / mod.__name__.split(".")[0]
        code, lines, err = _main(mod, [xml, "--platform", "cpu", "-d",
                                       str(d), *flags])
        runs.append((code, [ln for ln in err.splitlines()
                            if ln.startswith("error:")]))
    assert runs[1] == runs[0]
    assert runs[1][0] == 1 and len(runs[1][1]) == 1


@pytest.mark.parametrize("sub", ["fleet", "sweep"])
def test_refused_subcommand(sub):
    code, lines, err = _main(tcli, [sub, "run"])
    assert code == 2 and "item 12" in err


def test_logpcap_config_is_refused(observed_cli):
    """Once refused, now run: a logpcap config writes the reference
    CLI's pcap files, byte for byte, one per host, and warns of the
    reference's ring overrun (load 25 fills a 64-slot ring within one
    50-ms window)."""
    want, got = observed_cli["ref"][2], observed_cli["port"][2]
    assert len(got) == 10 and got == want
    warn = [[ln for ln in observed_cli[k][0] if "pcap ring overran" in ln]
            for k in ("ref", "port")]
    assert warn[1] == warn[0] and len(warn[1]) == 1
    # the files follow the run: the gate moves the captured times
    assert observed_cli["plain"][2] != got


def test_supervised_logpcap_drains_every_window(observed_cli, tmp_path):
    """--supervise takes the supervised loop before the pcap loop, as in
    the reference, and drains the ring after every window through the
    supervisor's on_window: the files and the report are the reference
    CLI's plain run's."""
    d = tmp_path / "sup"
    xml = tmp_path / "pcap.xml"
    xml.write_text(REFERENCE_PHOLD_XML.replace(
        '<kill time="3"/>', '<kill time="1.2"/>').replace(
        '<node id="peer" quantity="10">',
        '<node id="peer" quantity="10" logpcap="true">'))
    code, lines, err = _main(tcli, [str(xml), "--platform", "cpu", "-d",
                                    str(d), "-l", "info", "--supervise",
                                    *OBSERVED])
    assert code == 0, err
    want = observed_cli["ref"]
    got = json.loads(lines[-1])
    for k in REPORT_KEYS:
        assert got[k] == want[1][k], k
    assert {p.name: p.read_bytes() for p in sorted(d.glob("*.pcap"))} \
        == want[2]


@pytest.mark.parametrize("platform", [None, "auto", "gpu"])
def test_card_platforms_never_run_on_the_cpu(xml, platform):
    if torch.cuda.is_available():
        pytest.skip("checks the behavior without a CUDA device")
    argv = [xml] + ([] if platform is None else ["--platform", platform])
    code, lines, err = _main(tcli, argv)
    assert code != 0
    assert "CUDA is not available" in err
    assert lines == []


def test_test_flag_without_cuda_exits_with_the_device_error():
    """`python -m shadow_tpu_torch.cli --test` as a user types it."""
    if torch.cuda.is_available():
        pytest.skip("checks the behavior without a CUDA device")
    r = subprocess.run([sys.executable, "-m", "shadow_tpu_torch.cli",
                        "--test"], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr
    assert r.stdout == ""


def test_test_flag_on_the_cpu_runs_the_example(monkeypatch, tmp_path):
    """--test --platform cpu builds the built-in example on the CPU
    (cut to 2.2 sim-s: the full 60 s serializes on the server)."""
    from shadow_tpu_torch.config import examples

    full = examples.example_config
    monkeypatch.setattr(examples, "example_config",
                        lambda clients: full(clients=clients, stoptime=2.2))
    code, lines, err = _main(tcli, ["--test", "--test-clients", "3",
                                    "--platform", "cpu", "-d",
                                    str(tmp_path)])
    assert code == 0, err
    rep = json.loads(lines[-1])
    assert rep["sim_seconds"] == 2.2 and rep["overflow"] == 0
    assert rep["events"] > 0 and "app_rcvd" in rep
    assert any("built 4 hosts" in ln for ln in lines)


def test_version():
    with pytest.raises(SystemExit) as e, contextlib.redirect_stdout(
            io.StringIO()) as out:
        tcli.main(["--version"])
    assert e.value.code == 0
    assert out.getvalue().startswith("shadow-tpu-torch ")


def test_logger_sorts_by_simtime():
    out = io.StringIO()
    lg = tlog.SimLogger(level=tlog.LogLevel.INFO, stream=out)
    lg.info(2_000_000_000, "b", "later")
    lg.info(1_000_000_000, "a", "earlier")
    lg.message(1_000_000_000, "a", "earlier-second")  # same time: emit order
    lg.flush()
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("00:00:01.000000000 [info] [a] earlier")
    assert lines[1].endswith("earlier-second")
    assert lines[2].startswith("00:00:02.000000000")


def test_flush_order_matches_reference_over_4096_records():
    """Both packages hand batches of 4,096 records and more to their
    native stable argsort. Same order."""
    rng = np.random.default_rng(5)
    times = rng.integers(0, 300, 6000) * 1_000_000
    texts = []
    for mod in (jlog, tlog):
        out = io.StringIO()
        lg = mod.SimLogger(level=mod.LogLevel.DEBUG, stream=out)
        for i, t in enumerate(times):
            lg.log(int(i % 4) + 2, int(t), f"h{i % 7}", f"record {i}")
        lg.flush()
        texts.append(out.getvalue())
    assert texts[0] == texts[1]
    assert texts[1].count("\n") == 6000


def test_tracker_sections_filter():
    from shadow_tpu_torch.utils.tracker import Tracker

    out = io.StringIO()
    lg = tlog.SimLogger(level=tlog.LogLevel.INFO, stream=out)
    with pytest.raises(ValueError, match="unknown heartbeat"):
        Tracker(lg, ["h"], sections=("node", "bogus"))
    b = tloader.load(txml.parse_config(REFERENCE_PHOLD_XML),
                     device="cpu").bundle
    Tracker(lg, b.host_names, sections=("ram",)).heartbeat(b.sim, 10**9)
    lg.flush()
    text = out.getvalue()
    assert "[ram-header]" in text
    assert "[node" not in text and "[socket" not in text


def test_config_hash_matches_reference():
    jb = jloader.load(jxml.parse_config(REFERENCE_PHOLD_XML)).bundle
    tb = tloader.load(txml.parse_config(REFERENCE_PHOLD_XML),
                      device="cpu").bundle
    assert dataclasses.asdict(tb.cfg) == dataclasses.asdict(jb.cfg)
    assert tcli.config_hash(tb.cfg) == jconfig_hash(jb.cfg)
    from shadow_tpu_torch.telemetry.export import config_hash

    assert tcli.config_hash is config_hash    # one copy, in export.py
