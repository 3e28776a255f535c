"""The tgen traffic app and the <traffic> element in the port
(shadow_tpu_torch.apps.tgen) against the reference's (shadow_tpu.apps.tgen),
on the CPU:

- phase_times and compile_trace give the reference's schedule and trace
  for every phase kind (stream by count and by duration, pause, the
  seeded markov chain) and refuse the same malformed phases;
  lanes_for equals the reference's;
- examples/tgen_traffic.shadow.config.xml (16 hosts, one <traffic>
  element: a stream, a pause and a markov phase) through both CLIs,
  whole-run and supervised, and the same config with `--inject-trace`
  (a binary trace that overrides the element): the same report and
  the same manifest injection and telemetry blocks.

The CLI runs compile the reference's whole-run and per-window tgen
programs at 16 hosts and 64 lanes. Tolerance zero.
"""

import contextlib
import io
import json
import os

import pytest
import torch

from shadow_tpu import cli as jcli
from shadow_tpu.apps import tgen as jtgen
from shadow_tpu.config import xmlconfig as jxml
from shadow_tpu.inject import write_trace as jwrite_trace
from shadow_tpu_torch import cli as tcli
from shadow_tpu_torch.apps import tgen
from shadow_tpu_torch.config import xmlconfig as txml

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "examples", "tgen_traffic.shadow.config.xml")
SEC = 1_000_000_000
# report keys that are wall-clock measurements, not simulation results
WALL = ("wall_seconds", "events_per_second",
        "simulated_seconds_per_wall_second")

PHASES = {
    "stream_count": [dict(kind="stream", rate=20.0, count=7, size=100)],
    "stream_duration": [dict(kind="stream", rate=30.0,
                             duration_ns=SEC // 2, size=64)],
    "pause": [dict(kind="stream", rate=10.0, count=3),
              dict(kind="pause", duration_ns=SEC // 4),
              dict(kind="stream", rate=10.0, count=2, size=9)],
    "markov": [dict(kind="markov", rate=200.0, duration_ns=SEC, size=32,
                    p_on=0.3, p_off=0.2, seed=11)],
}


def _phases(mod, name):
    return [mod.TrafficPhase(**p) for p in PHASES[name]]


@pytest.mark.parametrize("name", sorted(PHASES))
def test_phase_times_and_trace_match_reference(name):
    want = list(jtgen.phase_times(_phases(jxml, name), SEC // 10))
    got = list(tgen.phase_times(_phases(txml, name), SEC // 10))
    assert got == want and got
    specs = {mod: [mod.TrafficSpec(id="a", host="h1", dst="h3",
                                   start_ns=SEC // 10, port=9200,
                                   phases=_phases(mod, name)),
                   mod.TrafficSpec(id="b", host="h2", start_ns=SEC // 3,
                                   phases=_phases(mod, "stream_count"))]
             for mod in (jxml, txml)}
    names = {f"h{i}": i for i in range(4)}
    for end in (None, SEC // 2):
        want = jtgen.compile_trace(specs[jxml], names, end_time=end)
        got = tgen.compile_trace(specs[txml], names, end_time=end)
        assert got == want and got
        assert all(a["t_ns"] <= b["t_ns"] for a, b in zip(got, got[1:]))


@pytest.mark.parametrize("phase", [
    dict(kind="stream", rate=5.0), dict(kind="warp", rate=5.0)],
    ids=["stream_without_count", "unknown_kind"])
def test_malformed_phases_are_refused_like_the_reference(phase):
    for mod, gen in ((jxml, jtgen), (txml, tgen)):
        with pytest.raises(ValueError):
            list(gen.phase_times([mod.TrafficPhase(**phase)]))
    with pytest.raises(ValueError, match="unknown host"):
        tgen.compile_trace([txml.TrafficSpec(id="x", host="nope")], {})


def test_lanes_for_matches_reference():
    for n in (0, 1, 15, 16, 17, 41, 64, 65, 1000, 1024, 1025, 51_200):
        assert tgen.lanes_for(n) == jtgen.lanes_for(n)


def _main(mod, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = mod.main(argv)
    return code, out.getvalue().splitlines(), err.getvalue()


@pytest.fixture(scope="module")
def trace_file(tmp_path_factory):
    """48 binary-framed tgen events, round-robin over the 16 hosts:
    lanes_for gives the config's 64 lanes, so both runs share one
    program shape."""
    p = str(tmp_path_factory.mktemp("trace") / "crowd.trace")
    evs = [{"t_ns": SEC // 5 + i * (SEC // 25), "host": i % 16,
            "kind": jtgen.KIND_TGEN,
            "payload": [(i + 5) % 16, 9100, 100 + i]} for i in range(48)]
    jwrite_trace(p, evs, binary=True)
    return p


CASES = {
    "traffic": [],
    "traffic_supervised": ["--supervise", "--checkpoint-every-windows",
                           "8"],
    "inject_trace": ["--inject-trace", None],
}


@pytest.fixture(scope="module")
def cli_runs(trace_file, tmp_path_factory):
    runs = {}

    def get(case):
        if case not in runs:
            extra = [trace_file if a is None else a for a in CASES[case]]
            out = {}
            for name, mod in (("ref", jcli), ("port", tcli)):
                d = str(tmp_path_factory.mktemp(f"{case}_{name}"))
                code, lines, err = _main(mod, [
                    CONFIG, "--platform", "cpu", "-d", d,
                    "--metrics-out", os.path.join(d, "m.prom"), *extra])
                assert code == 0, err
                with open(os.path.join(d, "run_manifest.json")) as f:
                    out[name] = (lines, json.loads(lines[-1]), json.load(f))
            runs[case] = out
        return runs[case]
    return get


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_report_and_injection_match_reference(cli_runs, case):
    runs = cli_runs(case)
    (jlines, want, jman), (tlines, got, tman) = runs["ref"], runs["port"]
    assert sorted(got) == sorted(want)
    for k in want:
        if k not in WALL:
            assert got[k] == want[k], k
    assert got["injection"] == jman["injection"] == tman["injection"]
    assert tman["telemetry"] == jman["telemetry"]
    assert tman["counters"] == jman["counters"]
    blk = got["injection"]
    assert blk["injected"] + blk["dropped"] + blk["deferred"] \
        == blk["trace_events"] > 0
    assert blk["late"] == 0 and got["overflow"] == 0
    # a loss-free graph delivers every injected datagram
    assert got["app_rcvd"] == blk["injected"]
    if case == "inject_trace":
        assert blk["trace_path"] and blk["trace_events"] == 48
        assert any("overrides the config's <traffic>" in ln
                   for ln in tlines)
    else:
        assert blk["trace_path"] is None and blk["lanes"] == 64
