"""The port's lane-isolation and recorder flags, bench knobs and
snapshots against the reference's, on the CPU:

- `--lane-isolation 2 --resident --flow-sample 4 --flow-capacity 64
  --causality-sample 4 --causality-capacity 8 --trace-out
  --metrics-out` on the reference PHOLD XML (10 hosts): the report, the
  manifest (its lanes, admission, flows and causality blocks
  included), the trace's flow and critical-path groups and the
  Prometheus text equal to the reference CLI's, and the manifest
  accepted by tools/telemetry_lint.py;
- `BENCH_REPLICAS=4 BENCH_LANE_ISOLATION=1 BENCH_FLOW_SAMPLE=8
  BENCH_CAUSALITY=8` at 4 x 16 hosts: the row's name, counts and flows
  and causality blocks equal to bench.py's; the A/B knobs' fields; the
  combinations bench.py refuses refused, BENCH_RESIDENT and
  BENCH_SHARDS by their ROADMAP.md items;
- a snapshot carrying every new leaf (lane, admission, ring fan-out,
  flow ring, lineage and advance planes) read by the other package,
  both ways.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import load_tool
from shadow_tpu import cli as jcli
from shadow_tpu.utils import checkpoint as jckpt
from shadow_tpu_torch import cli as tcli
from shadow_tpu_torch import convert
from shadow_tpu_torch.apps import phold as tphold
from shadow_tpu_torch.core import lanes as tlanes
from shadow_tpu_torch.net import build as tbuild
from shadow_tpu_torch.utils import checkpoint as tckpt
from test_config_cli import REFERENCE_PHOLD_XML
from test_torch_cli import UNPORTED_MANIFEST, WALL, _main
from torch_parity import assert_leaves_equal, jax_leaves, packed, to_jax

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIX = ["--lane-isolation", "2", "--resident", "--flow-sample", "4",
       "--flow-capacity", "64", "--causality-sample", "4",
       "--causality-capacity", "8"]


def _cli(mod, xml, d):
    code, lines, err = _main(mod, [xml, "--platform", "cpu", "-d", str(d),
                                   *SIX, "--trace-out", f"{d}/t.json",
                                   "--metrics-out", f"{d}/m.prom"])
    assert code == 0, err
    man = json.loads((d / "run_manifest.json").read_text())
    return json.loads(lines[-1]), man


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("lanes_cli")
    xml = root / "phold.shadow.config.xml"
    xml.write_text(REFERENCE_PHOLD_XML)
    out = {}
    for name, mod in (("ref", jcli), ("port", tcli)):
        d = root / name
        d.mkdir()
        out[name] = (*_cli(mod, str(xml), d), d)
    return out


def test_lane_and_recorder_flags_run_like_the_reference(cli_runs):
    want, wman, wd = cli_runs["ref"]
    got, gman, gd = cli_runs["port"]
    assert sorted(got) == sorted(want)
    for k in want:
        if k not in WALL:
            assert got[k] == want[k], k
    for block in ("lanes", "admission", "flows", "causality"):
        assert gman[block] == wman[block], block
    assert gman["lanes"]["replicas"] == 2
    assert gman["flows"]["sampled"] > 0 and gman["causality"]["sampled"] > 0
    for m in (wman, gman):
        for k in UNPORTED_MANIFEST:
            m.pop(k, None)
    assert gman == wman
    errors, _ = load_tool("telemetry_lint").lint_manifest_obj(gman)
    assert errors == []


def test_trace_groups_and_metrics_match_reference(cli_runs):
    wd, gd = cli_runs["ref"][2], cli_runs["port"][2]
    groups = [[e for e in json.loads((d / "t.json").read_text())[
        "traceEvents"] if e["pid"] in (0, 2, 3)] for d in (wd, gd)]
    assert groups[1] == groups[0]
    assert {e["pid"] for e in groups[1]} == {0, 2, 3}
    prom = [[ln for ln in (d / "m.prom").read_text().splitlines()
             if "wall_phase" not in ln and "compile" not in ln]
            for d in (wd, gd)]
    assert prom[1] == prom[0]
    assert any(ln.startswith("shadow_tpu_lane_events_exec{")
               for ln in prom[1])


def test_resident_without_lanes_is_ignored_with_a_warning(tmp_path):
    xml = tmp_path / "phold.shadow.config.xml"
    xml.write_text(REFERENCE_PHOLD_XML)
    code, lines, err = _main(tcli, [str(xml), "--platform", "cpu", "-d",
                                    str(tmp_path), "--resident"])
    assert code == 0, err
    assert any("--resident requires --lane-isolation" in ln
               for ln in lines)
    code, _, err = _main(tcli, [str(xml), "--platform", "cpu", "-d",
                                str(tmp_path), "--lane-isolation", "3"])
    assert code == 1 and "--lane-isolation" in err


# ----------------------------------------------------------- the bench

BENCH_ENV = {"BENCH_PLATFORM": "cpu", "BENCH_HOSTS": "16",
             "BENCH_SIM_SECONDS": "2", "BENCH_REPLICAS": "4",
             "BENCH_LANE_ISOLATION": "1", "BENCH_FLOW_SAMPLE": "8",
             "BENCH_CAUSALITY": "8"}


def _bench(cmd, **env):
    full = {k: v for k, v in os.environ.items()
            if not k.startswith("BENCH_")}
    full.update(env)
    full.setdefault("OMP_NUM_THREADS", "1")
    return subprocess.run([sys.executable, *cmd], cwd=ROOT, env=full,
                          capture_output=True, text=True, timeout=600)


def test_bench_row_matches_bench_py():
    r = _bench(["bench.py"], **BENCH_ENV, JAX_PLATFORMS="cpu")
    assert r.returncode == 0, r.stderr
    want = json.loads(r.stdout.strip().splitlines()[-1])
    r = _bench(["-m", "shadow_tpu_torch.bench"], **BENCH_ENV,
               BENCH_FLOW_OVERHEAD="1")
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["metric"] == want["metric"] == (
        "events_per_sec_per_chip@16hosts_phold_load8_x4replicas_lanes"
        "_flow8_caus8")
    ctr = want["manifest"]["counters"]
    assert (got["events"], got["windows"], got["micro_steps"]) \
        == (ctr["events_processed"], ctr["windows"], ctr["micro_steps"])
    assert got["flows"] == want["flows"]
    assert got["causality"] == want["causality"]
    assert got["lanes"]["quarantined"] == []
    assert sum(d["events_exec"] for d in got["lanes"]["per_lane"]) \
        == got["events"]
    assert got["flow_overhead_pct"] is not None
    assert got["events_per_sec_flow_off"] > 0


@pytest.mark.parametrize("env,word", [
    ({"BENCH_REPLICAS": "2", "BENCH_SUPERVISE": "1"}, "BENCH_REPLICAS"),
    ({"BENCH_REPLICAS": "2", "BENCH_INJECT_RATE": "100"}, "BENCH_REPLICAS"),
    ({"BENCH_REPLICAS": "2", "BENCH_WORKLOAD": "pingpong"},
     "BENCH_REPLICAS"),
    ({"BENCH_FLOW_SAMPLE": "4", "BENCH_WORKLOAD": "pingpong"},
     "BENCH_FLOW_SAMPLE"),
    ({"BENCH_CAUSALITY": "4", "BENCH_WORKLOAD": "pingpong"},
     "BENCH_CAUSALITY"),
    ({"BENCH_FLOW_OVERHEAD": "1"}, "BENCH_FLOW_SAMPLE"),
    ({"BENCH_CAUSALITY_OVERHEAD": "1"}, "BENCH_CAUSALITY=N"),
    ({"BENCH_RESIDENT": "4"}, "item 12"),
    ({"BENCH_SHARDS": "4"}, "item 9"),
], ids=["supervise", "inject", "pingpong", "flows_pingpong",
        "causality_pingpong", "flow_ab", "causality_ab", "resident",
        "shards"])
def test_bench_refuses_what_bench_py_refuses(env, word):
    r = _bench(["-m", "shadow_tpu_torch.bench"], BENCH_PLATFORM="cpu",
               BENCH_HOSTS="16", **env)
    assert r.returncode != 0
    assert word in r.stderr and r.stdout == ""


# ----------------------------------------------------------- snapshots

REC = dict(flows=(3, 64), causality=(2, 8), end=250_000_000)


@pytest.fixture(scope="module")
def resident_sim():
    b = packed("port", **REC)
    b.sim = tlanes.admit_all(tlanes.attach_admission(b.sim))
    sim, _ = tbuild.make_runner(b, app_handlers=(tphold.handler,),
                                device="cpu")(b.sim)
    jb = packed("jax", **REC)
    from shadow_tpu.core import lanes as jlanes

    jb.sim = jlanes.admit_all(jlanes.attach_admission(jb.sim))
    return sim, b.sim, jb.sim


def test_snapshot_with_every_new_leaf_crosses_both_ways(resident_sim,
                                                        tmp_path):
    sim, ttmpl, jtmpl = resident_sim
    leaves = convert.sim_to_numpy(sim)
    for prefix in (".lanes.", ".admission.", ".flows.", ".causality.key",
                   ".causality.adv_", ".telem.lane_events",
                   ".events.overflow_h"):
        assert any(k.startswith(prefix) for k in leaves), prefix
    assert leaves[".causality.key"].dtype == np.uint64
    assert int(sim.causality.count.sum()) > 0
    # port -> reference
    p = tckpt.save(str(tmp_path / "port"), sim, time_ns=123)
    jsim, t, _ = jckpt.load(p, jtmpl)
    assert t == 123
    assert_leaves_equal(leaves, jax_leaves(jsim))
    # reference -> port
    p = jckpt.save(str(tmp_path / "ref"), to_jax(sim, jtmpl), time_ns=456)
    back, t, _ = tckpt.load(p, ttmpl)
    assert t == 456
    assert_leaves_equal(leaves, convert.sim_to_numpy(back))
    assert back.flows.sample_period == 3
    assert back.causality.sample_period == 2
