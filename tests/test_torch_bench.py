"""The port's bench entry point, `python -m shadow_tpu_torch.bench`, on
the CPU: one JSON row per workload and topology at 16 hosts with the
documented keys, bench.py's metric names and vs_baseline rule; refused
knobs and a missing CUDA device exit non-zero."""

import json
import os
import pathlib
import subprocess
import sys

import pytest

from shadow_tpu_torch import bench as tbench

ROOT = pathlib.Path(__file__).resolve().parent.parent

ROW_KEYS = {"metric", "value", "unit", "vs_baseline", "backend", "device",
            "warmup_s", "wall_s", "windows", "micro_steps", "events"}


def _run(**env):
    full = {k: v for k, v in os.environ.items()
            if not k.startswith("BENCH_")}
    full.update(env)
    full.setdefault("OMP_NUM_THREADS", "1")
    return subprocess.run([sys.executable, "-m", "shadow_tpu_torch.bench"],
                          cwd=ROOT, env=full, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("workload,topo,name", [
    ("phold", "one", "events_per_sec_per_chip@16hosts_phold_load8"),
    ("phold", "mix", "events_per_sec_per_chip@16hosts_phold_load8_mixtopo"),
    ("pingpong", "one", "events_per_sec_per_chip@16hosts_udp_pingpong"),
    ("pingpong", "mix",
     "events_per_sec_per_chip@16hosts_udp_pingpong_mixtopo"),
])
def test_one_json_row_per_workload_and_topology(workload, topo, name):
    # the pings start at 1 s and take 20 round trips of up to 100 ms
    sim_s = "4" if workload == "pingpong" else "1"
    r = _run(BENCH_PLATFORM="cpu", BENCH_HOSTS="16", BENCH_SIM_SECONDS=sim_s,
             BENCH_WORKLOAD=workload, BENCH_TOPO=topo)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert set(row) == ROW_KEYS
    assert row["metric"] == name and row["unit"] == "events/s"
    assert row["backend"] == "cpu" and row["device"] is None
    assert row["events"] > 0 and row["windows"] > 0 and row["wall_s"] > 0
    # value is events over the unrounded wall; wall_s keeps 4 decimals
    assert abs(row["value"] - row["events"] / row["wall_s"]) \
        < 1e-3 * row["value"]
    base = tbench.baseline_rate(16)
    assert base == json.loads((ROOT / "BASELINE.json").read_text())[
        "published"]["events_per_sec"]
    assert row["vs_baseline"] == round(row["value"] / base, 3)
    if workload == "pingpong":
        # 8 pairs x (20 pings + 20 echoes + PROC_START)
        assert row["events"] == 8 * 41


def test_chunked_row_names_its_chunk():
    r = _run(BENCH_PLATFORM="cpu", BENCH_HOSTS="16", BENCH_SIM_SECONDS="1",
             BENCH_CHUNK_WINDOWS="4", BENCH_TELEMETRY="0")
    assert r.returncode == 0, r.stderr
    row = json.loads(r.stdout)
    assert row["metric"].endswith("_phold_load8_chunk4")


def test_baseline_rule_by_scale():
    pub = json.loads((ROOT / "BASELINE.json").read_text())["published"]
    assert tbench.baseline_rate(10_240) == pub["events_per_sec_at_10k_hosts"]
    assert tbench.baseline_rate(100_000) == \
        pub["events_per_sec_at_100k_hosts"]


@pytest.mark.parametrize("env,word", [
    ({"BENCH_SHARDS": "2"}, "BENCH_SHARDS"),
    ({"BENCH_SUPERVISE": "1", "BENCH_WORKLOAD": "pingpong"},
     "BENCH_SUPERVISE"),
    ({"BENCH_TOPO": "ref"}, "BENCH_TOPO"),
    ({"BENCH_WORKLOAD": "relay"}, "BENCH_WORKLOAD"),
    ({"BENCH_CHUNK_WINDOWS": "0"}, "BENCH_CHUNK_WINDOWS"),
    ({"BENCH_PLATFORM": "tpu"}, "BENCH_PLATFORM"),
])
def test_refused_knob_exits_non_zero(env, word):
    r = _run(**{"BENCH_PLATFORM": "cpu", "BENCH_HOSTS": "16", **env})
    assert r.returncode != 0
    assert word in r.stderr and r.stdout == ""


def test_without_cuda_it_exits_non_zero():
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the behavior without a CUDA device")
    r = _run(BENCH_HOSTS="16")
    assert r.returncode != 0 and "CUDA" in r.stderr and r.stdout == ""
