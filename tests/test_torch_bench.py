"""The port's bench entry point, `python -m shadow_tpu_torch.bench`, on
the CPU: one JSON row per workload and topology at 16 hosts with the
documented keys, bench.py's metric names and vs_baseline rule, the
BENCH_INJECT_* rows and bench.py's synthesized trace; the BENCH_SWEEP
row (bench.py's lattice through the port's sweep driver on 2 CPU
workers: its schema, conservation and warm prewarm) and
BENCH_PROFILE_DIR (a torch.profiler trace and the row's `profile`
block, the row's counts those of the unprofiled row); refused knobs and
a missing CUDA device exit non-zero."""

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


def _start(**env):
    full = {k: v for k, v in os.environ.items()
            if not k.startswith("BENCH_")}
    full.update(env)
    full = {k: v for k, v in full.items() if v is not None}   # None: unset
    full.setdefault("OMP_NUM_THREADS", "1")
    return subprocess.Popen([sys.executable, "-m", "shadow_tpu_torch.bench"],
                            cwd=ROOT, env=full, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(p):
    out, err = p.communicate(timeout=300)
    return subprocess.CompletedProcess(p.args, p.returncode, out, err)


def _run(**env):
    return _finish(_start(**env))


WORKLOADS = [
    ("phold", "one", "events_per_sec_per_chip@16hosts_phold_load8"),
    ("phold", "mix", "events_per_sec_per_chip@16hosts_phold_load8_mixtopo"),
    ("pingpong", "one", "events_per_sec_per_chip@16hosts_udp_pingpong"),
    ("pingpong", "mix",
     "events_per_sec_per_chip@16hosts_udp_pingpong_mixtopo"),
]
INJECTION = [
    ({}, "events_per_sec_per_chip@16hosts_inject_rate160_chunk1"),
    ({"BENCH_CHUNK_WINDOWS": "4", "BENCH_CHECKPOINT_WINDOWS": "8"},
     "events_per_sec_per_chip@16hosts_inject_rate160_chunk4"),
    ({"BENCH_INJECT_RATE": "", "BENCH_INJECT_TRACE": "{trace}"},
     "events_per_sec_per_chip@16hosts_inject_trace_chunk1"),
]
# rows run at once by the rows fixture
AT_ONCE = 4


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    """The processes of the file's running rows — the workloads and
    topologies, the chunked row, the injection rows (the trace written
    first) — AT_ONCE at a time: {key: CompletedProcess}."""
    from shadow_tpu_torch.inject import write_trace

    trace = str(tmp_path_factory.mktemp("bench") / "rate.trace")
    write_trace(trace, tbench.rate_trace(16, 160, 2), binary=True)
    envs = {}
    for workload, topo, name in WORKLOADS:
        # the pings start at 1 s and take 20 round trips of up to 100 ms
        sim_s = "4" if workload == "pingpong" else "1"
        envs[name] = dict(BENCH_PLATFORM="cpu", BENCH_HOSTS="16",
                          BENCH_SIM_SECONDS=sim_s, BENCH_WORKLOAD=workload,
                          BENCH_TOPO=topo)
    envs["chunk4"] = dict(BENCH_PLATFORM="cpu", BENCH_HOSTS="16",
                          BENCH_SIM_SECONDS="1", BENCH_CHUNK_WINDOWS="4",
                          BENCH_TELEMETRY="0")
    for env, name in INJECTION:
        full = {"BENCH_PLATFORM": "cpu", "BENCH_HOSTS": "16",
                "BENCH_SIM_SECONDS": "2", "BENCH_INJECT_RATE": "160",
                **{k: v.format(trace=trace) for k, v in env.items()}}
        envs[name] = {k: v for k, v in full.items() if v}
    # the knobs once refused: the sweep row on its own program store, and
    # the plain PHOLD row with one profiled extra call
    lifted = tmp_path_factory.mktemp("lifted")
    envs["sweep"] = dict(BENCH_PLATFORM="cpu", BENCH_HOSTS="4",
                         BENCH_LOAD="2", BENCH_SIM_SECONDS="1",
                         BENCH_SWEEP="1", SHADOW_AOT_DIR=str(lifted / "aot"),
                         SHADOW_NO_COMPILE_CACHE=None,
                         SHADOW_WARM_PROGRAMS=None)
    envs["profile"] = dict(envs[WORKLOADS[0][2]],
                           BENCH_PROFILE_DIR=str(lifted / "prof"))
    out, todo, live = {}, list(envs.items()), []
    while todo or live:
        while todo and len(live) < AT_ONCE:
            key, env = todo.pop(0)
            live.append((key, _start(**env)))
        key, p = live.pop(0)
        out[key] = _finish(p)
    return out


@pytest.mark.parametrize("workload,topo,name", WORKLOADS)
def test_one_json_row_per_workload_and_topology(rows, workload, topo, name):
    r = rows[name]
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    # bench.py's PHOLD row carries its runner's program-store block
    # (serving off); its pingpong row none
    assert set(row) == ROW_KEYS | ({"compile"} if workload == "phold"
                                   else set())
    assert row.get("compile", {"warm": False}) == {"warm": False}
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


def test_chunked_row_names_its_chunk(rows):
    r = rows["chunk4"]
    assert r.returncode == 0, r.stderr
    row = json.loads(r.stdout)
    assert row["metric"].endswith("_phold_load8_chunk4")


def test_baseline_rule_by_scale():
    pub = json.loads((ROOT / "BASELINE.json").read_text())["published"]
    assert tbench.baseline_rate(10_240) == pub["events_per_sec_at_10k_hosts"]
    assert tbench.baseline_rate(100_000) == \
        pub["events_per_sec_at_100k_hosts"]


@pytest.mark.parametrize("env,word", [
    # BENCH_SHARDS runs (tests/test_torch_lanes_cli.py holds its row to
    # bench.py's); it is refused beside the runners it is not wired for
    ({"BENCH_SHARDS": "2", "BENCH_SUPERVISE": "1"}, "BENCH_SHARDS"),
    ({"BENCH_SUPERVISE": "1", "BENCH_WORKLOAD": "pingpong"},
     "BENCH_SUPERVISE"),
    ({"BENCH_TOPO": "ref"}, "BENCH_TOPO"),
    ({"BENCH_WORKLOAD": "relay"}, "BENCH_WORKLOAD"),
    ({"BENCH_CHUNK_WINDOWS": "0"}, "BENCH_CHUNK_WINDOWS"),
    ({"BENCH_PLATFORM": "tpu"}, "BENCH_PLATFORM"),
    # once refused naming their ROADMAP.md items (the ids keep those
    # words), now run: LIFTED_KNOBS checks their rows
    ({"BENCH_SWEEP": "1"}, "BENCH_SWEEP (ROADMAP.md Queue 1 item 12b)"),
    ({"BENCH_PROFILE_DIR": "/tmp/p"},
     "BENCH_PROFILE_DIR (ROADMAP.md Queue 1 item 13)"),
])
def test_refused_knob_exits_non_zero(rows, env, word):
    if word in LIFTED_KNOBS:
        LIFTED_KNOBS[word](rows)
        return
    r = _run(**{"BENCH_PLATFORM": "cpu", "BENCH_HOSTS": "16", **env})
    assert r.returncode != 0
    assert word in r.stderr and r.stdout == ""


# bench.py's _sweep_row keys and its "sweep" block's
SWEEP_ROW_KEYS = {"metric", "value", "unit", "vs_baseline", "backend",
                  "compile_s", "compile_cache", "wall_seconds", "sweep"}
SWEEP_KEYS = {"exit_warm", "exit_timed", "lattice", "points",
              "lattice_conserved", "distinct_programs", "prewarm_hits",
              "prewarm_compiled", "prewarm_hit_rate", "best"}


def _sweep_row_runs(rows):
    """BENCH_SWEEP=1 on bench.py's lattice at 4 hosts, load 2 (seed {1,
    2} x load {2, 3} x event_capacity {6, 8}: 8 points, 2 programs): both
    sweeps exit 0, the lattice is conserved, the scored sweep found both
    programs warm; bench.py's row keys and the port's `device`."""
    r = rows["sweep"]
    assert r.returncode == 0, r.stderr[-3000:]
    row = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(row) == SWEEP_ROW_KEYS | {"device"}
    assert set(row["sweep"]) == SWEEP_KEYS
    assert row["metric"] == "sweep_points_per_sec@8points_2programs_x2workers"
    assert row["unit"] == "points/s" and row["value"] > 0
    assert row["backend"] == "cpu" and row["device"] is None
    sw = row["sweep"]
    assert (sw["exit_warm"], sw["exit_timed"]) == (0, 0)
    assert sw["lattice"] == 8 and sw["lattice_conserved"] is True
    assert sw["points"] == {"expanded": 8, "completed": 8, "failed": 0,
                            "quarantined": 0, "pruned": 0, "pending": 0}
    assert sw["distinct_programs"] == 2
    assert (sw["prewarm_hits"], sw["prewarm_compiled"],
            sw["prewarm_hit_rate"]) == (2, 0, 1.0)
    assert row["compile_cache"] == "fresh"    # the warm-up built both
    assert sw["best"] in {f"p{i:04d}" for i in range(8)}


def _profile_row_runs(rows):
    """BENCH_PROFILE_DIR: the plain PHOLD row with one extra profiled
    call: a Chrome trace in the directory, the row's `profile` block,
    and the counts of the unprofiled row."""
    r = rows["profile"]
    assert r.returncode == 0, r.stderr[-3000:]
    row = json.loads(r.stdout.strip().splitlines()[-1])
    plain = json.loads(rows[WORKLOADS[0][2]].stdout)
    for k in ("metric", "windows", "micro_steps", "events"):
        assert row[k] == plain[k], k
    prof = row["profile"]
    assert prof["tool"] == "torch.profiler"
    traces = list(pathlib.Path(prof["dir"]).glob("torch_trace.*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


LIFTED_KNOBS = {"BENCH_SWEEP (ROADMAP.md Queue 1 item 12b)": _sweep_row_runs,
                "BENCH_PROFILE_DIR (ROADMAP.md Queue 1 item 13)":
                _profile_row_runs}


@pytest.mark.parametrize("env,name", INJECTION,
                         ids=["rate", "rate_chunk4", "trace"])
def test_injection_rows_are_named_as_bench_py_names_them(rows, env, name):
    """bench.py's BENCH_INJECT_* scenario: the tgen app fed 320 events
    (160/s for 2 sim-s, round-robin sources) through the supervised
    loop; the same trace from a file gives the same events."""
    r = rows[name]
    assert r.returncode == 0, r.stderr
    row = json.loads(r.stdout)
    # the supervised loop's program-store block (serving off), keyed
    assert set(row) == ROW_KEYS | {"compile"} and row["metric"] == name
    assert row["compile"]["warm"] is False
    assert sorted(row["compile"]) == ["key", "warm"]
    # 320 injected sends, each delivered by a NIC receive and a packet
    # event (the last few after the end), plus 16 process starts
    assert 320 * 2 < row["events"] < 320 * 3 + 16
    assert row["windows"] == 41


def test_rate_trace_matches_bench_py():
    from conftest import load_tool  # noqa: F401  (tests/ on the path)
    import importlib.util

    spec = importlib.util.spec_from_file_location("ref_bench",
                                                  ROOT / "bench.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    for H, rate, sim_s in ((16, 160.0, 2), (10_240, 10_240.0, 5)):
        assert tbench.rate_trace(H, rate, sim_s) == \
            ref._rate_trace(H, rate, sim_s)
    assert len(tbench.rate_trace(10_240, 10_240.0, 5)) == 51_200


@pytest.mark.parametrize("env,word", [
    ({"BENCH_INJECT_RATE": "100", "BENCH_INJECT_TRACE": "t"},
     "mutually exclusive"),
    ({"BENCH_INJECT_RATE": "100", "BENCH_WORKLOAD": "pingpong"},
     "BENCH_WORKLOAD"),
    ({"BENCH_INJECT_RATE": "100", "BENCH_SUPERVISE": "1"},
     "BENCH_SUPERVISE"),
    ({"BENCH_INJECT_RATE": "fast"}, "BENCH_INJECT_RATE"),
    ({"BENCH_INJECT_RATE": "100", "BENCH_FLOW_OVERHEAD": "1"},
     "BENCH_FLOW_SAMPLE"),
], ids=["rate_and_trace", "workload", "supervise", "nan", "flows"])
def test_injection_refusals(env, word):
    r = _run(**{"BENCH_PLATFORM": "cpu", "BENCH_HOSTS": "16", **env})
    assert r.returncode != 0
    assert word in r.stderr and r.stdout == ""


def test_without_cuda_it_exits_non_zero():
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the behavior without a CUDA device")
    r = _run(BENCH_HOSTS="16")
    assert r.returncode != 0 and "CUDA" in r.stderr and r.stdout == ""


# ------------------------------------------- the knobs of compile/ and the
# sparse shape, each row against bench.py's at 16 hosts on the CPU

LIFTED = {
    "specialize": {"BENCH_SPECIALIZE": "1"},
    "bucketed": {"BENCH_BUCKETED": "1"},
    "active": {"BENCH_ACTIVE": "8"},
    "sparse_off": {"BENCH_SPARSE_LANES": "0"},
}
LIFTED_BASE = {"BENCH_PLATFORM": "cpu", "BENCH_HOSTS": "16",
               "BENCH_SIM_SECONDS": "1"}


def _popen(cmd, **env):
    full = {k: v for k, v in os.environ.items()
            if not k.startswith("BENCH_")}
    full.update(env)
    full = {k: v for k, v in full.items() if v is not None}   # None: unset
    full.setdefault("OMP_NUM_THREADS", "1")
    return subprocess.Popen([sys.executable, *cmd], cwd=ROOT, env=full,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def lifted_rows():
    """bench.py's row and the port's for each lifted knob, the
    subprocesses of each package run side by side."""
    rows = {}
    for pkg, cmd, extra in (("ref", ["bench.py"], {"JAX_PLATFORMS": "cpu"}),
                            ("port", ["-m", "shadow_tpu_torch.bench"], {})):
        procs = {name: _popen(cmd, **LIFTED_BASE, **env, **extra)
                 for name, env in LIFTED.items()}
        for name, p in procs.items():
            out, err = p.communicate(timeout=600)
            assert p.returncode == 0, (pkg, name, err[-2000:])
            rows[pkg, name] = json.loads(out.strip().splitlines()[-1])
    return rows


@pytest.mark.parametrize("name", sorted(LIFTED))
def test_lifted_knob_row_matches_bench_py(lifted_rows, name):
    """Each knob bench.py had and the port refused until now gives
    bench.py's metric name, counts and blocks (rates not compared)."""
    want, got = lifted_rows["ref", name], lifted_rows["port", name]
    assert got["metric"] == want["metric"]
    ctr = want["manifest"]["counters"]
    assert (got["events"], got["windows"], got["micro_steps"]) \
        == (ctr["events_processed"], ctr["windows"], ctr["micro_steps"])
    if name == "specialize":
        assert got["metric"].endswith("_phold_load8_spec")
        assert got["specialization"] == want["specialization"] == {
            "dropped": ["loss", "timers"], "key_extra": "no_loss-no_timers"}
        assert got["specialize_speedup"] > 0
        assert got["events_per_sec_full_program"] > 0
        # the row's own manifest block in bench.py: the guard never fired
        assert want["manifest"]["specialization"]["guard"]["loss_trips"] \
            == 0
    if name == "bucketed":
        # the runner's store block (serving off) and the bucket plan
        assert got["compile"] == want["compile"] == {
            "warm": False, "buckets": want["compile"]["buckets"]}
        assert got["compile"]["buckets"]["event_capacity"] == {
            "requested": 24, "bucketed": 32}
    if name == "active":
        assert got["metric"].endswith("_active8")


@pytest.mark.parametrize("env,word", [
    ({"BENCH_SPECIALIZE": "1", "BENCH_WORKLOAD": "pingpong"},
     "BENCH_SPECIALIZE"),
    ({"BENCH_SPECIALIZE": "1", "BENCH_SUPERVISE": "1"},
     "BENCH_SPECIALIZE"),
    ({"BENCH_SPECIALIZE": "1", "BENCH_INJECT_RATE": "100"},
     "BENCH_SPECIALIZE"),
    ({"BENCH_ACTIVE": "8", "BENCH_REPLICAS": "2"}, "BENCH_ACTIVE"),
    ({"BENCH_ACTIVE": "8", "BENCH_SUPERVISE": "1"}, "BENCH_ACTIVE"),
    ({"BENCH_SPARSE_LANES": "0", "BENCH_INJECT_RATE": "100"},
     "BENCH_SPARSE_LANES"),
    ({"BENCH_ACTIVE": "many"}, "BENCH_ACTIVE"),
], ids=["spec_pingpong", "spec_supervise", "spec_inject",
        "active_replicas", "active_supervise", "sparse_inject", "nan"])
def test_lifted_knob_refusals_match_bench_py(env, word):
    r = _run(**{"BENCH_PLATFORM": "cpu", "BENCH_HOSTS": "16", **env})
    assert r.returncode != 0
    assert word in r.stderr and r.stdout == ""
