"""The port's host-only tool twins against the reference's tools, on the
same arguments: the same files byte for byte, the same standard output
and errors, the same exit codes.

- generate_example_config: the config and topology files (its "run:"
  hint names the port's CLI);
- faultplan_lint: every examples/ plan and config, a broken plan, range
  checks, and --checkpoint against a snapshot the port wrote (both
  tools read the same __meta__);
- trace_gen: flash-crowd and ddos traces, text and binary;
- dualmode_diff: the catalog (--list), compare mode on dumped traces,
  and its usage errors. Its run mode executes both backends and is held
  in tests/test_torch_hostrun.py.
"""

import json
import pathlib

import pytest
import torch

from shadow_tpu_torch.tools import (dualmode_diff, faultplan_lint,
                                    generate_example_config, trace_gen)
from tests.conftest import load_tool

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"


def _both(name, port_mod, argv, capsys):
    """[(exit code, stdout, stderr)] of the reference tool and the twin
    on `argv`."""
    out = []
    for mod in (load_tool(name), port_mod):
        rc = mod.main(list(argv))
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    return out


def test_generate_example_config_writes_the_reference_files(tmp_path,
                                                            capsys):
    argv = ["--clients", "7", "--kib", "12", "--vertices", "3",
            "--latency", "20", "--bandwidth", "2048", "--stoptime", "9"]
    rc_j = load_tool("generate_example_config").main(
        ["-o", str(tmp_path / "ref"), *argv])
    rc_t = generate_example_config.main(["-o", str(tmp_path / "port"), *argv])
    assert rc_j == rc_t == 0
    for f in ("shadow.config.xml", "topology.graphml.xml"):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "ref" / f).read_bytes()
    out = capsys.readouterr().out.replace(str(tmp_path / "port"), "DIR")
    out = out.replace(str(tmp_path / "ref"), "DIR").splitlines()
    assert out[2:] == [out[0], out[1].replace("shadow_tpu.cli",
                                              "shadow_tpu_torch.cli")]
    assert out[3].startswith("run: python -m shadow_tpu_torch.cli ")


def _plans(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"faults": [
        {"time_s": 2.0, "kind": "loss", "a": 0, "b": 1, "value": 1.5},
        {"time_s": 1.0, "kind": "crash", "host": 9},
        {"time_s": 1.5, "kind": "warp", "a": 0}]}))
    return [str(p) for p in sorted(EXAMPLES.glob("faultplan_*.json"))] \
        + [str(EXAMPLES / "tgen_traffic.shadow.config.xml"), str(bad)]


@pytest.mark.parametrize("extra", [[], ["--hosts", "4", "--vertices", "1",
                                        "--min-jump-ns", "7000000"],
                                   ["-q"]])
def test_faultplan_lint_equals_reference(tmp_path, capsys, extra):
    for plan in _plans(tmp_path):
        ref, port = _both("faultplan_lint", faultplan_lint,
                          [plan, *extra], capsys)
        assert port == ref, plan
    assert ref[0] == 1   # the broken plan


def test_faultplan_lint_checkpoint_equals_reference(tmp_path, capsys):
    """--checkpoint reads a snapshot the port wrote: the recorded host
    count feeds the range checks, a shrunken capacity is an error and a
    grown one a warning, in both tools alike."""
    from shadow_tpu_torch.net.build import HostSpec, build
    from shadow_tpu_torch.net.state import NetConfig
    from shadow_tpu_torch.tools.chaos_soak import GRAPH
    from shadow_tpu_torch.utils import checkpoint

    b = build(NetConfig(num_hosts=4, tcp=False), GRAPH,
              [HostSpec(name=f"h{i}") for i in range(4)], device="cpu")
    snap = checkpoint.save(str(tmp_path / "ck.0.npz"), b.sim, time_ns=0,
                           shards=2)
    plan = str(EXAMPLES / "faultplan_degraded.json")
    for extra in ([], ["--event-capacity", "8"], ["--event-capacity",
                                                  "64", "--hosts", "5"],
                  ["--outbox-capacity", "64"]):
        ref, port = _both("faultplan_lint", faultplan_lint,
                          [plan, "--checkpoint", snap, *extra], capsys)
        assert port == ref, extra
    assert ref[0] == 0 and "grows the snapshot" in ref[2]
    ref, port = _both("faultplan_lint", faultplan_lint,
                      [plan, "--checkpoint", str(tmp_path / "none.npz")],
                      capsys)
    assert port == ref and ref[0] == 1


@pytest.mark.parametrize("argv", [
    ["flash-crowd", "--hosts", "8", "--victim", "0", "--peak-rate",
     "5000", "--ramp-s", "0.2", "--sustain-s", "0.1"],
    ["ddos", "--hosts", "8", "--victim", "3", "--rate", "2000",
     "--duration-s", "0.5", "--seed", "7"],
    ["ddos", "--hosts", "4", "--victim", "1", "--rate", "800",
     "--duration-s", "0.25", "--binary"]])
def test_trace_gen_writes_the_reference_trace(tmp_path, capsys, argv):
    outs = []
    for mod, tag in ((load_tool("trace_gen"), "ref"), (trace_gen, "port")):
        path = tmp_path / f"{tag}.trace"
        rc = mod.main([*argv, "--out", str(path)])
        cap = capsys.readouterr()
        outs.append((rc, cap.out, cap.err.replace(str(path), "PATH"),
                     path.read_bytes()))
    assert outs[1] == outs[0]
    assert outs[0][0] == 0 and len(outs[0][3]) > 0


def test_dualmode_diff_list_and_compare_equal_reference(tmp_path, capsys):
    ref, port = _both("dualmode_diff", dualmode_diff, ["--list"], capsys)
    assert port == ref and ref[0] == 0 and "bind" in ref[1]
    # normalized records: [op, args, ret]
    sim = {"meta": {"backend": "sim"}, "procs": {"c0": [
        ["socket", [2], 3], ["bind", [3, 80], 0], ["exit", [], 0]]}}
    host = {"meta": {"backend": "host"}, "procs": {"c0": [
        ["socket", [2], 3], ["bind", [3, 80], -1], ["exit", [], 0]]}}
    paths = {}
    for name, doc in (("sim", sim), ("host", host), ("same", sim)):
        paths[name] = str(tmp_path / f"{name}.json")
        pathlib.Path(paths[name]).write_text(json.dumps(doc))
    for a, b, code in (("sim", "same", 0), ("sim", "host", 4)):
        runs = []
        for tag, mod in (("ref", load_tool("dualmode_diff")),
                         ("port", dualmode_diff)):
            report = str(tmp_path / f"{tag}.report.json")
            rc = mod.main(["--sim", paths[a], "--host", paths[b],
                           "--json", report])
            runs.append((rc, capsys.readouterr().out,
                         pathlib.Path(report).read_text()))
        assert runs[1] == runs[0] and runs[0][0] == code
    for argv in (["--sim", paths["sim"]], ["--workload", "nope"],
                 ["--sim", paths["sim"], "--host", str(tmp_path / "x")]):
        ref, port = _both("dualmode_diff", dualmode_diff, argv, capsys)
        assert port == ref and ref[0] == 1, argv
