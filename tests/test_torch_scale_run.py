"""The port's scale harness (shadow_tpu_torch/tools/scale_run.py)
against the reference's tools/scale_run.py, on the CPU: the same flags
print the same JSON row — every field but the wall-clock ones
(`wall_s`, `events_per_sec`, `sim_sec_per_wall_sec`, `compile_s`),
`device_bytes` (the port carries the u32 planes as int64) and
`platform` — for PHOLD, UDP gossip, PHOLD in chunks, as a 2-replica
ensemble and on 2 gloo ranks (`--shards 2`: the twin starts its second
rank as a process of itself).

The reference runs in-process (sys.argv patched for its main()); the
twin runs as `python -m shadow_tpu_torch.tools.scale_run ... --cpu`,
its five processes beside the reference's runs. The relay, Tor and TCP
gossip builders are held in tests/test_torch_relay.py,
test_torch_relay_mux.py and test_torch_gossip_tcp.py, against the
bundles those files already run against the reference. Tolerance zero.
"""

import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from tests.conftest import load_tool

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent

PHOLD = ["--workload", "phold", "--load", "2", "--sim-seconds", "2"]
CASES = {
    "phold": PHOLD + ["--hosts", "32"],
    "gossip": ["--workload", "gossip", "--hosts", "16", "--sim-seconds",
               "5"],
    "chunk": PHOLD + ["--hosts", "16", "--chunk", "4"],
    "replicas": PHOLD + ["--hosts", "32", "--replicas", "2"],
    "shards": PHOLD + ["--hosts", "16", "--shards", "2"],
}
# the fields that differ by design
UNCOMPARED = ("wall_s", "events_per_sec", "sim_sec_per_wall_sec",
              "compile_s", "device_bytes", "platform")


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def rows():
    """{case: (the reference's row, the twin's row)}: the twin's
    processes run while the reference's main() runs each case."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "shadow_tpu_torch.tools.scale_run", *argv,
         "--cpu"], cwd=ROOT, env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for name, argv in CASES.items()}
    tool = load_tool("scale_run")
    ref = {}
    try:
        for name, argv in CASES.items():
            buf = io.StringIO()
            with pytest.MonkeyPatch.context() as mp, \
                    contextlib.redirect_stdout(buf):
                mp.setattr(sys, "argv", ["scale_run.py", *argv, "--cpu"])
                assert tool.main() == 0
            ref[name] = _last_json(buf.getvalue())
    finally:
        out = {}
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=600)
            out[name] = (p.returncode, stdout, stderr)
    got = {}
    for name, (code, stdout, stderr) in out.items():
        assert code == 0, stderr
        got[name] = (ref[name], _last_json(stdout))
    return got


@pytest.mark.parametrize("case", list(CASES))
def test_row_equals_reference(rows, case):
    want, got = rows[case]
    assert sorted(got) == sorted(want)
    assert got["platform"] == "cpu" and got["verified"] is True
    assert {k: v for k, v in got.items() if k not in UNCOMPARED} == \
        {k: v for k, v in want.items() if k not in UNCOMPARED}


def test_build_workload_covers_every_workload():
    """build_workload builds each workload's bundle, its runner
    keywords and its verify: the relay's circuits stay in their replica
    block, the Tor chains are drawn per block, TCP gossip refuses an
    ensemble."""
    from shadow_tpu_torch.tools import scale_run

    def args(*extra):
        return scale_run.parse_args(["--hosts", "20", "--sim-seconds", "5",
                                     "--cpu", *extra])

    b, kw, _ = scale_run.build_workload(args("--workload", "relay",
                                             "--replicas", "2"), 1, 64)
    assert b.circuits == [[r * 10 + c * 5 + k for k in range(5)]
                          for r in range(2) for c in range(2)]
    assert "app_tcp_bulk" in kw and "tcp_bulk_lossless" not in kw
    b, kw, _ = scale_run.build_workload(
        args("--workload", "tor", "--bulk-lossless"), 1, 64)
    assert kw["tcp_bulk_lossless"] is True and b.circuits
    assert b.cfg.sockets_per_host == 2 + 2 * 8
    _, kw, _ = scale_run.build_workload(
        args("--workload", "gossip", "--gossip-transport", "tcp",
             "--no-bulk"), 1, 64)
    assert "app_bulk" not in kw and "app_tcp_bulk" not in kw
    with pytest.raises(SystemExit, match="ensemble"):
        scale_run.build_workload(args("--workload", "gossip",
                                      "--gossip-transport", "tcp",
                                      "--replicas", "2"), 1, 64)
    with pytest.raises(SystemExit, match="must divide"):
        scale_run.build_workload(args("--replicas", "3"), 1, None)
