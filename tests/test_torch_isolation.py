"""The port stands alone: importing every module of shadow_tpu_torch
pulls in neither jax, flax nor shadow_tpu (checked in a fresh
interpreter), and its entry points never fall back to the CPU when
CUDA is missing."""

import json
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, json, pkgutil, sys
import shadow_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    shadow_tpu_torch.__path__, "shadow_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "shadow_tpu"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_import_pulls_in_no_jax_and_no_reference():
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    for mod in ("shadow_tpu_torch.core.events", "shadow_tpu_torch.net.nic",
                "shadow_tpu_torch.core.insert_kernels",
                "shadow_tpu_torch.convert", "shadow_tpu_torch.net.bulk",
                "shadow_tpu_torch.core.compact",
                "shadow_tpu_torch.telemetry.ring",
                "shadow_tpu_torch.telemetry.harvest",
                "shadow_tpu_torch.net.tcp", "shadow_tpu_torch.net.tcp_cong",
                "shadow_tpu_torch.apps.relay",
                "shadow_tpu_torch.apps.gossip",
                "shadow_tpu_torch.net.tcp_bulk",
                "shadow_tpu_torch.apps.pingpong",
                "shadow_tpu_torch.utils.checkpoint",
                "shadow_tpu_torch.telemetry.causality",
                "shadow_tpu_torch.bench",
                "shadow_tpu_torch.faults",
                "shadow_tpu_torch.faults.plan",
                "shadow_tpu_torch.faults.apply",
                "shadow_tpu_torch.faults.health",
                "shadow_tpu_torch.faults.escalate",
                "shadow_tpu_torch.faults.conserve",
                "shadow_tpu_torch.faults.supervisor"):
        assert mod in out["modules"]


def test_each_app_state_crosses_into_its_own_class():
    """convert picks the app class by its field names: each app's full
    leaf set (and its required fields alone) matches exactly one
    class."""
    import dataclasses

    from shadow_tpu_torch import convert

    classes = convert._SIM_FIELDS["app"]
    for cls in classes:
        fields = dataclasses.fields(cls)
        for keys in ({f.name for f in fields},
                     {f.name for f in fields
                      if f.default is dataclasses.MISSING}):
            assert convert._container("app", keys) is cls
            required = [c for c in classes if {
                f.name for f in dataclasses.fields(c)
                if f.default is dataclasses.MISSING} <= keys <= {
                f.name for f in dataclasses.fields(c)}]
            assert required == [cls]


def _tiny_build(**kw):
    from shadow_tpu_torch.net.build import HostSpec, build
    from shadow_tpu_torch.net.state import NetConfig

    graph = (ROOT / "tests" / "test_torch_phold.py").read_text().split(
        'ONE_VERTEX = """')[1].split('"""')[0]
    cfg = NetConfig(num_hosts=2, tcp=False)
    return build(cfg, graph, [HostSpec(name="a"), HostSpec(name="b")], **kw)


def test_entry_points_default_to_cuda_and_never_fall_back():
    if torch.cuda.is_available():
        pytest.skip("checks the behavior without a CUDA device")
    from shadow_tpu_torch.net.build import make_runner, run

    with pytest.raises(RuntimeError, match="CUDA"):
        _tiny_build()
    b = _tiny_build(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_runner(b)
    with pytest.raises(RuntimeError, match="CUDA"):
        run(b)


def test_sim_from_numpy_defaults_to_cuda():
    """Carrying state across builds on the card unless the caller asks
    for the CPU, like every other entry point."""
    if torch.cuda.is_available():
        pytest.skip("checks the behavior without a CUDA device")
    from shadow_tpu_torch import convert

    leaves = convert.sim_to_numpy(_tiny_build(device="cpu").sim)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.sim_from_numpy(leaves)
    sim = convert.sim_from_numpy(leaves, device="cpu")
    assert sim.events.time.device.type == "cpu"


def test_tcp_bulk_runner_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("checks the behavior without a CUDA device")
    from shadow_tpu_torch.apps.relay import TCP_BULK
    from shadow_tpu_torch.net.build import make_runner, run

    b = _tiny_build(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_runner(b, app_tcp_bulk=TCP_BULK)
    with pytest.raises(RuntimeError, match="CUDA"):
        run(b, app_tcp_bulk=TCP_BULK, tcp_bulk_lossless=True)
