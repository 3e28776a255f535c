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
                "shadow_tpu_torch.convert"):
        assert mod in out["modules"]


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
