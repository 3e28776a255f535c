"""The port's build root and its machine claim (PyTorch port of
shadow_tpu/utils/compcache.py).

The reference points JAX's persistent compilation cache at one
repo-local directory. What the port compiles is the `nvcc` build of
csrc/mailbox_gather.cu for `sm_90a` (core/insert_kernels.py) and the
`g++` build of native/ (native/__init__.py); both land in one build
root, `shadow_tpu_torch/_build/` (or $SHADOW_BUILD_DIR), keyed by
source and flags only.

A shared library built on one host is foreign to another: an `sm_90a`
cubin to a card of another architecture, a `g++ -O2` object to a CPU
without the features it was built for. The build root is therefore
CLAIMED by the first host that writes it: `build_root` records the
host's fingerprint (the CPU's feature flags, plus the card's name,
compute capability and `torch.version.cuda` when CUDA is available) in
`machine.json`, and a later host whose fingerprint disagrees is
redirected, with a logged warning, to `hosts/<fp>/` under the root —
fresh builds there, never a foreign load. SHADOW_NO_COMPILE_CACHE=1
opts out: the build root is then used unclaimed, as a scratch place
for this process's builds, and warm serving is off
(compile/serve.py).
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import pathlib
import platform
import sys

DEFAULT_ROOT = pathlib.Path(__file__).resolve().parents[1] / "_build"


def _cpu_features() -> str:
    feats = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    feats = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        feats = platform.processor()
    return f"{platform.machine()}|{feats}"


def card_identity() -> str:
    """The card's name, compute capability and CUDA version ("nocuda"
    when CUDA is not available): what an sm_90a library depends on."""
    import torch

    if not torch.cuda.is_available():
        return "nocuda"
    p = torch.cuda.get_device_properties(0)
    return f"{p.name}|sm_{p.major}{p.minor}|cuda {torch.version.cuda}"


@functools.lru_cache(maxsize=None)
def machine_fingerprint() -> str:
    """Stable digest of what the build root's libraries depend on: the
    CPU's ISA and feature flags, and the card's identity. Two hosts
    with equal fingerprints can exchange built libraries."""
    blob = f"{_cpu_features()}|{card_identity()}"
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _claim_or_redirect(cache: pathlib.Path, fp: str,
                       log=None) -> pathlib.Path:
    """First fingerprint to write machine.json owns `cache`; a
    mismatched host is redirected to cache/hosts/<fp> with a logged
    warning (fresh builds there, never foreign loads)."""
    say = log or (lambda m: print(m, file=sys.stderr))
    sidecar = cache / "machine.json"
    try:
        recorded = json.loads(sidecar.read_text()).get("fingerprint")
    except (OSError, ValueError):
        recorded = None
    if recorded is None:
        try:
            cache.mkdir(parents=True, exist_ok=True)
            tmp = sidecar.with_suffix(f".json.{os.getpid()}.tmp")
            tmp.write_text(json.dumps(
                {"fingerprint": fp, "machine": platform.machine()},
                sort_keys=True) + "\n")
            os.replace(tmp, sidecar)
        except OSError:
            pass  # read-only checkout: root still usable, unclaimed
        return cache
    if recorded == fp:
        return cache
    redirect = cache / "hosts" / fp
    say(f"WARNING: build root {cache} holds libraries built on a host "
        f"with a different CPU or card (recorded {recorded}, this host "
        f"{fp}); falling back to fresh builds under {redirect}")
    return redirect


def _base_root() -> pathlib.Path:
    env = os.environ.get("SHADOW_BUILD_DIR")
    return pathlib.Path(env) if env else DEFAULT_ROOT


_ROOT: dict = {}


def build_root(log=None) -> pathlib.Path:
    """The directory the kernel and native builds go to: the base root
    ($SHADOW_BUILD_DIR, else the package's _build/) claimed for this
    host, or this host's redirect. Resolved once per process and base
    root (the claim reads the card's identity)."""
    base = _base_root()
    if os.environ.get("SHADOW_NO_COMPILE_CACHE"):
        return base
    if base not in _ROOT:
        _ROOT[base] = _claim_or_redirect(base, machine_fingerprint(), log)
    return _ROOT[base]


def enable_compile_cache(log=None) -> pathlib.Path | None:
    """Claim the build root for this host at an entry point's start (the
    CLI, the bench, a fleet worker), so the redirect warning comes
    first. Returns the resolved root, or None under
    SHADOW_NO_COMPILE_CACHE=1."""
    if os.environ.get("SHADOW_NO_COMPILE_CACHE"):
        return None
    return build_root(log)
