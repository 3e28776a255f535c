"""Device selection for the port's entry points.

Every entry point takes an explicit ``device``. Left unset it is
``"cuda"``; when CUDA is not available that raises — the port never
moves to the CPU quietly. Tests pass ``device="cpu"``, where each
hand-written kernel's wrapper runs its plain PyTorch version.
"""

from __future__ import annotations

import contextlib
import fcntl
import os

import torch


def resolve_device(device=None) -> torch.device:
    """The torch.device an entry point runs on (None -> "cuda")."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "shadow_tpu_torch: CUDA is not available; pass device='cpu' "
            "explicitly to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def same_device(a, b) -> bool:
    """True when two devices name the same card ("cuda" matches the
    current "cuda:N")."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type == "cpu" or a.index is None or b.index is None:
        return True
    return a.index == b.index


def rank_device(local_rank: int, device=None) -> torch.device:
    """A mesh rank's device: ``cuda:{local_rank}`` on a machine with a
    card per rank, the one card for every rank on a machine with fewer
    (``cuda:{local_rank % cards}``), the CPU when `device` says so. None
    is "cuda" and raises without CUDA."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(local_rank) % torch.cuda.device_count())
    return dev


@contextlib.contextmanager
def build_lock(build_dir):
    """An exclusive file lock in `build_dir` around a first-use build
    (the CUDA kernels, the native library): ranks that start together
    build once, and the others wait and load the result."""
    os.makedirs(build_dir, exist_ok=True)
    fd = os.open(os.path.join(build_dir, ".build.lock"),
                 os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)
