"""Device selection for the port's entry points.

Every entry point takes an explicit ``device``. Left unset it is
``"cuda"``; when CUDA is not available that raises — the port never
moves to the CPU quietly. Tests pass ``device="cpu"``, where each
hand-written kernel's wrapper runs its plain PyTorch version.
"""

from __future__ import annotations

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
