"""Hand-written CUDA kernels of the insert path, bound with ctypes.

``mailbox_gather`` is the port of the Pallas TPU kernel
``shadow_tpu/core/insert_pallas.py`` (``mailbox_gather``): each
destination row's arrivals as one contiguous [Wn, P] window of the
row-sorted candidate stream. The source is ``csrc/mailbox_gather.cu``;
it is compiled at first use with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (built from the package's own sources
into ``_build/``, keyed by a hash of the source and flags) and loaded
with ctypes.

The wrapper takes the plain PyTorch version (``mailbox_gather_ref``)
only when its tensors lie on the CPU. For CUDA tensors it launches the
kernel on the current stream or raises: there is no fallback.
``mailbox_gather.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

I32 = torch.int32

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "mailbox_gather.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB: ctypes.CDLL | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels")


def build_library() -> tuple[Path, str]:
    """Compile csrc/mailbox_gather.cu into
    _build/libmailbox_gather-<hash>.so (once per source and flag set).
    Returns the library's path and the compiler's output (ptxas
    register and shared-memory statistics; empty when the library was
    already built). Raises with the compiler's output when the build
    fails."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libmailbox_gather-{digest}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".libmailbox_gather-{digest}.{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {SOURCE} (exit "
                           f"{r.returncode}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return out, r.stdout + r.stderr


def _launcher():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()[0]))
        fn = lib.mailbox_gather_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB.mailbox_gather_launch


def mailbox_gather_ref(stream: torch.Tensor, start: torch.Tensor,
                       Wn: int) -> torch.Tensor:
    """Plain PyTorch version: out[h, j] = stream[min(start[h] + j,
    rows - 1)] — the XLA CLIP gather of the reference's select sweep
    (core/events.py) for every start the caller contract allows."""
    rows = stream.shape[0]
    j = torch.arange(Wn, device=stream.device, dtype=torch.int64)
    idx = (start.to(torch.int64).clamp(min=0)[:, None] + j).clamp(
        max=rows - 1)
    return stream[idx]


def mailbox_gather(stream: torch.Tensor, start: torch.Tensor,
                   Wn: int) -> torch.Tensor:
    """[H, Wn, P] windows of `stream` ([n + Wn, P] i32, row-sorted and
    padded with Wn rows) at per-row offsets `start` ([H] i32,
    non-decreasing, start[h] <= n)."""
    if stream.device.type == "cpu" and start.device.type == "cpu":
        return mailbox_gather_ref(stream, start, Wn)
    if not (stream.is_cuda and start.is_cuda
            and stream.device == start.device):
        raise ValueError("mailbox_gather: stream and start must both lie "
                         f"on one CUDA device (got {stream.device}, "
                         f"{start.device})")
    if stream.dtype != I32 or start.dtype != I32:
        raise TypeError("mailbox_gather: stream and start must be int32 "
                        f"(got {stream.dtype}, {start.dtype})")
    if stream.ndim != 2 or start.ndim != 1:
        raise ValueError("mailbox_gather: stream must be [rows, P] and "
                         f"start [H] (got {tuple(stream.shape)}, "
                         f"{tuple(start.shape)})")
    if not (stream.is_contiguous() and start.is_contiguous()):
        raise ValueError("mailbox_gather: inputs must be contiguous")
    rows, P = stream.shape
    if Wn <= 0 or rows < Wn or P <= 0:
        raise ValueError(f"mailbox_gather: bad Wn={Wn} for stream of "
                         f"{rows} rows x {P}")
    H = start.shape[0]
    out = torch.empty((H, Wn, P), dtype=I32, device=stream.device)
    if H == 0:
        return out
    rc = _launcher()(
        stream.data_ptr(), start.data_ptr(), out.data_ptr(), H, rows, Wn, P,
        torch.cuda.current_stream(stream.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mailbox_gather: kernel launch failed with "
                           f"CUDA error {rc}")
    mailbox_gather.launches += 1
    return out


mailbox_gather.launches = 0
