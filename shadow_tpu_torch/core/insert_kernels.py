"""Hand-written CUDA kernels of the insert path, bound with ctypes.

``mailbox_gather`` is the port of the Pallas TPU kernel
``shadow_tpu/core/insert_pallas.py`` (``mailbox_gather``): each
destination row's arrivals as one contiguous [Wn, P] window of the
row-sorted candidate stream. The source is ``csrc/mailbox_gather.cu``;
it is compiled at first use with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (built from the package's own sources
into the build root the host claims, utils/compcache.py, keyed by a
hash of the source and flags) and loaded with ctypes. A warm program
(compile/store.py) hands the loader that library once its sha256 holds
(``adopt_library``).

The kernel's launch geometry (rows a tile, the stage's bytes, the
grid) comes from ``gather_geometry``, a pure function of the shape and
the card's SM count, which the CPU tests hold. The wrapper takes the
plain PyTorch version (``mailbox_gather_ref``) only when its tensors
lie on the CPU. For CUDA tensors it launches the kernel on the current
stream or raises: there is no fallback. ``mailbox_gather.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import torch

from shadow_tpu_torch.device import build_lock

I32 = torch.int32

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "mailbox_gather.cu"
# the unclaimed base root; builds go to build_dir() (the host's claim
# or redirect) unless this is set elsewhere
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB: ctypes.CDLL | None = None


def build_dir() -> Path:
    """Where the library is built: the host's claimed build root
    (utils/compcache.py build_root) while BUILD_DIR is the package's
    default, else BUILD_DIR."""
    from shadow_tpu_torch.utils import compcache

    if BUILD_DIR == compcache.DEFAULT_ROOT:
        return compcache.build_root()
    return BUILD_DIR


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels")


def build_library(source: Path = SOURCE) -> tuple[Path, str]:
    """Compile `source` (csrc/mailbox_gather.cu unless another design
    of the kernel is named) into <build_dir()>/lib<stem>-<hash>.so (once
    per source and flag set). Returns the library's path and the
    compiler's output (ptxas register and shared-memory statistics;
    empty when the library was already built). Raises with the
    compiler's output when the build fails."""
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    root = build_dir()
    out = root / f"lib{source.stem}-{digest}.so"
    if out.exists():
        return out, ""
    # ranks starting together build once: the others wait on the lock
    # and find the library
    with build_lock(root):
        if out.exists():
            return out, ""
        tmp = root / f".lib{source.stem}-{digest}.{os.getpid()}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {source} (exit "
                               f"{r.returncode}):\n{r.stdout}{r.stderr}")
        os.replace(tmp, out)
    return out, r.stdout + r.stderr


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.mailbox_gather_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, *[ctypes.c_int] * 3, ctypes.c_void_p]
    fn.restype = ctypes.c_int


def adopt_library(path) -> bool:
    """Load the kernel from `path` (the build root's library, its
    sha256 checked by the program store) unless one is loaded already.
    Returns True when the process's library is now `path`'s or was
    loaded before; raises OSError when the file does not load."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(path))
        _bind(lib)
        _LIB = lib
    return True


def library_path() -> str | None:
    """The loaded library's file (None before the first load)."""
    return None if _LIB is None else _LIB._name


def load_library() -> str:
    """Build the library if needed and load it; returns its file."""
    _launcher()
    return _LIB._name


def _launcher():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()[0]))
        _bind(lib)
        _LIB = lib
    return _LIB.mailbox_gather_launch


MAX_TILE_ROWS = 16            # rows a tile (the kernel takes up to 32)
STAGE_MAX = 48 * 1024 - 256   # a stage's bytes at most
                              # (csrc/mailbox_gather.cu STAGE_MAX)


class GatherGeometry(NamedTuple):
    """The kernel's launch: `grid` blocks, block b owning the tile of
    rows [b * tile_rows, (b + 1) * tile_rows), the tile's span
    bulk-copied into a shared-memory stage of `stage_bytes`."""
    tile_rows: int
    stage_bytes: int
    grid: int


def stage_bytes_for(tile_rows: int, Wn: int, P: int) -> int:
    """A stage that holds `tile_rows` rows' windows under the contract
    (starts non-decreasing in steps of at most Wn: a span of at most
    tile_rows * Wn stream rows) plus the 16-byte widening at each end,
    in 16-byte units, capped at STAGE_MAX (a wider span takes the
    kernel's word-by-word path)."""
    return min(-(-(tile_rows * Wn * P * 4 + 32) // 16) * 16, STAGE_MAX)


def gather_geometry(H: int, P: int, Wn: int, sms: int) -> GatherGeometry:
    """The kernel's launch for H rows of [Wn, P] windows on a card of
    `sms` SMs: one tile a block, of ceil(H / (2 * sms)) rows (at most
    MAX_TILE_ROWS and what a stage of the worst-case span holds), so the
    grid covers every SM whenever H allows it and the card's block
    scheduler keeps every resident block's copy in flight."""
    if H < 1 or P < 1 or Wn < 1 or sms < 1:
        raise ValueError(f"gather_geometry: bad shape H={H} P={P} Wn={Wn} "
                         f"sms={sms}")
    r_fit = max(1, min(MAX_TILE_ROWS, (STAGE_MAX - 32) // (Wn * P * 4)))
    tile_rows = min(r_fit, -(-H // (2 * sms)))
    return GatherGeometry(tile_rows, stage_bytes_for(tile_rows, Wn, P),
                          -(-H // tile_rows))


_SMS: dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


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
    non-decreasing, start[h] <= n). Equal to mailbox_gather_ref on any
    start table."""
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
    g = gather_geometry(H, P, Wn, _sm_count(stream.device))
    rc = _launcher()(
        stream.data_ptr(), start.data_ptr(), out.data_ptr(), H, rows, Wn, P,
        g.tile_rows, g.stage_bytes, g.grid, torch.cuda.current_stream(stream.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mailbox_gather: kernel launch failed with "
                           f"CUDA error {rc}")
    mailbox_gather.launches += 1
    return out


mailbox_gather.launches = 0
