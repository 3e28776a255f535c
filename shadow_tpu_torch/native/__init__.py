"""Native (C++) host components of the port, loaded with ctypes.

The port's copy of shadow_tpu/native/: the same three sources
(src/retransmit_tally.cc, src/payload_pool.cc, src/logsort.cc) and the
same C interface.

- retransmit tally: interval-set SACK/loss scoreboard (tally.py)
- payload pool: refcounted byte store behind device payload ids
  (pool.py)
- logsort: stable (time, seq) argsort for the log writer
  (utils/shadowlog.py)

The library is built at first use from this package's own sources with
``g++`` into ``libshadow_native-<hash>.so`` in the build root the host
claims (utils/compcache.py; ``shadow_tpu_torch/_build/`` by default),
keyed by a hash of the sources and flags, the way
core/insert_kernels.py builds the CUDA kernel. A warm program
(compile/store.py) hands ``adopt`` that library once its sha256
holds. ``load()`` returns the library, or None with the reason in
``load_error()``; ``require()`` raises with that reason.
Callers that run on the card require the library, so nothing there
falls back quietly to the pure-Python versions (``tally._PyTally``, the
pool's dict path, ``list.sort``), which the tests hold the library
against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "src"
SOURCES = tuple(SRC_DIR / n for n in ("retransmit_tally.cc",
                                      "payload_pool.cc", "logsort.cc"))
# the unclaimed base root; builds go to build_dir() (the host's claim
# or redirect) unless this is set elsewhere
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX = "g++"
CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")

_lib: ctypes.CDLL | None = None
_error: str | None = None


def build_dir() -> Path:
    """Where the library is built: the host's claimed build root
    (utils/compcache.py build_root) while BUILD_DIR is the package's
    default, else BUILD_DIR."""
    from shadow_tpu_torch.utils import compcache

    if BUILD_DIR == compcache.DEFAULT_ROOT:
        return compcache.build_root()
    return BUILD_DIR


def build_library() -> Path:
    """Compile the sources into <build_dir()>/libshadow_native-<hash>.so (once
    per source and flag set; concurrent builders each write a private
    file and rename it into place). Raises with the compiler's output
    when the build fails."""
    h = hashlib.sha256(" ".join((CXX, *CXXFLAGS)).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    root = build_dir()
    out = root / f"libshadow_native-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    from shadow_tpu_torch.device import build_lock

    # ranks starting together build once: the others wait on the lock
    # and find the library
    with build_lock(root):
        if out.exists():
            return out
        tmp = out.with_name(f".{out.name}.{os.getpid()}")
        cmd = [CXX, *CXXFLAGS, "-o", str(tmp), *map(str, SOURCES)]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=300)
        except OSError as e:
            raise RuntimeError(f"cannot run {CXX}: {e}") from e
        if r.returncode != 0:
            raise RuntimeError(f"{CXX} failed to build {out.name} (exit "
                               f"{r.returncode}):\n{r.stdout}{r.stderr}")
        os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> None:
    """Declare every function's argument and result types."""
    i64, i32, vp = ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.retransmit_tally_new.restype = vp
    lib.retransmit_tally_new.argtypes = [i64]
    lib.retransmit_tally_free.argtypes = [vp]
    for f in ("sacked", "retransmitted", "mark_lost"):
        getattr(lib, f"retransmit_tally_{f}").argtypes = [vp, i64, i64]
    lib.retransmit_tally_dupl_ack.argtypes = [vp]
    lib.retransmit_tally_set_recovery_point.argtypes = [vp, i64]
    lib.retransmit_tally_advance.argtypes = [vp, i64]
    lib.retransmit_tally_is_sacked.restype = i32
    lib.retransmit_tally_is_sacked.argtypes = [vp, i64, i64]
    lib.retransmit_tally_lost_ranges.restype = i32
    lib.retransmit_tally_lost_ranges.argtypes = [vp, p_i64, p_i64, i32]
    lib.retransmit_tally_sacked_bytes.restype = i64
    lib.retransmit_tally_sacked_bytes.argtypes = [vp]

    lib.payload_pool_new.restype = vp
    lib.payload_pool_free.argtypes = [vp]
    lib.payload_pool_put.restype = i32
    lib.payload_pool_put.argtypes = [vp, p_u8, i64]
    lib.payload_pool_ref.restype = i32
    lib.payload_pool_ref.argtypes = [vp, i32]
    lib.payload_pool_unref.restype = i32
    lib.payload_pool_unref.argtypes = [vp, i32]
    lib.payload_pool_len.restype = i64
    lib.payload_pool_len.argtypes = [vp, i32]
    lib.payload_pool_get.restype = i64
    lib.payload_pool_get.argtypes = [vp, i32, p_u8, i64]
    lib.payload_pool_live_bytes.restype = i64
    lib.payload_pool_live_bytes.argtypes = [vp]
    lib.payload_pool_total_allocs.restype = i64
    lib.payload_pool_total_allocs.argtypes = [vp]
    lib.payload_pool_live_count.restype = i64
    lib.payload_pool_live_count.argtypes = [vp]
    lib.payload_pool_live_ids.restype = i64
    lib.payload_pool_live_ids.argtypes = [vp, ctypes.POINTER(i32), i64]

    lib.logsort_argsort.restype = None
    lib.logsort_argsort.argtypes = [p_i64, p_i64, i64, p_i64]


def load() -> ctypes.CDLL | None:
    """The native library (built on first use), or None when it cannot
    be built or loaded; ``load_error()`` then says why. Tried once per
    process."""
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(build_library()))
        _bind(lib)
    except (RuntimeError, OSError, AttributeError) as e:
        _error = str(e)
        return None
    _lib = lib
    return _lib


def adopt(path) -> ctypes.CDLL:
    """Load the library from `path` (the build root's library, its
    sha256 checked by the program store) unless one is loaded already;
    returns the process's library. Raises OSError or AttributeError when
    the file does not load or bind."""
    global _lib, _error
    if _lib is None:
        lib = ctypes.CDLL(str(path))
        _bind(lib)
        _lib, _error = lib, None
    return _lib


def load_error() -> str | None:
    """Why ``load()`` returned None (None while it has not failed)."""
    return _error


def require() -> ctypes.CDLL:
    """The native library, or RuntimeError naming why it is missing."""
    lib = load()
    if lib is None:
        raise RuntimeError("shadow_tpu_torch.native: the native library "
                           f"is unavailable: {_error}")
    return lib


def library_path() -> str | None:
    """The loaded library's file (None before a successful load)."""
    return None if _lib is None else _lib._name
