"""Persistent program store: resolve a program once per program key,
serve it from disk on every later run (PyTorch port of
shadow_tpu/compile/store.py).

The port runs eagerly, so there is no executable to serialize. What a
cold process pays for is the program's resolved plan and the native
libraries it loads: the `nvcc` build of csrc/mailbox_gather.cu for
`sm_90a` (core/insert_kernels.py, on CUDA programs) and the `g++` build
of native/ (native/__init__.py). The build root (utils/compcache.py)
already keeps those libraries, keyed by source and flags, so a second
process on a kept build root builds nothing with or without this store.
The store keeps no copy of them: an entry names each library the
program loads by its file in the build root and its sha256.

One entry per program key (compile/buckets.py): `<key>.bin` holds a
pickle of the resolved plan (the caller's `meta`: specialization
vector, bucket plan, dispatch shape) and of the libraries it names;
`<key>.json` is a readable sidecar (avals digest, code/torch/CUDA
versions, device, machine fingerprint, sizes, the libraries' sha256).
A hit verifies each library's sha256 and hands the file to the loader
(`insert_kernels.adopt_library`, `native.adopt`). A library whose bytes
are not the ones the entry recorded is taken out of the build root, so
the miss that follows builds it again from source: the store cannot
tell a damaged library from a rebuilt one, and a rebuild is always
safe. The store lives under the claimed build root by default, so a
host with another CPU or card is redirected to its own namespace and
never loads a foreign library.

Safety over speed, always: any corruption, version skew, avals
mismatch or load error is a miss (at most one rebuild of the same
library), never a crash and never a wrong program, and never the plain
kernel or the CPU in place of the card. Writes are atomic (tmp +
os.replace), so a killed worker leaves no torn entries.

The reference's `_compile_outside_xla_cache` has no counterpart: the
port has no second compile cache for a served program to come from.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import pickle
import time

from shadow_tpu_torch.compile import buckets

STORE_VERSION = 2


def _leaves(obj, prefix=""):
    """(path, leaf) pairs of an example call, tensors keyed by their
    flax field path (convert.sim_tensors) inside a Sim."""
    import torch

    from shadow_tpu_torch.convert import sim_tensors
    from shadow_tpu_torch.net.state import Sim

    if isinstance(obj, Sim):
        for path, t in sim_tensors(obj).items():
            yield prefix + path, t
    elif isinstance(obj, (tuple, list)):
        for i, v in enumerate(obj):
            yield from _leaves(v, f"{prefix}[{i}]")
    elif isinstance(obj, dict):
        for k in sorted(obj):
            yield from _leaves(obj[k], f"{prefix}[{k!r}]")
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if v is not None:
                yield from _leaves(v, f"{prefix}.{f.name}")
    elif isinstance(obj, torch.Tensor):
        yield prefix, obj
    else:
        yield prefix, obj


def _avals_digest(args, kwargs=None) -> str:
    """Digest of the example call's tensors: path, shape, dtype and
    device type of each (python scalars tagged by type). The program
    key should already pin these; the digest is the backstop that turns
    an under-keyed collision into a miss instead of a wrongly-served
    program."""
    import torch

    parts = []
    for path, leaf in _leaves((tuple(args), kwargs or {})):
        if isinstance(leaf, torch.Tensor):
            parts.append(f"{path}:{tuple(leaf.shape)}:{leaf.dtype}:"
                         f"{leaf.device.type}")
        else:
            parts.append(f"{path}:py:{type(leaf).__name__}")
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]


def _devices(args, kwargs=None) -> set:
    import torch

    return {leaf.device.type
            for _, leaf in _leaves((tuple(args), kwargs or {}))
            if isinstance(leaf, torch.Tensor)}


def default_root() -> pathlib.Path:
    """Store root: $SHADOW_AOT_DIR, else `aot/` inside the claimed build
    root — claim/redirect included, so a host with another CPU or card
    gets its own namespace exactly like the builds."""
    env = os.environ.get("SHADOW_AOT_DIR")
    if env:
        return pathlib.Path(env)
    from shadow_tpu_torch.utils.compcache import build_root

    return build_root(log=lambda m: None) / "aot"


def _versions() -> dict:
    import torch

    from shadow_tpu_torch.utils.compcache import (card_identity,
                                                  machine_fingerprint)

    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "device": card_identity(), "machine": machine_fingerprint()}


def _sha256(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for blk in iter(lambda: f.read(1 << 20), b""):
            h.update(blk)
    return h.hexdigest()


def _discard(path) -> None:
    """Take a library whose bytes differ from an entry's record out of
    the build root, so the miss builds it again from source."""
    try:
        os.unlink(path)
    except OSError:
        pass


# the native libraries a program loads: name -> (builder that builds if
# needed, loads, and returns the library's file in the build root;
# adopter that loads a given file; the build root's directory)

def _build_kernel():
    from shadow_tpu_torch.core import insert_kernels

    insert_kernels.load_library()
    return insert_kernels.build_library()[0]


def _adopt_kernel(path):
    from shadow_tpu_torch.core import insert_kernels

    insert_kernels.adopt_library(path)


def _kernel_dir():
    from shadow_tpu_torch.core import insert_kernels

    return insert_kernels.build_dir()


def _build_native():
    from shadow_tpu_torch import native

    native.require()
    return native.build_library()


def _adopt_native(path):
    from shadow_tpu_torch import native

    native.adopt(path)


def _native_dir():
    from shadow_tpu_torch import native

    return native.build_dir()


LIBRARIES = {"mailbox_gather": (_build_kernel, _adopt_kernel, _kernel_dir),
             "native": (_build_native, _adopt_native, _native_dir)}


def program_libraries(args, kwargs=None) -> tuple:
    """The native libraries a program on these arguments loads: the
    CUDA kernel when its tensors lie on the card, and native/ always
    (the log writer, the TCP tally and the payload pool)."""
    names = ["native"]
    if "cuda" in _devices(args, kwargs):
        names.insert(0, "mailbox_gather")
    return tuple(names)


class ProgramStore:
    """On-disk map: program key -> resolved plan + the build root's
    libraries it loads, each by sha256."""

    def __init__(self, root: os.PathLike | str | None = None):
        self.root = pathlib.Path(root) if root is not None else default_root()

    # -- paths ---------------------------------------------------------
    def bin_path(self, key: str) -> pathlib.Path:
        return self.root / f"{key}.bin"

    def meta_path(self, key: str) -> pathlib.Path:
        return self.root / f"{key}.json"

    # -- read side -----------------------------------------------------
    def read_meta(self, key: str) -> dict | None:
        try:
            meta = json.loads(self.meta_path(key).read_text())
        except (OSError, ValueError):
            return None
        return meta if isinstance(meta, dict) else None

    def _loadable(self, key: str, avals: str) -> dict | None:
        """Sidecar gate: entry exists, store/code/torch/CUDA/device/
        machine versions match this process, avals match the caller's
        example args."""
        meta = self.read_meta(key)
        if meta is None or not self.bin_path(key).exists():
            return None
        if meta.get("store_version") != STORE_VERSION:
            return None
        if meta.get("code") != buckets.code_version():
            return None
        for k, v in _versions().items():
            if meta.get(k) != v:
                return None
        if meta.get("avals") != avals:
            return None
        return meta

    def load(self, key: str, avals: str) -> dict | None:
        """The stored program for `key` — {"plan", "libraries"} with
        every library loaded from the build root after its sha256 held
        — or None on any mismatch or corruption (the caller then
        builds)."""
        if self._loadable(key, avals) is None:
            return None
        try:
            entry = pickle.loads(self.bin_path(key).read_bytes())
            if entry.get("key") != key:
                return None
            files = {}
            for name, lib in dict(entry["libraries"]).items():
                if name not in LIBRARIES:
                    return None
                path = LIBRARIES[name][2]() / lib["file"]
                if _sha256(path) != lib["sha256"]:
                    _discard(path)
                    return None
                files[name] = path
            for name, path in files.items():
                LIBRARIES[name][1](path)
        except Exception:
            return None
        # LRU touch for gc(): served entries are the ones worth keeping.
        try:
            now = time.time()
            os.utime(self.bin_path(key), (now, now))
        except OSError:
            pass
        return entry

    # -- write side ----------------------------------------------------
    def save(self, key: str, files: dict, avals: str,
             meta: dict | None = None) -> bool:
        """Persist the entry atomically: the .bin naming each library
        ({name: path in the build root}) by file and sha256, then the
        sidecar. Returns False (and leaves no partial entry) on any
        failure — persistence is best-effort, the built program is
        already usable."""
        try:
            self.root.mkdir(parents=True, exist_ok=True)
            libs = {name: {"file": pathlib.Path(path).name,
                           "sha256": _sha256(path)}
                    for name, path in files.items()}
            blob = pickle.dumps({"key": key, "plan": meta or {},
                                 "libraries": libs})
            tmp = self.bin_path(key).with_suffix(".bin.tmp")
            tmp.write_bytes(blob)
            os.replace(tmp, self.bin_path(key))
            sidecar = {
                "key": key,
                "store_version": STORE_VERSION,
                "avals": avals,
                "code": buckets.code_version(),
                "nbytes": len(blob),
                "libraries": {n: lib["sha256"] for n, lib in libs.items()},
                **_versions(),
            }
            sidecar.update(meta or {})
            tmp = self.meta_path(key).with_suffix(".json.tmp")
            tmp.write_text(json.dumps(sidecar, sort_keys=True) + "\n")
            os.replace(tmp, self.meta_path(key))
            return True
        except Exception:
            for p in (self.bin_path(key).with_suffix(".bin.tmp"),
                      self.meta_path(key).with_suffix(".json.tmp")):
                try:
                    p.unlink()
                except OSError:
                    pass
            return False

    # -- the one entry point dispatch paths use ------------------------
    def get_or_compile(self, key: str, factory, args, kwargs=None,
                       meta: dict | None = None):
        """Serve `key` warm if stored, else build it and persist.
        `factory()` builds the dispatch callable. Returns (callable,
        info) where info is the manifest `compile` block payload: {key,
        hit, load_s} on a hit, {key, hit, lower_s, compile_s, stored} on
        a miss — lower_s the dispatch callable's build, compile_s the
        native builds (none when the build root holds the libraries)
        and their dlopen."""
        avals = _avals_digest(args, kwargs)
        t0 = time.perf_counter()
        entry = self.load(key, avals)
        if entry is not None:
            fn = factory()
            return fn, {"key": key, "hit": True,
                        "load_s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        fn = factory()
        t1 = time.perf_counter()
        files = {name: LIBRARIES[name][0]()
                 for name in program_libraries(args, kwargs)}
        t2 = time.perf_counter()
        info = {"key": key, "hit": False,
                "lower_s": t1 - t0, "compile_s": t2 - t1}
        info["stored"] = self.save(key, files, avals, meta)
        if info["stored"] and self.load(key, avals) is None:
            # an entry that cannot be served back is worse than no
            # entry — every later run would miss through it forever
            self.drop(key)
            info["stored"] = False
        return fn, info

    # -- maintenance ---------------------------------------------------
    def ls(self) -> list[dict]:
        """Every entry, oldest-served first: [{key, nbytes, mtime,
        ...sidecar}]."""
        out = []
        try:
            bins = sorted(self.root.glob("*.bin"))
        except OSError:
            return out
        for b in bins:
            key = b.stem
            meta = self.read_meta(key) or {"key": key}
            try:
                st = b.stat()
                meta["nbytes"] = st.st_size
                meta["mtime"] = st.st_mtime
            except OSError:
                continue
            out.append(meta)
        out.sort(key=lambda m: m.get("mtime", 0.0))
        return out

    def stats(self) -> dict:
        entries = self.ls()
        return {
            "root": str(self.root),
            "entries": len(entries),
            "total_bytes": sum(int(m.get("nbytes", 0)) for m in entries),
            "code_versions": sorted({m.get("code") for m in entries
                                     if m.get("code")}),
            # capability-trimmed variants (compile/specialize.py) — a
            # specialized entry's sidecar carries the vector its
            # program was trimmed under
            "specialized": sum(
                1 for m in entries
                if (m.get("specialization") or {}).get("dropped")),
        }

    def drop(self, key: str) -> None:
        for p in (self.bin_path(key), self.meta_path(key)):
            try:
                p.unlink()
            except OSError:
                pass

    def gc(self, max_bytes: int) -> dict:
        """Evict least-recently-served entries until the store fits in
        `max_bytes`. Entries from other code versions go first — they
        can never be served again. The build root's libraries are the
        build root's: gc leaves them."""
        entries = self.ls()
        code = buckets.code_version()
        stale = [m for m in entries if m.get("code") != code]
        fresh = [m for m in entries if m.get("code") == code]
        dropped = []
        total = sum(int(m.get("nbytes", 0)) for m in entries)
        for m in stale + fresh:
            if total <= max_bytes:
                break
            self.drop(m["key"])
            total -= int(m.get("nbytes", 0))
            dropped.append(m["key"])
        return {"dropped": dropped, "remaining_bytes": total}


_DEFAULT: ProgramStore | None = None


def default_store() -> ProgramStore:
    """Process-wide store rooted at default_root(). Re-rooted when
    SHADOW_AOT_DIR changes (tests point it at tmpdirs)."""
    global _DEFAULT
    root = default_root()
    if _DEFAULT is None or _DEFAULT.root != root:
        _DEFAULT = ProgramStore(root)
    return _DEFAULT
