"""Warm-start serving: the adapter between a dispatch path's program
and the persistent program store (PyTorch port of
shadow_tpu/compile/serve.py).

A dispatch path (utils/checkpoint.py run_windows, net/build.py whole
runners, parallel/shard.py sharded runners) hands `maybe_warm` the
FACTORY of its dispatch callable and its program key. The wrapper is
lazy: the FIRST call resolves against the program store using the
actual call arguments as the example — a hit loads the stored native
libraries (no `nvcc`, no `g++`), a miss builds them and persists for
next time. Either way the wrapper's `info` dict ends up holding the
manifest `compile` block (key, hit, load_s or lower_s/compile_s) the
caller records.

Fallback discipline, the reference's and only it: a store failure
(an unreadable root, a key rule that raises) serves the live callable
and records `fallback` in info. The live callable is the same program:
its kernel wrapper launches the CUDA kernel or raises. No fallback
ever selects `mailbox_gather_ref` or the CPU. When serving is disabled
(`warm_enabled()` false) `maybe_warm` returns the live callable
untouched.

The port's retrace count: a ShapeLog records the distinct avals digests
(compile/store.py) it has been called with, and `live_cache_size`
returns that count. In JAX a new input shape is a retrace; the resident
program's contract (fleet/admission.py) is that this count stays 1, so
it wraps its dispatch callable, served or live, in a ShapeLog. A WarmFn
takes the digest once, at the call that resolves it, and none on the
window loop's later dispatches.
"""

from __future__ import annotations

import os

from shadow_tpu_torch.compile.store import _avals_digest, default_store

ENV_FLAG = "SHADOW_WARM_PROGRAMS"


def warm_enabled(default: bool = False) -> bool:
    """Is warm-program serving on? SHADOW_WARM_PROGRAMS=1/0 wins;
    unset falls back to the caller's default (fleet scenarios default
    on — repeated shapes are their whole workload; ad-hoc runs default
    off). SHADOW_NO_COMPILE_CACHE=1 disables unconditionally — it is
    the master opt-out for every persistent-compile artifact."""
    if os.environ.get("SHADOW_NO_COMPILE_CACHE"):
        return False
    v = os.environ.get(ENV_FLAG)
    if v is None:
        return bool(default)
    return v.strip().lower() not in ("0", "", "false", "no")


class ShapeLog:
    """A callable that records the avals digest of every call it
    forwards: `live_cache_size` reads how many distinct input shapes it
    has seen (the port's retrace count)."""

    def __init__(self, fn):
        self._live = fn
        self._avals_seen: set = set()

    def _note(self, args, kwargs):
        self._avals_seen.add(_avals_digest(args, kwargs))

    def __call__(self, *args, **kwargs):
        self._note(args, kwargs)
        return self._live(*args, **kwargs)


class WarmFn:
    """Lazy warm wrapper: behaves like the dispatch callable its factory
    builds, resolves hit-or-build against the store at first call.
    `key` may be a callable (args, kwargs) -> key for factories whose
    program shapes are only known from the first call's arguments
    (net/build.py runners take any telemetry/lane-attached sim)."""

    def __init__(self, factory, key, *, store=None, meta=None,
                 info=None):
        self._live = None
        self._factory = factory
        self._key = key
        self._store = store
        self._meta = meta
        self._resolved = False
        # shared, caller-visible: run_windows hands this dict to the
        # supervisor/manifest, the wrapper fills it at first dispatch
        self.info = info if info is not None else {}
        if isinstance(key, str):
            self.info.setdefault("key", key)
        self.info.setdefault("warm", True)

    def _live_fn(self):
        if self._live is None:
            self._live = self._factory()
        return self._live

    def _resolve(self, args, kwargs):
        key = self._key
        if callable(key):
            try:
                key = key(args, kwargs)
            except Exception as e:
                self.info.update(
                    {"hit": False, "fallback": f"key:{type(e).__name__}"})
                return self._live_fn()
        if key is None:
            self.info.update({"warm": False, "hit": False})
            return self._live_fn()
        self.info["key"] = key
        store = self._store if self._store is not None else default_store()
        try:
            fn, info = store.get_or_compile(
                key, self._factory, args, kwargs, meta=self._meta)
        except Exception as e:
            # the store itself failed (an unreadable root, a full disk,
            # a native build that raised): serve the live callable —
            # the same program, which builds its kernel at first launch
            # or raises there
            self.info.update({"hit": False,
                              "fallback": f"store:{type(e).__name__}"})
            return self._live_fn()
        self.info.update(info)
        return fn

    def _ensure(self, args, kwargs):
        if not self._resolved:
            self._live = self._resolve(args, kwargs)
            self._resolved = True

    def lower(self, *args, **kwargs):
        """Keep the `fn.lower(*args).compile()` protocol alive through
        the wrapper: compile() resolves load-or-build against the store
        (so its cost lands in the caller's compile phase) and returns
        the WarmFn itself."""
        return _WarmLowered(self, args, kwargs)

    def __call__(self, *args, **kwargs):
        self._ensure(args, kwargs)
        return self._live(*args, **kwargs)


class _WarmLowered:
    """Adapter returned by WarmFn.lower(): .compile() forces the store
    resolution with the lowering arguments as the example and hands
    back the (now-resolved) WarmFn."""

    def __init__(self, warm, args, kwargs):
        self._warm = warm
        self._args = args
        self._kwargs = kwargs

    def compile(self):
        self._warm._ensure(self._args, self._kwargs)
        return self._warm


def maybe_warm(factory, key, *, enabled: bool, store=None, meta=None,
               info=None):
    """Wrap the dispatch callable `factory()` builds for warm serving
    when enabled and keyed; otherwise return `factory()` untouched (and
    mark info warm=False so the manifest still records that serving was
    off)."""
    if not enabled or key is None:
        if info is not None:
            info.setdefault("warm", False)
            # lazy key factories (net/build.py) stay unresolved when
            # serving is off — a callable must never leak into the
            # manifest's compile block
            if isinstance(key, str):
                info.setdefault("key", key)
        return factory()
    return WarmFn(factory, key, store=store, meta=meta, info=info)


def live_cache_size(fn):
    """Distinct input shapes the callable behind `fn` (a ShapeLog) has
    run on — the resident program's zero-retrace proof
    (fleet/admission.py): after any number of admission events the
    count must still be 1, because joins and leaves mutate runtime
    data, never shapes. None when the callable records nothing."""
    seen = getattr(fn, "_avals_seen", None)
    return None if seen is None else len(seen)


def prewarm(bundle, app_handlers=(), *, end_time=None, mesh=None,
            mesh_axis: str = "hosts", exchange_capacity=None,
            windows_per_dispatch=None, adaptive_jump=None, store=None,
            log=None, device=None) -> dict:
    """Build (or confirm warm) the supervised-loop program for a built
    bundle's shape, populating the store so the NEXT run of this shape
    starts dispatching instead of building. Constructs the exact
    dispatch function run_windows would use and forces it through the
    store with example arguments (the bundle's own sim) — the persisted
    program IS the one a later run_windows loads. `device` is
    run_windows' (None -> "cuda"). Returns the compile-info block
    ({key, hit, ...})."""
    from shadow_tpu_torch.utils import checkpoint

    say = log or (lambda m: None)
    info = checkpoint.prewarm_dispatch(
        bundle, app_handlers, end_time=end_time, mesh=mesh,
        mesh_axis=mesh_axis, exchange_capacity=exchange_capacity,
        windows_per_dispatch=windows_per_dispatch,
        adaptive_jump=adaptive_jump, store=store, device=device)
    say(f"prewarm {info.get('key')}: "
        + ("hit" if info.get("hit") else
           f"built in {info.get('compile_s', 0.0):.1f}s"))
    return info
