"""The port's persistent program store and warm serving
(shadow_tpu_torch/compile/store.py, serve.py, utils/compcache.py) —
twins of the reference's store cases (tests/test_compile_cache.py)
on a real program: tests/test_parallel.py's 8-host UDP pingpong.

- a program resolved by one ProgramStore call is served warm by the
  next: the entry names the build root's libraries by sha256, and a hit
  loads them after the sha256 holds, with no build; a corrupt payload
  or library, a stale code version, an avals mismatch or a failed save
  each degrade to a rebuild, never a crash;
- gc evicts entries of other code versions first and leaves the build
  root's libraries;
- the build root is claimed for a host (CPU and card fingerprint); a
  mismatched host is redirected with a warning;
- a hit run equals the miss run and the reference's run in EngineStats
  and every leaf, on the whole-run, chunked, run_windows, supervised
  and 2-rank sharded paths; prewarm_dispatch stores the program a
  later run_windows(warm_start=True) loads.

Tolerance zero. The reference runs two programs (whole-run and 2-shard
run_sharded), side by side with the port's spawn of 2 ranks.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import torch_shard_ranks as R
from shadow_tpu.apps import pingpong as jping
from shadow_tpu.net.build import make_runner as jmake_runner
from shadow_tpu.parallel.shard import make_sharded_runner as jsharded
from shadow_tpu_torch import convert, native
from shadow_tpu_torch.compile import buckets, serve
from shadow_tpu_torch.compile.store import (ProgramStore, _sha256,
                                            default_store)
from shadow_tpu_torch.core import insert_kernels
from shadow_tpu_torch.faults import supervisor as tsup
from shadow_tpu_torch.net import build as tbuild
from shadow_tpu_torch.parallel import spawn
from shadow_tpu_torch.utils import checkpoint as tckpt
from shadow_tpu_torch.utils import compcache
from test_parallel import _build as jbuild_pingpong
from torch_parity import side_by_side

torch.set_num_threads(1)

KEY = "pk" + "0123456789abcdef"
# the leaves the reference gives per shard count
PER_SHARD_COUNT = (".outbox.narrow_hit", ".outbox.narrow_miss",
                   ".outbox.max_occupied", ".outbox.route_elided")


def _jax_leaves(sim):
    flat, _ = jax.tree_util.tree_flatten_with_path(jax.device_get(sim))
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _jstats(st):
    st = jax.device_get(st)
    return {k: int(getattr(st, k)) for k in
            ("events_processed", "micro_steps", "windows", "fastpath_hit",
             "fastpath_miss")}


def _ref_whole():
    b = jbuild_pingpong()
    s, st = jax.jit(jmake_runner(b, app_handlers=(jping.handler,)))(b.sim)
    return _jax_leaves(s), _jstats(st)


def _ref_sharded():
    mesh = JMesh(np.array(jax.devices()[:2]), ("hosts",))
    b = jbuild_pingpong()
    s, st = jsharded(b, mesh, "hosts", app_handlers=(jping.handler,))(b.sim)
    return _jax_leaves(s), _jstats(st)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's whole-run and 2-shard programs and the port's
    spawn of 2 ranks (a miss, then a hit, on one store), side by
    side."""
    aot = str(tmp_path_factory.mktemp("aot_sharded"))
    whole, sharded, port = side_by_side([
        _ref_whole, _ref_sharded,
        lambda: spawn(R.warm_sharded_case, 2, aot, deadline_s=240)])
    return {"whole": whole, "sharded": sharded, "port_sharded": port}


@pytest.fixture(autouse=True)
def _loaders(monkeypatch):
    """Each case starts and ends with the process's loaded libraries as
    they were (a hit may load a stored one)."""
    monkeypatch.setattr(native, "_lib", native._lib)
    monkeypatch.setattr(native, "_error", native._error)
    monkeypatch.setattr(insert_kernels, "_LIB", insert_kernels._LIB)
    monkeypatch.delenv(serve.ENV_FLAG, raising=False)
    monkeypatch.delenv("SHADOW_NO_COMPILE_CACHE", raising=False)


def _program():
    b = R.pingpong()

    def factory():
        return tbuild.make_runner(b, app_handlers=(R.tping.handler,),
                                  device="cpu")
    return factory, (b.sim,)


def _own_build_root(tmp_path, monkeypatch):
    """Point the build root at `tmp_path/build` holding a copy of the
    native library this process built (no g++ run); returns the copy."""
    import shutil

    src = native.build_library()
    root = tmp_path / "build"
    monkeypatch.setenv("SHADOW_BUILD_DIR", str(root))
    root = native.build_dir()
    shutil.copy2(src, root / src.name)
    return root / src.name


def _run(fn, args):
    s, st = fn(*args)
    return convert.sim_to_numpy(s), st.as_dict()


def _assert_run(want, got, skip=()):
    (wl, ws), (gl, gs) = want, got
    assert gs == ws
    assert sorted(wl) == sorted(gl), sorted(set(wl) ^ set(gl))
    for k in wl:
        if k in skip:
            continue
        assert wl[k].dtype == gl[k].dtype, (k, wl[k].dtype, gl[k].dtype)
        np.testing.assert_array_equal(gl[k], wl[k], err_msg=k)


# ---- the program store ----------------------------------------------

def test_store_round_trip_hit(tmp_path, runs):
    store = ProgramStore(tmp_path)
    factory, args = _program()
    c1, i1 = store.get_or_compile(KEY, factory, args)
    assert (i1["hit"], i1["stored"]) == (False, True)
    assert i1["compile_s"] > 0 and i1["lower_s"] > 0
    c2, i2 = store.get_or_compile(KEY, factory, args)
    assert i2["hit"] and i2["load_s"] > 0
    miss, hit = _run(c1, args), _run(c2, args)
    _assert_run(runs["whole"], miss)
    _assert_run(runs["whole"], hit)
    # the sidecar carries the versions the gate checks, and the entry
    # names the build root's libraries by sha256 (on the CPU: native/
    # alone); the store keeps no copy of them
    meta = store.read_meta(KEY)
    assert meta["code"] == buckets.code_version()
    assert meta["torch"] == torch.__version__
    assert meta["cuda"] == torch.version.cuda
    assert meta["device"] == compcache.card_identity()
    assert meta["machine"] == compcache.machine_fingerprint()
    lib = native.build_library()
    assert meta["libraries"] == {"native": _sha256(lib)}
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"{KEY}.bin", f"{KEY}.json"]


def test_store_corrupt_payload_degrades_to_compile(tmp_path, monkeypatch,
                                                  runs):
    lib = _own_build_root(tmp_path, monkeypatch)
    store = ProgramStore(tmp_path / "aot")
    factory, args = _program()
    store.get_or_compile(KEY, factory, args)
    store.bin_path(KEY).write_bytes(b"not a pickle")
    assert store.load(KEY, store.read_meta(KEY)["avals"]) is None
    c, info = store.get_or_compile(KEY, factory, args)  # rebuild + store
    assert not info["hit"] and info["stored"]
    _assert_run(runs["whole"], _run(c, args))
    _, again = store.get_or_compile(KEY, factory, args)
    assert again["hit"]
    # a flipped byte of the build root's library fails its sha256: a
    # miss that takes the library out and builds it again from source
    blob = bytearray(lib.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    lib.write_bytes(bytes(blob))
    c, info = store.get_or_compile(KEY, factory, args)
    assert not info["hit"] and info["stored"]
    assert lib.read_bytes() != bytes(blob)
    assert store.read_meta(KEY)["libraries"] == {"native": _sha256(lib)}
    _assert_run(runs["whole"], _run(c, args))
    _, again = store.get_or_compile(KEY, factory, args)
    assert again["hit"]


def test_store_stale_code_version_misses(tmp_path):
    store = ProgramStore(tmp_path)
    factory, args = _program()
    store.get_or_compile(KEY, factory, args)
    meta = json.loads(store.meta_path(KEY).read_text())
    meta["code"] = "f" * 16
    store.meta_path(KEY).write_text(json.dumps(meta))
    _, info = store.get_or_compile(KEY, factory, args)
    assert not info["hit"], "stale code version must not be served"
    # a card or torch of another version is as stale
    for field in ("torch", "cuda", "device", "machine"):
        meta = json.loads(store.meta_path(KEY).read_text())
        meta[field] = "other"
        store.meta_path(KEY).write_text(json.dumps(meta))
        _, info = store.get_or_compile(KEY, factory, args)
        assert not info["hit"], field


def test_store_avals_mismatch_misses(tmp_path):
    store = ProgramStore(tmp_path)
    factory, args = _program()
    store.get_or_compile(KEY, factory, args)
    other = (R.phold(H=8, ring=False).sim,)   # same key, other leaves
    _, info = store.get_or_compile(KEY, factory, other)
    assert not info["hit"], "an under-keyed collision must miss"
    # and a tensor's device type is part of the digest
    from shadow_tpu_torch.compile.store import _avals_digest

    t = torch.zeros(4, dtype=torch.int32)
    assert _avals_digest((t,)) != _avals_digest((t.to(torch.int64),))
    assert _avals_digest((t,)) != _avals_digest((torch.zeros(5),))
    assert _avals_digest((0,)) != _avals_digest((t,))


def test_store_save_failure_is_best_effort(tmp_path, monkeypatch, runs):
    store = ProgramStore(tmp_path)
    factory, args = _program()
    monkeypatch.setattr(ProgramStore, "save",
                        lambda self, *a, **k: False)
    c, info = store.get_or_compile(KEY, factory, args)
    assert not info["stored"] and not info["hit"]
    _assert_run(runs["whole"], _run(c, args))
    assert not store.bin_path(KEY).exists()


def test_store_gc_evicts_stale_code_first(tmp_path):
    store = ProgramStore(tmp_path)
    factory, args = _program()
    store.get_or_compile(KEY, factory, args)
    stale_key = "pk" + "f" * 16
    store.get_or_compile(stale_key, factory, args)
    meta = json.loads(store.meta_path(stale_key).read_text())
    meta["code"] = "e" * 16
    store.meta_path(stale_key).write_text(json.dumps(meta))
    st = store.stats()
    assert st["entries"] == 2
    keep = store.bin_path(KEY).stat().st_size
    out = store.gc(max_bytes=keep + 16)
    assert out["dropped"] == [stale_key], \
        "unservable entries must be evicted before live ones"
    assert store.bin_path(KEY).exists()
    out = store.gc(max_bytes=0)
    assert out["dropped"] == [KEY] and store.stats()["entries"] == 0
    # the libraries are the build root's: gc leaves them
    assert native.build_library().exists()


def test_default_store_re_roots_on_env(tmp_path, monkeypatch):
    monkeypatch.setenv("SHADOW_AOT_DIR", str(tmp_path / "a"))
    assert default_store().root == tmp_path / "a"
    monkeypatch.setenv("SHADOW_AOT_DIR", str(tmp_path / "b"))
    assert default_store().root == tmp_path / "b"
    # unset: aot/ inside the claimed build root
    monkeypatch.delenv("SHADOW_AOT_DIR")
    monkeypatch.setenv("SHADOW_BUILD_DIR", str(tmp_path / "build"))
    assert default_store().root == tmp_path / "build" / "aot"


def test_hit_loads_the_stored_library_without_a_build(tmp_path,
                                                      monkeypatch, runs):
    """A hit in a process with no compiler loads native/ from the build
    root's library the entry names, once its sha256 holds."""
    lib = _own_build_root(tmp_path, monkeypatch)
    store = ProgramStore(tmp_path / "aot")
    factory, args = _program()
    store.get_or_compile(KEY, factory, args)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    c, info = store.get_or_compile(KEY, factory, args)
    assert info["hit"]
    assert native.library_path() == str(lib)
    _assert_run(runs["whole"], _run(c, args))
    # with the library gone from the build root the entry is a miss,
    # which must build, and the build fails by name: the store serves
    # nothing it cannot rebuild
    monkeypatch.setattr(native, "_lib", None)
    lib.unlink()
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        store.get_or_compile(KEY, factory, args)


# ---- the serving wrapper --------------------------------------------

def test_maybe_warm_disabled_is_identity():
    factory, _ = _program()
    info = {}
    fn = factory()
    out = serve.maybe_warm(lambda: fn, KEY, enabled=False, info=info)
    assert out is fn and info == {"warm": False, "key": KEY}


def test_warm_enabled_env_precedence(monkeypatch):
    assert serve.warm_enabled(True) and not serve.warm_enabled(False)
    monkeypatch.setenv(serve.ENV_FLAG, "0")
    assert not serve.warm_enabled(True)
    monkeypatch.setenv(serve.ENV_FLAG, "1")
    assert serve.warm_enabled(False)
    monkeypatch.setenv("SHADOW_NO_COMPILE_CACHE", "1")
    assert not serve.warm_enabled(True)   # master opt-out beats all


def test_warmfn_unreadable_store_falls_back(tmp_path, runs):
    factory, args = _program()
    info = {}

    class Boom(ProgramStore):
        def get_or_compile(self, *a, **k):
            raise OSError("store root gone")

    wf = serve.WarmFn(factory, KEY, store=Boom(tmp_path), info=info)
    _assert_run(runs["whole"], _run(wf, args))
    assert info["fallback"] == "store:OSError" and not info["hit"]
    # the live callable it serves is the same program, whose kernel
    # wrapper takes its plain version only for CPU tensors; a WarmFn
    # takes no digest a dispatch, a ShapeLog around it counts shapes
    assert serve.live_cache_size(wf) is None
    log = serve.ShapeLog(wf)
    log(*args)
    log(*args)
    assert serve.live_cache_size(log) == 1


# ---- the build root's claim -----------------------------------------

def test_build_root_claim_and_redirect(tmp_path, monkeypatch):
    root = tmp_path / "build"
    said = []
    assert compcache._claim_or_redirect(root, "aaaa", said.append) == root
    assert json.loads((root / "machine.json").read_text())[
        "fingerprint"] == "aaaa"
    assert compcache._claim_or_redirect(root, "aaaa", said.append) == root
    assert said == []
    got = compcache._claim_or_redirect(root, "bbbb", said.append)
    assert got == root / "hosts" / "bbbb"
    assert len(said) == 1 and "WARNING" in said[0] and "bbbb" in said[0]
    # the builds resolve through the claim; the opt-out leaves the root
    # unclaimed
    monkeypatch.setenv("SHADOW_BUILD_DIR", str(tmp_path / "b2"))
    assert native.build_dir() == tmp_path / "b2"
    assert insert_kernels.build_dir() == tmp_path / "b2"
    assert (tmp_path / "b2" / "machine.json").exists()
    monkeypatch.setenv("SHADOW_BUILD_DIR", str(tmp_path / "b3"))
    monkeypatch.setenv("SHADOW_NO_COMPILE_CACHE", "1")
    assert compcache.enable_compile_cache() is None
    assert native.build_dir() == tmp_path / "b3"
    assert not (tmp_path / "b3" / "machine.json").exists()
    # the fingerprint covers the card (here: none)
    assert compcache.card_identity() == ("nocuda" if not
                                         torch.cuda.is_available()
                                         else compcache.card_identity())


# ---- warm equals cold equals the reference, on every path -----------

def _bundle():
    return R.pingpong()


def _whole(b, **kw):
    return tbuild.make_runner(b, app_handlers=(R.tping.handler,),
                              device="cpu", **kw)(b.sim)


def _chunked(b, **kw):
    return tbuild.make_chunked_runner(b, app_handlers=(R.tping.handler,),
                                      chunk_windows=4, device="cpu",
                                      **kw)(b.sim)


def _windows(b, **kw):
    s, st, _ = tckpt.run_windows(b, (R.tping.handler,), device="cpu", **kw)
    return s, st


def _supervised(b, tmp=None, compile_info=None, **kw):
    res = tsup.run_supervised(
        b, (R.tping.handler,), checkpoint_path=os.path.join(tmp, "ck"),
        device="cpu", **kw)
    assert res.ok
    compile_info.update(res.compile_info or {})
    return res.sim, res.stats


@pytest.mark.parametrize("path", ["whole", "chunked", "run_windows",
                                  "supervised"])
def test_warm_runs_equal_cold_and_reference(path, tmp_path, monkeypatch,
                                            runs):
    monkeypatch.setenv("SHADOW_AOT_DIR", str(tmp_path / "aot"))
    run = {"whole": _whole, "chunked": _chunked, "run_windows": _windows,
           "supervised": lambda b, **kw: _supervised(b, str(tmp_path),
                                                     **kw)}[path]
    out = []
    for warm in (True, True, False):
        info = {}
        s, st = run(_bundle(), warm_start=warm, compile_info=info)
        out.append((info, (convert.sim_to_numpy(s), st.as_dict())))
    (miss, a), (hit, b), (cold, c) = out
    assert (miss["warm"], miss["hit"], miss["stored"]) == (True, False,
                                                          True)
    assert (hit["warm"], hit["hit"]) == (True, True)
    assert buckets.is_program_key(miss["key"])
    assert hit["key"] == miss["key"]
    assert cold["warm"] is False and "hit" not in cold
    # the loop paths key eagerly; a whole-run factory's key rule stays
    # unresolved while serving is off (the reference's rule)
    assert ("key" in cold) == (path in ("run_windows", "supervised"))
    assert cold.get("key", miss["key"]) == miss["key"]
    for got in (a, b, c):
        _assert_run(runs["whole"], got)


def test_warm_sharded_runs_equal_the_reference(runs):
    """2 gloo ranks, make_sharded_runner(warm_start=True) twice on one
    store: a miss, then a hit, both equal to the reference's 2-shard
    run (and the key carries shards=2). Each rank resolves against the
    store: the rank that stores first makes the other's first call a
    hit."""
    ranks = runs["port_sharded"]
    first = [r["infos"][0] for r in ranks]
    assert any(not i["hit"] and i["stored"] for i in first)
    assert all(r["infos"][1]["hit"] for r in ranks)
    keys = {i["key"] for r in ranks for i in r["infos"]}
    assert len(keys) == 1 and ranks[0]["serial_key"] not in keys
    for got in ranks[0]["runs"]:
        _assert_run(runs["sharded"], got)


def test_prewarm_then_run_windows_hits(tmp_path, monkeypatch, runs):
    monkeypatch.setenv("SHADOW_AOT_DIR", str(tmp_path))
    b = _bundle()
    info = serve.prewarm(b, (R.tping.handler,), device="cpu")
    assert buckets.is_program_key(info["key"])
    assert not info["hit"] and info["stored"]
    cinfo: dict = {}
    sim_w, st_w, _ = tckpt.run_windows(
        _bundle(), app_handlers=(R.tping.handler,), warm_start=True,
        compile_info=cinfo, device="cpu")
    assert cinfo["key"] == info["key"]
    assert cinfo["hit"], "run_windows must load the prewarmed program"
    # and the warm run equals a cold one and the reference's
    monkeypatch.setenv("SHADOW_NO_COMPILE_CACHE", "1")
    sim_c, st_c, _ = tckpt.run_windows(_bundle(),
                                       app_handlers=(R.tping.handler,),
                                       device="cpu")
    for s, st in ((sim_w, st_w), (sim_c, st_c)):
        _assert_run(runs["whole"], (convert.sim_to_numpy(s), st.as_dict()))


def test_escalation_regrow_lands_on_prewarmed_bucket(tmp_path):
    """A run at the grown bucket and an escalated rebuild share one
    program key — the regrown run resolves warm from the store entry
    the bucket run populated."""
    store = ProgramStore(tmp_path)

    def phold(cap):
        b = R.phold(H=8, ring=False, cap=cap)
        return b

    info1 = tckpt.prewarm_dispatch(phold(64), (R.tphold.handler,),
                                   store=store, device="cpu")
    assert not info1["hit"] and info1["stored"]
    regrow = buckets.quantize_pow2(24 * 2)
    assert regrow == 64
    info2 = tckpt.prewarm_dispatch(phold(regrow), (R.tphold.handler,),
                                   store=store, device="cpu")
    assert info2["key"] == info1["key"]
    assert info2["hit"], "regrown shape must serve from the warm bucket"
