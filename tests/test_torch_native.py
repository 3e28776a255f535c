"""The port's native library (shadow_tpu_torch/native/) against the
reference's (shadow_tpu/native/) and against the pure-Python twins:
the retransmit tally's interval semantics (tcp_retransmit_tally.h:52-76),
the payload pool's refcounting (payload.c) and the log writer's stable
(time, seq) argsort. The port builds its library from its own sources
into shadow_tpu_torch/_build/ with g++; nothing here needs JAX.
Tolerance: zero (integers and bytes)."""

import ctypes
import io

import numpy as np
import pytest
import torch

import shadow_tpu.utils.shadowlog as jlog
import shadow_tpu_torch.utils.shadowlog as tlog
from shadow_tpu.native import load as jload
from shadow_tpu.native.pool import PayloadPool as JPool
from shadow_tpu.native.tally import RetransmitTally as JTally
from shadow_tpu_torch import native
from shadow_tpu_torch.native.pool import PayloadPool
from shadow_tpu_torch.native.tally import _PyTally, RetransmitTally

torch.set_num_threads(1)


def test_library_builds_from_the_port_sources():
    lib = native.load()
    assert lib is not None, native.load_error()
    assert native.load_error() is None
    path = native.library_path()
    assert path.startswith(str(native.BUILD_DIR))
    assert "libshadow_native-" in path
    # never the reference's prebuilt library
    assert "shadow_tpu/native" not in path
    assert native.require() is lib


def test_a_failed_build_says_why(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    assert native.load() is None
    assert "no-such-compiler" in native.load_error()
    with pytest.raises(RuntimeError, match="unavailable"):
        native.require()


def _scoreboard_scenario(t):
    # 10 MSS-sized (1000 B) segments outstanding: [0, 10000); SACKs for
    # 3000-4000 and 6000-8000; 3 dup acks; recovery point 10000 ->
    # lost = [0,3000) U [4000,6000) U [8000,10000)
    t.mark_sacked(3000, 4000)
    t.mark_sacked(6000, 7000)
    t.mark_sacked(7000, 8000)   # coalesces with the previous
    t.set_recovery_point(10000)
    t.dupl_ack()
    t.dupl_ack()
    assert t.lost_ranges() == []          # below the dup-ack threshold
    t.dupl_ack()
    assert t.lost_ranges() == [(0, 3000), (4000, 6000), (8000, 10000)]
    assert t.is_sacked(6000, 8000)
    assert not t.is_sacked(2000, 3500)
    assert t.sacked_bytes() == 3000
    t.mark_retransmitted(0, 1000)
    assert t.lost_ranges() == [(1000, 3000), (4000, 6000), (8000, 10000)]
    t.advance(6000)
    t.dupl_ack()
    t.dupl_ack()
    t.dupl_ack()
    assert t.lost_ranges() == [(8000, 10000)]
    t.advance(10000)
    assert t.lost_ranges() == []


@pytest.mark.parametrize("kind", ["python", "native", "reference"])
def test_tally_scenario(kind):
    t = {"python": lambda: _PyTally(0), "native": lambda: RetransmitTally(0),
         "reference": lambda: JTally(0)}[kind]()
    if kind != "python":
        assert t.native
    _scoreboard_scenario(t)


@pytest.mark.parametrize("seed", [7, 8])
def test_tally_agrees_with_python_and_reference_randomized(seed):
    rng = np.random.default_rng(seed)
    tallies = (RetransmitTally(0), _PyTally(0), JTally(0))
    for _ in range(300):
        op = int(rng.integers(0, 6))
        b = int(rng.integers(0, 50000))
        e = b + int(rng.integers(1, 3000))
        for t in tallies:
            if op == 0:
                t.mark_sacked(b, e)
            elif op == 1:
                t.dupl_ack()
            elif op == 2:
                t.set_recovery_point(b + 10000)
            elif op == 3:
                t.advance(b // 2)
            elif op == 4:
                t.mark_retransmitted(b, e)
            else:
                t.mark_lost(b, e)
        got = [(t.lost_ranges(), t.sacked_bytes(), t.is_sacked(b, e))
               for t in tallies]
        assert got[0] == got[1] == got[2]


@pytest.mark.parametrize("native_path", [True, False])
def test_payload_pool_matches_the_reference(native_path, monkeypatch):
    """The same operations give the same ids, counts and bytes as the
    reference's pool (native), through the library and the dict path."""
    if not native_path:
        monkeypatch.setattr("shadow_tpu_torch.native.pool.load",
                            lambda: None)
    pools = (PayloadPool(), JPool())
    assert pools[0].native == native_path and pools[1].native
    rng = np.random.default_rng(11)
    live: list[int] = []
    for step in range(200):
        op = int(rng.integers(0, 3))
        if op == 0 or not live:
            data = bytes(rng.integers(0, 256, int(rng.integers(0, 300)),
                                      dtype=np.uint8))
            ids = [p.put(data) for p in pools]
            assert ids[0] == ids[1]
            live.append(ids[0])
        else:
            pid = live[int(rng.integers(0, len(live)))]
            if op == 1:
                assert pools[0].ref(pid) == pools[1].ref(pid)
            else:
                left = [p.unref(pid) for p in pools]
                assert left[0] == left[1]
                if left[0] == 0:
                    live.remove(pid)
        for p in pools:
            assert p.live_bytes() == pools[1].live_bytes()
            assert p.live_refs() == pools[1].live_refs()
            assert p.total_allocs() == pools[1].total_allocs()
    assert pools[0].live_ids() == pools[1].live_ids()
    for pid in pools[1].live_ids():
        assert pools[0].get(pid) == pools[1].get(pid)


def test_payload_pool_scenario():
    pool = PayloadPool()
    assert pool.native
    a = pool.put(b"hello world")
    b = pool.put(b"x" * 1000)
    assert pool.get(a) == b"hello world"
    assert pool.get(b) == b"x" * 1000
    assert pool.live_bytes() == 11 + 1000
    assert pool.ref(a) == 2
    assert pool.unref(a) == 1
    assert pool.unref(a) == 0
    assert pool.live_bytes() == 1000
    assert pool.put(b"yo") == a       # slot recycled
    assert pool.total_allocs() == 3
    with pytest.raises(KeyError):
        pool.get(99)


def _argsort(lib, times, seqs):
    out = np.zeros(len(times), dtype=np.int64)
    p = ctypes.POINTER(ctypes.c_int64)
    lib.logsort_argsort(times.ctypes.data_as(p), seqs.ctypes.data_as(p),
                        len(times), out.ctypes.data_as(p))
    return out


def test_logsort_matches_the_reference_and_lexsort():
    rng = np.random.default_rng(3)
    times = rng.integers(0, 50, 5000).astype(np.int64)
    seqs = rng.permutation(5000).astype(np.int64)
    got = _argsort(native.require(), times, seqs)
    assert np.array_equal(got, np.lexsort((seqs, times)))
    assert np.array_equal(got, _argsort(jload(), times, seqs))


@pytest.mark.parametrize("n", [4095, 4096, 9000])
def test_logger_flush_goes_native_from_4096_records(n):
    """Batches of 4,096 records and more go through logsort; the text
    equals the reference logger's at every size."""
    rng = np.random.default_rng(n)
    times = rng.integers(0, 300, n) * 1_000_000
    texts, sorts = [], None
    for mod in (jlog, tlog):
        out = io.StringIO()
        lg = mod.SimLogger(level=mod.LogLevel.DEBUG, stream=out)
        for i, t in enumerate(times):
            lg.log(int(i % 4) + 2, int(t), f"h{i % 7}", f"record {i}")
        lg.flush()
        texts.append(out.getvalue())
        sorts = getattr(lg, "native_sorts", sorts)
    assert texts[0] == texts[1]
    assert texts[1].count("\n") == n
    assert sorts == (1 if n >= 4096 else 0)


@pytest.mark.parametrize("required", [False, True])
def test_logger_without_the_library(monkeypatch, required):
    """A missing library: list.sort gives the same text, unless the
    logger requires the native sort (the CLI on the card), which raises
    with the reason."""
    n = 4096
    records = [(int(t) * 1_000_000, f"record {i}") for i, t in
               enumerate(np.random.default_rng(7).integers(0, 300, n))]
    want = io.StringIO()
    lg = jlog.SimLogger(level=jlog.LogLevel.INFO, stream=want)
    for t, msg in records:
        lg.info(t, "h", msg)
    lg.flush()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", "no compiler")
    out = io.StringIO()
    lg = tlog.SimLogger(level=tlog.LogLevel.INFO, stream=out,
                        require_native=required)
    for t, msg in records:
        lg.info(t, "h", msg)
    if required:
        with pytest.raises(RuntimeError, match="no compiler"):
            lg.flush()
    else:
        lg.flush()
        assert lg.native_sorts == 0
        assert out.getvalue() == want.getvalue()
