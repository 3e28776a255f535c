"""Checkpoint and resume in the port (shadow_tpu_torch.utils.checkpoint)
against the reference's (shadow_tpu.utils.checkpoint), on the CPU:

- a run split at a snapshot and resumed is bit-identical to the
  straight run, at K = 1 and K = 8 windows per dispatch
  (tests/test_checkpoint.py, tests/test_chunked.py);
- a reference snapshot resumes in the port to the reference's own
  resume, and a port snapshot in the reference;
- the same state saved by both packages holds the same keys, dtypes and
  bytes, and the same per-leaf CRC32 and capacities;
- CRC, layout, shape and missing-leaf refusals name the leaf and the
  knob; latest_checkpoint; no temporary file is left behind.

PHOLD at 8 hosts, load 2, 1 sim-s, snapshot at 0.5 s. One reference
program (the per-window step) is compiled for the file. Tolerance zero.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from shadow_tpu.apps import phold as jphold
from shadow_tpu.core import simtime
from shadow_tpu.net import build as jbuild
from shadow_tpu.net.state import NetConfig as JConfig
from shadow_tpu.utils import checkpoint as jckpt
from shadow_tpu_torch import convert
from shadow_tpu_torch import telemetry as ttelemetry
from shadow_tpu_torch.apps import phold as tphold
from shadow_tpu_torch.bench import ONE_VERTEX
from shadow_tpu_torch.net import build as tbuild
from shadow_tpu_torch.net.state import NetConfig as TConfig
from shadow_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(1)

SEC = simtime.ONE_SECOND
HALF = SEC // 2


def _cfg(H=8, load=2, event_capacity=None):
    cap = max(32, 4 * load)
    return dict(num_hosts=H, tcp=False, end_time=SEC, seed=7,
                event_capacity=event_capacity or cap, outbox_capacity=cap,
                router_ring=cap, in_ring=max(8, 2 * load))


def _jax_bundle(**kw):
    H = kw.get("H", 8)
    hosts = [jbuild.HostSpec(name=f"p{i}", proc_start_time=0)
             for i in range(H)]
    b = jbuild.build(JConfig(**_cfg(**kw)), ONE_VERTEX, hosts)
    b.sim = jphold.setup(b.sim, load=2)
    return b


def _port_bundle(**kw):
    H = kw.get("H", 8)
    hosts = [tbuild.HostSpec(name=f"p{i}", proc_start_time=0)
             for i in range(H)]
    b = tbuild.build(TConfig(**_cfg(**kw)), ONE_VERTEX, hosts, device="cpu")
    b.sim = tphold.setup(b.sim, load=2)
    return b


def _jax_leaves(sim):
    flat, _ = jax.tree_util.tree_flatten_with_path(sim)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _assert_leaves_equal(want, got):
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, (k, want[k].dtype, got[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _port_run(**kw):
    b = _port_bundle()
    return tckpt.run_windows(b, app_handlers=(tphold.handler,),
                             device="cpu", **kw)


@pytest.fixture(scope="module")
def snaps(tmp_path_factory):
    """The reference's straight run, its snapshot at 0.5 s, and the
    port's snapshot of the same run."""
    d = tmp_path_factory.mktemp("snaps")
    jb = _jax_bundle()
    jsim, jstats, jsaved = jckpt.run_windows(
        jb, app_handlers=(jphold.handler,), checkpoint_every_ns=HALF,
        checkpoint_path=str(d / "jax"))
    _, _, tsaved = _port_run(checkpoint_every_ns=HALF,
                             checkpoint_path=str(d / "port"))
    return {"jax_final": _jax_leaves(jsim), "jax_stats": jstats.as_dict(),
            "jax_snap": jsaved[0], "port_snap": tsaved[0], "dir": d}


def test_snapshots_land_at_the_same_window(snaps):
    (jp, jt), (tp, tt) = snaps["jax_snap"], snaps["port_snap"]
    assert jt == tt >= HALF
    assert os.path.basename(tp) == f"port.{tt}.npz"


def test_same_state_same_file_contents(snaps):
    """Keys, dtypes, bytes, CRC32s and capacities of the two packages'
    snapshots of one state are equal."""
    jl, jm = jckpt.load_leaves(snaps["jax_snap"][0])
    tl, tm = tckpt.load_leaves(snaps["port_snap"][0])
    assert sorted(jl) == sorted(tl) == jm["keys"] == tm["keys"]
    for k in jl:
        assert jl[k].dtype == tl[k].dtype and jl[k].shape == tl[k].shape, k
        assert jl[k].tobytes() == tl[k].tobytes(), k
    for key in ("time_ns", "layout", "crc32", "capacities", "shards",
                "config_digest", "extra"):
        assert jm[key] == tm[key], key
    assert tm["torch_version"] == torch.__version__
    assert "jax_version" not in tm


@pytest.mark.parametrize("k", [1, 8])
def test_resume_is_bit_identical(snaps, tmp_path, k):
    """run(0 -> T) == run(0 -> C) + save + load + run(C -> T)."""
    straight, st, _ = _port_run(windows_per_dispatch=k)
    _, _, saved = _port_run(windows_per_dispatch=k, end_time=HALF + 1,
                            checkpoint_every_ns=HALF // 2,
                            checkpoint_path=str(tmp_path / "ck"))
    assert saved, "no snapshot was written"
    path, t_ck = saved[-1]
    assert t_ck <= HALF + 1
    b = _port_bundle()
    sim, t0, extra = tckpt.load(path, b.sim)
    assert (t0, extra) == (t_ck, {})
    resumed, _, _ = tckpt.run_windows(b, app_handlers=(tphold.handler,),
                                      sim=sim, start_time=t0,
                                      windows_per_dispatch=k, device="cpu")
    _assert_leaves_equal(convert.sim_to_numpy(straight),
                         convert.sim_to_numpy(resumed))
    assert st.as_dict() == snaps["jax_stats"]
    _assert_leaves_equal(snaps["jax_final"], convert.sim_to_numpy(straight))


def test_reference_snapshot_resumes_in_port(snaps):
    path, t_ck = snaps["jax_snap"]
    b = _port_bundle()
    sim, t0, _ = tckpt.load(path, b.sim)
    assert t0 == t_ck and sim.events.time.device.type == "cpu"
    out, _, _ = tckpt.run_windows(b, app_handlers=(tphold.handler,),
                                  sim=sim, start_time=t0, device="cpu")
    _assert_leaves_equal(snaps["jax_final"], convert.sim_to_numpy(out))


def test_port_snapshot_resumes_in_reference(snaps):
    path, t_ck = snaps["port_snap"]
    jb = _jax_bundle()
    sim, t0, _ = jckpt.load(path, jb.sim)
    assert t0 == t_ck
    out, _, _ = jckpt.run_windows(jb, app_handlers=(jphold.handler,),
                                  sim=sim, start_time=t0)
    _assert_leaves_equal(snaps["jax_final"], _jax_leaves(out))


def test_load_rejects_shape_mismatch_naming_the_knob(tmp_path):
    b = _port_bundle()
    p = tckpt.save(str(tmp_path / "snap"), b.sim, time_ns=0)
    assert p.endswith("snap.npz")
    other = _port_bundle(event_capacity=64)
    with pytest.raises(ValueError, match=r"\.events\.time.*config "
                       r"mismatch.*snapshot event_capacity=32"):
        tckpt.load(p, other.sim)
    with pytest.raises(ValueError, match="config mismatch"):
        tckpt.load(p, _port_bundle(H=16).sim)


def test_load_rejects_a_missing_leaf(tmp_path):
    b = _port_bundle()
    p = tckpt.save(str(tmp_path / "snap.npz"), b.sim, time_ns=0)
    with pytest.raises(ValueError, match=r"missing leaf \.telem\."):
        tckpt.load(p, ttelemetry.attach(b.sim))


def _rewrite(path, leaves=None, meta=None):
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    m = json.loads(str(arrays.pop("__meta__")))
    m.update(meta or {})
    arrays.update(leaves or {})
    np.savez(path, __meta__=json.dumps(m), **arrays)


def test_load_rejects_a_corrupt_leaf_and_another_layout(tmp_path):
    b = _port_bundle()
    p = tckpt.save(str(tmp_path / "snap.npz"), b.sim, time_ns=0)
    t = convert.sim_to_numpy(b.sim)[".net.rng_ctr"].copy()
    t[0] ^= 1
    _rewrite(p, leaves={".net.rng_ctr": t})
    with pytest.raises(ValueError, match=r"\.net\.rng_ctr fails its CRC32"):
        tckpt.load(p, b.sim)
    p2 = tckpt.save(str(tmp_path / "old.npz"), b.sim, time_ns=0)
    _rewrite(p2, meta={"layout": 2})
    for fn in (lambda: tckpt.load(p2, b.sim), lambda: tckpt.peek_meta(p2)):
        with pytest.raises(ValueError, match="layout v2, this build reads v3"):
            fn()


def test_template_dtypes_and_device(tmp_path):
    """u32 planes are saved as uint32 and come back as the port's
    int64 carriers on the template's device; extra rides the meta."""
    b = _port_bundle()
    p = tckpt.save(str(tmp_path / "s"), b.sim, time_ns=5, extra={"a": 1},
                   config_digest="x")
    leaves, meta = tckpt.load_leaves(p)
    assert leaves[".net.rng_keys"].dtype == np.uint32
    assert meta["capacities"] == {"num_hosts": 8, "event_capacity": 32,
                                  "outbox_capacity": 32, "router_ring": 32}
    assert tckpt.peek_meta(p[:-4])["config_digest"] == "x"
    sim, t, extra = tckpt.load(p, b.sim)
    assert (t, extra) == (5, {"a": 1})
    assert sim.net.rng_keys.dtype == torch.int64
    _assert_leaves_equal(convert.sim_to_numpy(b.sim),
                         convert.sim_to_numpy(sim))


def test_latest_checkpoint(tmp_path):
    prefix = str(tmp_path / "run")
    assert tckpt.latest_checkpoint(prefix) is None
    b = _port_bundle()
    for t in (100, 2_000, 35):
        tckpt.save(f"{prefix}.{t}.npz", b.sim, time_ns=t)
    (tmp_path / "run.abc.npz").write_bytes(b"")
    (tmp_path / "runner.9999.npz").write_bytes(b"")
    assert tckpt.latest_checkpoint(prefix) == f"{prefix}.2000.npz"


def test_save_leaves_no_temporary_file(tmp_path, monkeypatch):
    b = _port_bundle()
    tckpt.save(str(tmp_path / "ok.npz"), b.sim, time_ns=0)
    assert sorted(os.listdir(tmp_path)) == ["ok.npz"]

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(tckpt.np, "savez_compressed", boom)
    with pytest.raises(OSError, match="disk full"):
        tckpt.save(str(tmp_path / "bad.npz"), b.sim, time_ns=0)
    assert sorted(os.listdir(tmp_path)) == ["ok.npz"]


def test_run_windows_saves_on_cadence(tmp_path):
    """Per-window snapshots at every multiple of the cadence (the next
    window start at or past it), chunked ones at chunk boundaries."""
    ev = SEC // 5
    _, _, saved = _port_run(checkpoint_every_ns=ev,
                            checkpoint_path=str(tmp_path / "a"))
    times = [t for _, t in saved]
    assert 4 <= len(times) <= 5 and all(
        t >= (i + 1) * ev for i, t in enumerate(times))
    _, _, saved8 = _port_run(checkpoint_every_ns=ev, windows_per_dispatch=8,
                             checkpoint_path=str(tmp_path / "b"))
    assert 0 < len(saved8) < len(saved)
    for p, t in saved + saved8:
        assert tckpt.peek_meta(p)["time_ns"] == t
