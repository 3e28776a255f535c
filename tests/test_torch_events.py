"""Parity of the port's event queues and outbox insert
(shadow_tpu_torch/core/events.py) with the reference
(shadow_tpu/core/events.py), and of mailbox_gather's plain version with
the reference's XLA windowed gather.

The route shapes are those of tests/test_insert_impls.py: the random
fuzz, the hot row that takes the sorted-scatter fallback, the narrow
tier with narrow 0 and non-zero, sparse rows past the narrow width, and
the empty outbox. The reference runs with impl="sort2" (co-sort +
select sweep / sorted scatter) and impl="sort"; the port has the one
"sort2" mechanism.

Tolerance: zero. Every plane is integer; results must be equal
element for element.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.core import events as jev
from shadow_tpu.core import simtime
from shadow_tpu_torch.core import events as tev
from shadow_tpu_torch.core import insert_kernels as tik

torch.set_num_threads(1)

INVALID = int(simtime.INVALID)


def _mkqueue(rng, H, K, W, fill):
    q = jev.EventQueue.create(H, K, nwords=W)
    valid = rng.random((H, K)) < fill
    t = np.where(valid, rng.integers(100, 10_000, (H, K)), INVALID)
    return q.replace(
        time=jnp.asarray(t, simtime.DTYPE),
        kind=jnp.asarray(np.where(valid, 1, 0), jnp.int32),
        src=jnp.asarray(rng.integers(0, H, (H, K)), jnp.int32),
        seq=jnp.asarray(rng.integers(0, 99, (H, K)), jnp.int32),
        words=jnp.asarray(rng.integers(0, 1 << 20, (H, K, W)), jnp.int32))


def _mkoutbox(rng, H, M, W, cols_of_row, dst_of):
    """Outbox with entries at explicit (row, col) positions; count is
    the number of occupied columns per row."""
    out = jev.Outbox.create(H, M, nwords=W)
    dst = np.full((H, M), -1, np.int64)
    tm = np.full((H, M), INVALID, np.int64)
    kd = np.zeros((H, M), np.int64)
    sq = np.zeros((H, M), np.int64)
    wd = np.zeros((H, M, W), np.int64)
    cnt = np.zeros((H,), np.int64)
    for h in range(H):
        for c in cols_of_row(h):
            dst[h, c] = dst_of(h, c)
            tm[h, c] = rng.integers(100, 10_000)
            kd[h, c] = rng.integers(1, 5)
            sq[h, c] = rng.integers(0, 99)
            wd[h, c] = rng.integers(0, 1 << 20, W)
            cnt[h] += 1
    return out.replace(
        dst=jnp.asarray(dst, jnp.int32), time=jnp.asarray(tm, simtime.DTYPE),
        kind=jnp.asarray(kd, jnp.int32),
        src=jnp.asarray(np.broadcast_to(np.arange(H)[:, None], (H, M)),
                        jnp.int32),
        seq=jnp.asarray(sq, jnp.int32), words=jnp.asarray(wd, jnp.int32),
        count=jnp.asarray(cnt, jnp.int32))


def _to_port(x, cls):
    """A reference flax struct -> the port's dataclass of CPU tensors."""
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(x, f.name)
        kw[f.name] = None if v is None else torch.as_tensor(np.array(v))
    return cls(**kw)


def _assert_same(jx, tx, cls):
    for f in dataclasses.fields(cls):
        a, b = getattr(jx, f.name), getattr(tx, f.name)
        if a is None:
            assert b is None, f.name
            continue
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype, (f.name, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=f.name)


def _route_all(q, out, narrows):
    tq, tout = _to_port(q, tev.EventQueue), _to_port(out, tev.Outbox)
    for narrow in narrows:
        got_q, got_out = tev.route_outbox(tq, tout, narrow=narrow)
        for impl in ("sort2", "sort"):
            want_q, want_out = jev.route_outbox(q, out, impl=impl,
                                                narrow=narrow)
            _assert_same(want_q, got_q, tev.EventQueue)
            _assert_same(want_out, got_out, tev.Outbox)
    return got_q


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_route_fuzz_matches_reference(seed):
    rng = np.random.default_rng(seed)
    H, K, M, W = 53, 12, 10, 6
    q = _mkqueue(rng, H, K, W, fill=0.4)
    cnt = rng.integers(0, M + 1, H)
    out = _mkoutbox(rng, H, M, W, cols_of_row=lambda h: range(cnt[h]),
                    dst_of=lambda h, c: int(rng.integers(0, H)))
    _route_all(q, out, narrows=(0, 4, 8))


def test_route_hot_row_takes_sorted_scatter_and_overflows():
    rng = np.random.default_rng(7)
    H, K, M, W = 40, 8, 12, 6
    q = _mkqueue(rng, H, K, W, fill=0.6)
    out = _mkoutbox(rng, H, M, W, cols_of_row=lambda h: range(M),
                    dst_of=lambda h, c: 3)
    got = _route_all(q, out, narrows=(0, 6))
    assert int(got.overflow) > 0


def test_route_sparse_rows_narrow_gate_widens():
    rng = np.random.default_rng(11)
    H, K, M, W = 31, 10, 9, 6
    q = _mkqueue(rng, H, K, W, fill=0.2)
    out = _mkoutbox(rng, H, M, W, cols_of_row=lambda h: (0, M - 1),
                    dst_of=lambda h, c: (h * 7 + c) % H)
    got = _route_all(q, out, narrows=(0, 4))
    assert int(got.overflow) == 0


@pytest.mark.parametrize("narrow", [0, 4])
def test_route_empty_outbox_is_elided(narrow):
    rng = np.random.default_rng(5)
    H, K, M, W = 16, 8, 10, 6
    q = _mkqueue(rng, H, K, W, fill=0.3)
    out = _mkoutbox(rng, H, M, W, cols_of_row=lambda h: (),
                    dst_of=lambda h, c: 0)
    _route_all(q, out, narrows=(narrow,))
    _, tout = tev.route_outbox(_to_port(q, tev.EventQueue),
                               _to_port(out, tev.Outbox), narrow=narrow)
    assert int(tout.route_elided) == 1


def test_route_random_shapes_mixed_hot_rows():
    rng = np.random.default_rng(23)
    for _ in range(2):
        H = int(rng.integers(8, 70))
        K = int(rng.integers(4, 16))
        M = int(rng.integers(3, 14))
        q = _mkqueue(rng, H, K, 6, fill=float(rng.random()) * 0.8)
        cnt = rng.integers(0, M + 1, H)
        hot = int(rng.integers(0, H))
        out = _mkoutbox(
            rng, H, M, 6,
            cols_of_row=lambda h: sorted(
                rng.choice(M, size=cnt[h], replace=False)),
            dst_of=lambda h, c: hot if rng.random() < 0.5
            else int(rng.integers(0, H)))
        _route_all(q, out, narrows=(0, max(2, M // 2)))


def _jax_window_gather(stream, start, Wn):
    """The reference's select-sweep gather (core/events.py), verbatim."""
    P = stream.shape[1]
    dnums = jax.lax.GatherDimensionNumbers(
        offset_dims=(1, 2), collapsed_slice_dims=(), start_index_map=(0,))
    return jax.lax.gather(
        stream, start[:, None], dnums, slice_sizes=(Wn, P),
        indices_are_sorted=True, mode=jax.lax.GatherScatterMode.CLIP)


def _mailbox_case(seed, H, n, Wn, P):
    rng = np.random.default_rng(seed)
    cnt = np.minimum(rng.poisson(3, H), Wn)
    cnt[rng.random(H) < 0.2] = 0
    cnt[-3:] = 0
    while cnt.sum() > n:
        cnt[cnt.argmax()] -= 1
    start = (np.cumsum(cnt) - cnt).astype(np.int32)
    stream = np.zeros((n + Wn, P), np.int32)
    stream[:n] = rng.integers(-2**31, 2**31 - 1, (n, P), dtype=np.int64)
    return stream, start


@pytest.mark.parametrize("seed,H,n", [(0, 37, 60), (1, 64, 200), (2, 5, 8)])
def test_mailbox_gather_ref_matches_xla_gather(seed, H, n):
    Wn, P = tev.INSERT_SWEEP, 11
    stream, start = _mailbox_case(seed, H, n, Wn, P)
    want = np.asarray(_jax_window_gather(
        jnp.asarray(stream), jnp.asarray(start), Wn))
    got = tik.mailbox_gather_ref(torch.as_tensor(stream),
                                 torch.as_tensor(start), Wn)
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        tik.mailbox_gather(torch.as_tensor(stream), torch.as_tensor(start),
                           Wn).numpy(), want)


def test_pop_push_and_emissions_match_reference():
    rng = np.random.default_rng(9)
    H, K, M, W, E = 24, 6, 5, 6, 4
    q = _mkqueue(rng, H, K, W, fill=0.5)
    # equal times and negative seqs exercise the (src, seq as u32) ties
    q = q.replace(time=jnp.where(q.time != INVALID, q.time // 4000, INVALID),
                  seq=q.seq - 50)
    tq = _to_port(q, tev.EventQueue)
    jq2, jp = jev.pop_earliest(q, 2)
    tq2, tp = tev.pop_earliest(tq, 2)
    _assert_same(jq2, tq2, tev.EventQueue)
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))

    out = jev.Outbox.create(H, M, nwords=W)
    buf = jev.EmitBuffer.create(H, E, nwords=W)
    tbuf = _to_port(buf, tev.EmitBuffer)
    for _ in range(E + 1):  # one more than capacity: counted overflow
        mask = rng.random(H) < 0.8
        dst = np.where(rng.random(H) < 0.4, np.arange(H),
                       rng.integers(0, H, H)).astype(np.int32)
        t = rng.integers(0, 50, H)
        kind = rng.integers(1, 8, H).astype(np.int32)
        words = rng.integers(0, 99, (H, jev.NWORDS)).astype(np.int32)
        buf = jev.emit(buf, jnp.asarray(mask), jnp.asarray(dst),
                       jnp.asarray(t), jnp.asarray(kind), jnp.asarray(words))
        tbuf = tev.emit(tbuf, torch.as_tensor(mask), torch.as_tensor(dst),
                        torch.as_tensor(t), torch.as_tensor(kind),
                        torch.as_tensor(words))
    _assert_same(buf, tbuf, tev.EmitBuffer)
    assert int(tbuf.overflow) > 0
    jq3, jout = jev.apply_emissions(jq2, out, buf)
    tq3, tout = tev.apply_emissions(tq2, _to_port(out, tev.Outbox), tbuf)
    _assert_same(jq3, tq3, tev.EventQueue)
    _assert_same(jout, tout, tev.Outbox)
    assert int(tev.kind_census(tq3, 40)) == int(jev.kind_census(jq3, 40))
    assert int(tev.emit_kind_bits(tbuf)) == int(jev.emit_kind_bits(buf))
    kinds = (jev.EventKind.PACKET, jev.EventKind.TIMER, 40)
    assert tev.census_mask(kinds) == jev.census_mask(kinds)
