"""Parity of the port's threefry streams (shadow_tpu_torch/core/rng.py)
with the reference (shadow_tpu/core/rng.py).

Tolerance: zero. Keys and counters are integers and the f32 uniforms
are built from the same bits, so every draw must be bit-identical;
uniforms are compared as int32 bit patterns. Inputs are made with numpy
from fixed seeds; counters include values next to 2**32 - 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.core import rng as jrng
from shadow_tpu_torch.core import rng as trng

torch.set_num_threads(1)

SEEDS = (1, 7, 123_456_789, 2**40 + 5)


def _counters(seed, shape):
    c = np.random.default_rng(seed).integers(
        0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    flat = c.reshape(-1)
    flat[:4] = [2**32 - 1, 2**32 - 2, 0, 2**31]
    return c


def _keys(seed, H):
    k = np.asarray(jrng.host_streams(seed, H))
    return k, torch.as_tensor(k.astype(np.int64))


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("seed", SEEDS)
def test_host_streams(seed):
    H = 41
    want = np.asarray(jrng.host_streams(seed, H)).astype(np.int64)
    got = trng.host_streams(seed, H).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_and_counter_wrap(seed):
    H = 41
    jk, tk = _keys(seed, H)
    ctr = _counters(seed + 1, (H,))
    u1, c1 = jrng.uniform(jnp.asarray(jk), jnp.asarray(ctr))
    u2, c2 = trng.uniform(tk, torch.as_tensor(ctr.astype(np.int64)))
    np.testing.assert_array_equal(u2.numpy().view(np.int32), _bits(u1))
    np.testing.assert_array_equal(c2.numpy(), np.asarray(c1).astype(np.int64))
    assert c2.numpy()[0] == 0  # 2**32 - 1 wraps like uint32


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_uniform_at_matches_repeated_uniform(seed):
    H = 29
    jk, tk = _keys(seed, H)
    ctr = _counters(seed + 2, (H, 3, 2))
    want = jrng.uniform_at(jnp.asarray(jk), jnp.asarray(ctr))
    got = trng.uniform_at(tk, torch.as_tensor(ctr.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().view(np.int32), _bits(want))


@pytest.mark.parametrize("seed", SEEDS[:2])
@pytest.mark.parametrize("maxval", ["array", 77])
def test_randint(seed, maxval):
    H = 33
    jk, tk = _keys(seed, H)
    ctr = _counters(seed + 3, (H,))
    if maxval == "array":
        mv = np.random.default_rng(seed).integers(2, 5000, H).astype(np.int32)
        jm, tm = jnp.asarray(mv), torch.as_tensor(mv)
    else:
        jm = tm = maxval
    v1, _ = jrng.randint(jnp.asarray(jk), jnp.asarray(ctr), jm)
    v2, _ = trng.randint(tk, torch.as_tensor(ctr.astype(np.int64)), tm)
    np.testing.assert_array_equal(v2.numpy(), np.asarray(v1))
