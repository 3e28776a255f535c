"""Deterministic per-host random streams, bit for bit the reference's.

Draw i of host h under master seed s is
threefry(fold(fold(key(s), h), counter_h)) — the construction of
``shadow_tpu/core/rng.py`` with JAX's ``threefry2x32`` PRNG and
``jax_threefry_partitionable`` on. The bit path reproduced here:

- ``key(s)``: the raw key pair (s >> 32, s & 0xFFFFFFFF);
- ``fold_in(k, d)``: ``threefry2x32(k, (0, d))`` — both output words
  become the new key;
- one scalar f32 uniform from key k: ``b = x0 ^ x1`` of
  ``threefry2x32(k, (0, 0))`` (the partitionable 32-bit path), then
  ``((b >> 9) | 0x3F800000)`` viewed as f32, minus 1.0.

PyTorch has no uint32 ``add`` or shifts on the CPU, so 32-bit words
(``rng_keys`` [H, 2], ``rng_ctr`` [H]) are carried as int64 holding
values in [0, 2**32); every add is masked back to 32 bits. Conversion
to and from real uint32 happens only at the parity boundary
(``convert.py``).
"""

from __future__ import annotations

import torch

I32 = torch.int32
I64 = torch.int64
M32 = 0xFFFFFFFF

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block (20 rounds), elementwise over
    broadcastable int64 tensors holding 32-bit values. Returns the two
    output words, each in [0, 2**32)."""
    k3 = k1 ^ k2 ^ _KS_PARITY
    ks = (k1, k2, k3)
    x1 = (x1 + k1) & M32
    x2 = (x2 + k2) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x1, x2


def _fold_in(k1, k2, data):
    """fold_in(key, data) for int64-carried u32 key words and data."""
    zero = torch.zeros_like(data)
    return threefry2x32(k1, k2, zero, data & M32)


def _uniform_of_key(k1, k2) -> torch.Tensor:
    """One scalar f32 uniform [0, 1) per key (elementwise)."""
    zero = torch.zeros_like(k1)
    b1, b2 = threefry2x32(k1, k2, zero, zero)
    bits = b1 ^ b2
    fbits = ((bits >> 9) | 0x3F800000).to(I32)
    return fbits.view(torch.float32) - 1.0


def host_streams(seed: int, num_hosts: int, device=None) -> torch.Tensor:
    """[H, 2] int64 (u32 values) per-host base key data."""
    s = int(seed) & ((1 << 64) - 1)
    k1 = torch.full((num_hosts,), (s >> 32) & M32, dtype=I64, device=device)
    k2 = torch.full((num_hosts,), s & M32, dtype=I64, device=device)
    h = torch.arange(num_hosts, dtype=I64, device=device)
    y1, y2 = _fold_in(k1, k2, h)
    return torch.stack([y1, y2], dim=1)


def uniform(key_data: torch.Tensor, counters: torch.Tensor):
    """One f32 uniform [0,1) draw per host at its current counter;
    returns (values[H], (counters + 1) mod 2**32)."""
    f1, f2 = _fold_in(key_data[:, 0], key_data[:, 1], counters)
    return _uniform_of_key(f1, f2), (counters + 1) & M32


def uniform_at(key_data: torch.Tensor, counters: torch.Tensor) -> torch.Tensor:
    """f32 uniform [0,1) draws at explicit counters ([H, ...], leading
    dim = hosts). Bit-identical to repeated uniform() calls at the same
    counter values."""
    H = key_data.shape[0]
    flat = counters.reshape(H, -1)
    f1, f2 = _fold_in(key_data[:, 0:1], key_data[:, 1:2], flat)
    return _uniform_of_key(f1, f2).reshape(counters.shape)


def randint(key_data: torch.Tensor, counters: torch.Tensor, maxval):
    """One i32 uniform draw in [0, maxval) per host (maxval may be [H])."""
    u, ctr = uniform(key_data, counters)
    if isinstance(maxval, torch.Tensor):
        top = maxval.to(I32) - 1
    else:
        top = torch.full_like(u, int(maxval) - 1, dtype=I32)
    vals = torch.minimum((u * maxval).to(I32), top)
    return vals, ctr
