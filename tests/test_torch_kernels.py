"""The port's hand-written CUDA kernels against their plain PyTorch
versions (shadow_tpu_torch/core/insert_kernels.py).

This file imports neither jax nor the JAX package, so on a machine with
a GPU and no JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

Without a CUDA device the kernel tests skip (the kernels have no CPU
mode); the plain version and the wrapper's checks run everywhere.
Tolerance: zero (int32 copies).
"""

import numpy as np
import pytest
import torch

from shadow_tpu_torch.core import insert_kernels as tik

torch.set_num_threads(1)

WN, P = 32, 11


def _case(seed, H, n):
    """A row-sorted stream padded with WN zero rows and its start table:
    Poisson arrival counts, empty rows in the middle and at the end."""
    rng = np.random.default_rng(seed)
    cnt = np.minimum(rng.poisson(6, H), WN)
    cnt[rng.random(H) < 0.2] = 0
    cnt[-3:] = 0
    while cnt.sum() > n:
        cnt[cnt.argmax()] -= 1
    start = (np.cumsum(cnt) - cnt).astype(np.int32)
    stream = np.zeros((n + WN, P), np.int32)
    stream[:n] = rng.integers(-2**31, 2**31 - 1, (n, P), dtype=np.int64)
    return stream, start


def _loop_reference(stream, start):
    rows = stream.shape[0]
    out = np.empty((start.shape[0], WN, stream.shape[1]), np.int32)
    for h, s in enumerate(start):
        for j in range(WN):
            out[h, j] = stream[min(max(int(s), 0) + j, rows - 1)]
    return out


@pytest.mark.parametrize("seed,H,n", [(0, 37, 150), (1, 5, 8)])
def test_plain_version_matches_a_loop(seed, H, n):
    stream, start = _case(seed, H, n)
    got = tik.mailbox_gather_ref(torch.as_tensor(stream),
                                 torch.as_tensor(start), WN)
    np.testing.assert_array_equal(got.numpy(), _loop_reference(stream, start))


def test_wrapper_rejects_tensors_off_the_card_and_the_cpu():
    s = torch.zeros((40, P), dtype=torch.int32)
    with pytest.raises(ValueError):
        tik.mailbox_gather(s, torch.zeros((4,), dtype=torch.int32,
                                          device="meta"), WN)
    with pytest.raises(ValueError):
        tik.mailbox_gather(s.to("meta"), torch.zeros((4,), dtype=torch.int32,
                                                     device="meta"), WN)


@pytest.mark.gpu
@pytest.mark.parametrize("seed,H,n", [(0, 1001, 5000), (1, 10_240, 245_760)])
def test_mailbox_gather_kernel_matches_plain(seed, H, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    stream, start = _case(seed, H, n)
    s = torch.as_tensor(stream, device="cuda")
    st = torch.as_tensor(start, device="cuda")
    before = tik.mailbox_gather.launches
    got = tik.mailbox_gather(s, st, WN)
    assert tik.mailbox_gather.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, tik.mailbox_gather_ref(s, st, WN))


@pytest.mark.gpu
def test_mailbox_gather_kernel_checks_its_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    s = torch.zeros((40, P), dtype=torch.int32, device="cuda")
    st = torch.zeros((4,), dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        tik.mailbox_gather(s.long(), st, WN)
    with pytest.raises(ValueError):
        tik.mailbox_gather(s[:, ::2], st, WN)
    with pytest.raises(ValueError):
        tik.mailbox_gather(s, st, 64)
