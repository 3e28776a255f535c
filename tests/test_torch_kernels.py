"""The port's hand-written CUDA kernels against their plain PyTorch
versions (shadow_tpu_torch/core/insert_kernels.py).

This file imports neither jax nor the JAX package, so on a machine with
a GPU and no JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

Without a CUDA device the kernel tests skip (the kernels have no CPU
mode); the plain version, the wrapper's checks, the kernel's launch
geometry and a word-level model of its read rule (which bytes come
from the bulk copy's stage, which from device memory) run everywhere.
Tolerance: zero (int32 copies).
"""

import zlib

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


def test_binding_matches_the_launcher_signature():
    # the ctypes argtypes against the C launcher's parameters, one by one
    import ctypes
    import re
    import types

    src = tik.SOURCE.read_text()
    params = re.search(r'extern "C" int mailbox_gather_launch\((.*?)\)',
                       src, re.S).group(1).split(",")
    lib = types.SimpleNamespace(mailbox_gather_launch=types.SimpleNamespace())
    tik._bind(lib)
    want = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
            "long long": ctypes.c_longlong}
    got = lib.mailbox_gather_launch.argtypes
    assert len(got) == len(params)
    for ty, p in zip(got, params):
        decl = " ".join(p.replace("const", "").split()[:-1]).replace(
            " *", "*")
        assert ty is want[decl], (p, ty)


# ---- the launch geometry (insert_kernels.gather_geometry) -----------

SMS = 132   # an H100 SXM
SMEM_PER_BLOCK = 232_448   # an H100's most shared memory a block


def tile_span(starts, rows: int, P: int, Wn: int, stage_bytes: int,
              misalign: int):
    """The kernel's choice for one tile (csrc/mailbox_gather.cu), in
    byte offsets from the stream's data_ptr, which lies `misalign`
    (0, 4, 8 or 12) bytes past a 16-byte boundary: the starts are
    clamped to [0, rows - 1]; the span [min s, min(max s + Wn, rows))
    of rows is widened to 16-byte boundaries of the absolute address,
    [glo, ghi). If that fits the stage, the bulk copy brings [blo, bhi):
    the widened span cut to the tensor's 16-byte-aligned interior (so
    it never reads outside the tensor), landing at stage byte blo - glo.
    Returns (glo, blo, bhi), or None for the word-by-word path (every
    word read from device memory)."""
    s = [min(max(int(v), 0), rows - 1) for v in starts]
    row_bytes = 4 * P
    lo = min(s) * row_bytes
    hi = min(max(s) + Wn, rows) * row_bytes
    glo = ((lo + misalign) & ~15) - misalign
    ghi = ((hi + misalign + 15) & ~15) - misalign
    if ghi - glo > stage_bytes:
        return None
    a0 = (16 - misalign) & 15
    a1 = ((rows * row_bytes + misalign) & ~15) - misalign
    blo, bhi = max(glo, a0), min(ghi, a1)
    return glo, blo, max(bhi, blo)


@pytest.mark.parametrize("P", [11, 22])
@pytest.mark.parametrize("H", [1, 5, 1_000, 1_001, 2_560, 10_240, 102_400])
def test_gather_geometry(H, P):
    g = tik.gather_geometry(H, P, WN, SMS)
    # every row is covered exactly once: block b owns the tile
    # [b * tile_rows, (b + 1) * tile_rows)
    seen = np.zeros(H, np.int64)
    for b in range(g.grid):
        lo = b * g.tile_rows
        assert lo < H, "a block with no rows"
        seen[lo:lo + g.tile_rows] += 1
    assert (seen == 1).all()
    # the stage and the kernel's static shared memory (its barrier, span
    # and the tile's starts: 256 bytes, as ptxas reports) fit a block,
    # under the 48 KB a launch gets without raising its limit
    assert g.stage_bytes % 16 == 0
    assert g.stage_bytes <= tik.STAGE_MAX <= 48 * 1024 - 256
    assert tik.STAGE_MAX < SMEM_PER_BLOCK
    assert 1 <= g.tile_rows <= tik.MAX_TILE_ROWS
    # the grid fills the card once H allows it
    assert g.grid >= min(H, SMS)
    # the worst span the contract allows (starts stepping by WN) fits a
    # stage at every misalignment of the stream's data_ptr
    rows = g.tile_rows * WN + WN
    for mis in (0, 4, 8, 12):
        assert tile_span(np.arange(g.tile_rows) * WN, rows, P, WN,
                         g.stage_bytes, mis) is not None


def test_gather_geometry_fills_the_card_at_small_widths():
    # 19a's, the --test route's and 20a's widths: every SM gets blocks of
    # one short tile each
    for H in (1_000, 1_001, 2_560):
        g = tik.gather_geometry(H, 11, WN, SMS)
        assert g.grid >= SMS and g.tile_rows <= 10
    g = tik.gather_geometry(10_240, 11, WN, SMS)
    assert g.grid == 640 and g.tile_rows == 16


def test_gather_geometry_scalar_stores_off_the_16_byte_stride():
    # 55 words a window (Wn = 5, P = 11): the output stride is off 16
    # bytes, so the kernel stores word by word; the stage is still sized
    # in 16-byte units and holds the tile's worst span
    g = tik.gather_geometry(100, 11, 5, SMS)
    assert g.stage_bytes % 16 == 0
    assert g.stage_bytes >= g.tile_rows * 5 * 11 * 4 + 32
    stream, start, Wn = _edge_case("odd_window", 11)
    assert Wn * stream.shape[1] % 4 != 0
    want = tik.mailbox_gather_ref(torch.as_tensor(stream),
                                  torch.as_tensor(start), Wn).numpy()
    np.testing.assert_array_equal(_model_kernel(stream, start, Wn, 0), want)


@pytest.mark.parametrize("mis", [0, 4, 8, 12])
def test_tile_span_over_the_stage_takes_the_word_by_word_path(mis):
    P = 22
    g = tik.gather_geometry(10_240, P, WN, SMS)
    rows = 4_000
    # starts jumping past the contract's WN a row: the span exceeds the
    # stage
    jump = np.arange(g.tile_rows) * (WN + 8)
    assert tile_span(jump, rows, P, WN, g.stage_bytes, mis) is None
    # decreasing starts within a stage's span still take the bulk copy
    down = np.arange(g.tile_rows)[::-1] * 3
    assert tile_span(down, rows, P, WN, g.stage_bytes, mis) is not None
    # one start far from the others
    far = np.zeros(g.tile_rows, np.int64)
    far[-1] = rows - 1
    assert tile_span(far, rows, P, WN, g.stage_bytes, mis) is None


@pytest.mark.parametrize("P", [11, 22])
@pytest.mark.parametrize("mis", [0, 4, 8, 12])
def test_tile_span_reads_only_inside_the_tensor(P, mis):
    rows = 40
    total = rows * P * 4
    for starts in ([0, 1], [0], [rows - 1], [rows - WN], [-5, 3], [7, 2],
                   [rows + 9], [3, 3, 3]):
        glo, blo, bhi = tile_span(starts, rows, P, WN, 1 << 20, mis)
        # the stage starts on a 16-byte boundary of the absolute address
        assert (glo + mis) % 16 == 0 and glo > -16
        # the bulk copy: aligned, a multiple of 16, inside the tensor
        assert (blo - glo) % 16 == 0 and (blo + mis) % 16 == 0
        assert (bhi - blo) % 16 == 0 and 0 <= blo <= bhi <= total


# ---- a word-level model of the kernel's reads ------------------------

EDGES = ("residues", "h1", "ragged", "decreasing", "jumps", "negative",
         "clamp", "odd_window")
# (edge, offset of the stream's view in words, P)
EDGE_CASES = [(e, off, p) for e in EDGES for off in (0, 1, 3)
              for p in (11, 22)]
EDGE_IDS = [f"{e}-off{off}-p{p}" for e, off, p in EDGE_CASES]


def _edge_case(edge, P):
    """(stream [n + Wn, P], start [H], Wn) for one of the kernel's
    edges."""
    rng = np.random.default_rng(zlib.crc32(f"{edge}{P}".encode()))
    Wn = WN
    if edge == "residues":
        # starts stepping by 1, 2 and 3 rows: every residue of
        # start * P mod 4 (0 and 2 at P = 22)
        start = np.cumsum(rng.integers(1, 4, 300)) - 1
        n = int(start[-1]) + 1
    elif edge == "h1":
        start, n = np.array([3]), 10
    elif edge == "ragged":
        # 301 rows (not a multiple of a tile), the last 7 empty: their
        # starts are n
        cnt = np.minimum(rng.poisson(8, 301), Wn)
        cnt[-7:] = 0
        start = np.cumsum(cnt) - cnt
        n = int(cnt.sum())
    elif edge == "decreasing":
        start = np.sort(rng.integers(0, 900, 200))[::-1].copy()
        n = 900
    elif edge == "jumps":
        start = np.arange(150) * (Wn + 5)   # spans over a stage
        n = int(start[-1]) + 1
    elif edge == "negative":
        start = rng.integers(-40, 60, 130)
        n = 60
    elif edge == "clamp":
        n = 200
        start = np.sort(rng.integers(n - 8, n + Wn + 6, 90))
    else:   # odd_window: 55 words a row, scalar stores
        Wn = 5
        start = np.sort(rng.integers(0, 400, 170))
        n = 400
    stream = rng.integers(-2**31, 2**31 - 1, (n + Wn, P),
                          dtype=np.int64).astype(np.int32)
    return stream, start.astype(np.int32), Wn


def _model_kernel(stream, start, Wn, mis, sms=SMS):
    """The kernel's reads, word by word: gather_geometry's tiles,
    tile_span's bulk copy into a stage (the rest of the stage poisoned),
    then each window whole from the stage (the 16-byte path, two aligned
    16-byte reads of the stage for each store) or word by word from the
    stage or device memory."""
    rows, P = stream.shape
    H = start.shape[0]
    flat = stream.reshape(-1)
    g = tik.gather_geometry(H, P, Wn, sms)
    vec = Wn * P % 4 == 0
    out = np.full((H, Wn * P), -1, np.int32)
    for b in range(g.grid):
        hs = range(b * g.tile_rows, min(H, (b + 1) * g.tile_rows))
        span = tile_span(start[hs.start:hs.stop], rows, P, Wn,
                         g.stage_bytes, mis)
        glo, blo, bhi = span if span else (0, 0, 0)
        stage = np.full(g.stage_bytes // 4, 0x5A5A5A5A, np.int32)
        stage[(blo - glo) // 4:(bhi - glo) // 4] = flat[blo // 4:bhi // 4]
        for h in hs:
            s = min(max(int(start[h]), 0), rows - 1)
            b0 = 4 * s * P
            if vec and s + Wn <= rows and blo <= b0 \
                    and b0 + 4 * Wn * P <= bhi:
                o = (b0 - glo) // 4
                assert (o & ~3) + Wn * P + (4 if o & 3 else 0) <= stage.size
                out[h] = stage[o:o + Wn * P]
                continue
            for w in range(Wn * P):
                j, c = divmod(w, P)
                k = min(s + j, rows - 1) * P + c
                out[h, w] = (stage[(4 * k - glo) // 4]
                             if blo <= 4 * k < bhi else flat[k])
    return out.reshape(H, Wn, P)


@pytest.mark.parametrize("edge,offset,P", EDGE_CASES, ids=EDGE_IDS)
def test_kernel_read_model_matches_plain(edge, offset, P):
    stream, start, Wn = _edge_case(edge, P)
    want = tik.mailbox_gather_ref(torch.as_tensor(stream),
                                  torch.as_tensor(start), Wn).numpy()
    got = _model_kernel(stream, start, Wn, mis=4 * offset % 16)
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("edge,offset,P", EDGE_CASES, ids=EDGE_IDS)
def test_mailbox_gather_kernel_edges(edge, offset, P):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    stream, start, Wn = _edge_case(edge, P)
    big = torch.as_tensor(np.concatenate(
        [np.full(offset, 7, np.int32), stream.reshape(-1),
         np.full(5, 9, np.int32)]), device="cuda")
    s = big[offset:offset + stream.size].view(stream.shape)
    assert s.is_contiguous() and (s.data_ptr() - big.data_ptr()) == 4 * offset
    st = torch.as_tensor(start, device="cuda")
    before = tik.mailbox_gather.launches
    got = tik.mailbox_gather(s, st, Wn)
    assert tik.mailbox_gather.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, tik.mailbox_gather_ref(s, st, Wn))
