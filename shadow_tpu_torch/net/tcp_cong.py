"""Pluggable congestion control (PyTorch port of
shadow_tpu/net/tcp_cong.py; ref: the tcp_cong.h hook vtable,
tcp_cong_reno.c).

An algorithm is a namespace of masked-update functions chosen at build
time by NetConfig.tcp_cong (one algorithm per run). The recovery
mechanics (dup-ack counting, recovery point, partial-ack retransmit,
window inflation) stay in tcp.py; the hooks decide cwnd/ssthresh
arithmetic only:

- reno: slow start cwnd+=1/ACK; CA +1 per cwnd of acked packets; loss
  ssthresh = cwnd/2+1, enter recovery at ssthresh+3 with dup-ack
  inflation.
- aimd: the same slow start/CA, but recovery entry deflates straight
  to ssthresh (no +3 or inflation credit).
- cubic: W(t) = C*(t-K)^3 + W_max with C=0.4, beta=0.7 in packet
  units, growth per ACK clamped to the acked-packet count; f32
  arithmetic as in the reference.

CUBIC's cube root: the reference's ``jnp.cbrt`` on the CPU is libm's
``powf(|x|, 1/3f)`` with the sign copied back, which is not correctly
rounded, and torch has no ``cbrt``. _cbrt_f32 evaluates that powf's
algorithm (ARM's optimized-routines powf as glibc ships it: log2 from a
16-entry table and a degree-5 polynomial, exp2 from a 32-entry table
and a cubic, all in float64, rounded once to float32) in torch float64
ops, each one IEEE-exact on every device, so K is the reference's bit
for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32

RENO = 0
AIMD = 1
CUBIC = 2

NAMES = {"reno": RENO, "aimd": AIMD, "cubic": CUBIC}

CUBIC_C = 0.4
CUBIC_BETA = 0.7

F = float.fromhex
# the exponent XLA's cbrt hands powf: 1/3 rounded to float32
_THIRD_F32 = float(np.float32(1.0 / 3.0))
# powf's log2 stage: x = 2^k z, z in [0x3f330000, 2 * 0x3f330000) as
# bits, log2(x) = k + logc[i] + poly(z * invc[i] - 1)
_LOG2_OFF = 0x3F330000
_LOG2_INVC = (
    F("0x1.661ec79f8f3bep+0"), F("0x1.571ed4aaf883dp+0"),
    F("0x1.49539f0f010b0p+0"), F("0x1.3c995b0b80385p+0"),
    F("0x1.30d190c8864a5p+0"), F("0x1.25e227b0b8ea0p+0"),
    F("0x1.1bb4a4a1a343fp+0"), F("0x1.12358f08ae5bap+0"),
    F("0x1.0953f419900a7p+0"), F("0x1.0000000000000p+0"),
    F("0x1.e608cfd9a47acp-1"), F("0x1.ca4b31f026aa0p-1"),
    F("0x1.b2036576afce6p-1"), F("0x1.9c2d163a1aa2dp-1"),
    F("0x1.886e6037841edp-1"), F("0x1.767dcf5534862p-1"),
)
_LOG2_LOGC = (
    F("-0x1.efec65b963019p-2"), F("-0x1.b0b6832d4fca4p-2"),
    F("-0x1.7418b0a1fb77bp-2"), F("-0x1.39de91a6dcf7bp-2"),
    F("-0x1.01d9bf3f2b631p-2"), F("-0x1.97c1d1b3b7af0p-3"),
    F("-0x1.2f9e393af3c9fp-3"), F("-0x1.960cbbf788d5cp-4"),
    F("-0x1.a6f9db6475fcep-5"), F("0x0.0p+0"),
    F("0x1.338ca9f24f53dp-4"), F("0x1.476a9543891bap-3"),
    F("0x1.e840b4ac4e4d2p-3"), F("0x1.40645f0c6651cp-2"),
    F("0x1.88e9c2c1b9ff8p-2"), F("0x1.ce0a44eb17bccp-2"),
)
_LOG2_POLY = (F("0x1.27616c9496e0bp-2"), F("-0x1.71969a075c67ap-2"),
              F("0x1.ec70a6ca7baddp-2"), F("-0x1.7154748bef6c8p-1"),
              F("0x1.71547652ab82bp+0"))
# powf's exp2 stage: 2^x = 2^(k/32) * 2^r, tab[k % 32] the bits of
# 2^((k % 32)/32) less (k % 32) << 47, r in [-1/64, 1/64]
_EXP2_SHIFT = F("0x1.8p+47")
_EXP2_TAB = (
    0x3ff0000000000000, 0x3fefd9b0d3158574, 0x3fefb5586cf9890f,
    0x3fef9301d0125b51, 0x3fef72b83c7d517b, 0x3fef54873168b9aa,
    0x3fef387a6e756238, 0x3fef1e9df51fdee1, 0x3fef06fe0a31b715,
    0x3feef1a7373aa9cb, 0x3feedea64c123422, 0x3feece086061892d,
    0x3feebfdad5362a27, 0x3feeb42b569d4f82, 0x3feeab07dd485429,
    0x3feea47eb03a5585, 0x3feea09e667f3bcd, 0x3fee9f75e8ec5f74,
    0x3feea11473eb0187, 0x3feea589994cce13, 0x3feeace5422aa0db,
    0x3feeb737b0cdc5e5, 0x3feec49182a3f090, 0x3feed503b23e255d,
    0x3feee89f995ad3ad, 0x3feeff76f2fb5e47, 0x3fef199bdd85529c,
    0x3fef3720dcef9069, 0x3fef5818dcfba487, 0x3fef7c97337b9b5f,
    0x3fefa4afa2a490da, 0x3fefd0765b6e4540,
)
_EXP2_POLY = (F("0x1.c6af84b912394p-5"), F("0x1.ebfce50fac4f3p-3"),
              F("0x1.62e42ff0c52d6p-1"))


def ssthresh_on_loss(alg: int, cwnd):
    """New ssthresh when loss is detected (fast-recovery entry and RTO
    timeout; reno: cwnd/2+1)."""
    if alg == CUBIC:
        return (cwnd.to(F32) * CUBIC_BETA).to(I32).clamp(min=2)
    return cwnd // 2 + 1


def cwnd_on_recovery_entry(alg: int, ssth):
    """cwnd on entering fast recovery (reno: ssthresh + 3 dup-acked
    segments)."""
    if alg == AIMD:
        return ssth
    return ssth + 3


@functools.lru_cache(maxsize=None)
def _powf_tables(device: torch.device):
    """The powf tables as tensors on `device` (built once per device and
    never written: a host-to-device copy waits for the stream)."""
    f64 = dict(dtype=torch.float64, device=device)
    return (torch.tensor(_LOG2_INVC, **f64), torch.tensor(_LOG2_LOGC, **f64),
            torch.tensor([t - (1 << 64) if t >> 63 else t for t in _EXP2_TAB],
                         dtype=torch.int64, device=device))


def _cbrt_f32(x):
    """libm's powf(x, 1/3f) for a float32 tensor of positive normal
    values (the module docstring says why), evaluated step for step in
    float64. Unsigned 32-bit words are carried in int64."""
    invc_t, logc_t, exp2_t = _powf_tables(x.device)
    ix = x.contiguous().view(torch.int32).to(I64) & 0xFFFFFFFF
    tmp = (ix - _LOG2_OFF) & 0xFFFFFFFF
    i = (tmp >> 19) & 15
    top = tmp & 0xFF800000
    iz = (ix - top) & 0xFFFFFFFF
    k = (top - ((top >> 31) << 32)) >> 23          # (int32_t)top >> 23
    z = (iz - ((iz >> 31) << 32)).to(I32).view(F32).double()
    r = z * invc_t[i] - 1.0
    y0 = logc_t[i] + k.double()
    a0, a1, a2, a3, a4 = _LOG2_POLY
    r2 = r * r
    y = r * a0 + a1
    p = r * a2 + a3
    r4 = r2 * r2
    q = r * a4 + y0
    q = p * r2 + q
    logx = y * r4 + q
    xd = logx * _THIRD_F32
    kd = xd + _EXP2_SHIFT
    ki = kd.view(I64) & 0x1FFFF                   # k, with xd in (0, 2^11)
    r = xd - (kd - _EXP2_SHIFT)
    s = (exp2_t[ki & 31] + (ki << 47)).view(torch.float64)
    c0, c1, c2 = _EXP2_POLY
    zz = r * c0 + c1
    r2 = r * r
    yy = r * c2 + 1.0
    yy = zz * r2 + yy
    return (yy * s).to(F32)


def _div(x, c: float):
    """x / c rounded once, on every device: CUDA turns a division by a
    Python scalar into a product with its reciprocal, which can differ
    from the quotient in the last bit."""
    return x / torch.full_like(x, c)


def ca_update(alg: int, mask, cwnd, ca_acc, n_acked, cub_wmax,
              cub_epoch_ms, now_ms):
    """Congestion-avoidance growth for ACKs covering n_acked packets.
    Returns (cwnd', ca_acc', cub_epoch_ms'); only `mask` lanes change.
    Reno/aimd: the accumulator form of +1 cwnd per full window acked;
    cubic chases its time-based curve."""
    if alg in (RENO, AIMD):
        ca1 = ca_acc + torch.where(mask, n_acked, 0)
        cwnd1 = cwnd
        for _ in range(4):
            inc = mask & (ca1 >= cwnd1)
            ca1 = torch.where(inc, ca1 - cwnd1, ca1)
            cwnd1 = torch.where(inc, cwnd1 + 1, cwnd1)
        return cwnd1, ca1, cub_epoch_ms

    # epoch starts at the first CA ack after a loss (epoch_ms < 0)
    fresh = mask & (cub_epoch_ms < 0)
    epoch = torch.where(fresh, now_ms, cub_epoch_ms)
    wmax = cub_wmax.clamp(min=2).to(F32)
    # K = cbrt(W_max * (1-beta) / C) seconds
    k_s = _cbrt_f32(_div(wmax * (1.0 - CUBIC_BETA), CUBIC_C))
    t_s = _div((now_ms - epoch).clamp(min=0).to(F32), 1000.0)
    d = t_s - k_s
    target = CUBIC_C * (d * d * d) + wmax
    target_i = target.clamp(min=2.0).to(I32)
    # chase the curve, at most one packet per acked packet, never shrink
    cwnd1 = torch.minimum(torch.maximum(target_i, cwnd), cwnd + n_acked)
    cwnd1 = torch.where(mask, cwnd1, cwnd)
    return cwnd1, ca_acc, torch.where(mask, epoch, cub_epoch_ms)


def on_loss_event(alg: int, mask, cwnd, cub_wmax, cub_epoch_ms):
    """Algorithm state updates shared by fast-recovery entry and RTO
    (cubic records W_max and resets its epoch). Returns (cub_wmax',
    cub_epoch_ms')."""
    if alg != CUBIC:
        return cub_wmax, cub_epoch_ms
    return (torch.where(mask, cwnd, cub_wmax),
            torch.where(mask, -1, cub_epoch_ms))
