"""Masked per-lane ring-buffer helpers for [H,S,B] socket rings and
[H,R] router rings (PyTorch port of shadow_tpu/net/rings.py). Each
micro-step touches at most one (host, slot) per lane, so every
operation is an [H]-vectorized gather or a one-hot masked select."""

from __future__ import annotations

import torch

from shadow_tpu_torch.core.events import _onehot, _put, as_tensor

I32 = torch.int32


def gather_hs(arr, slot):
    """arr[H,S] -> [H] value at (lane, slot); slot clipped for safety
    (callers mask invalid lanes)."""
    H = arr.shape[0]
    lane = torch.arange(H, device=arr.device)
    return arr[lane, slot.clamp(0, arr.shape[1] - 1).to(torch.int64)]


def set_hs(arr, mask, slot, value):
    """arr[H,S] masked write at (lane, slot) via one-hot select."""
    return _put(arr, _onehot(mask, slot, arr.shape[1]), value)


def set_ring(arr, mask, slot, pos, value):
    """arr[H,S,B] (or [H,S,B,W] with value [H,W]) masked write at
    (lane, slot, pos) via one-hot select."""
    H, S, B = arr.shape[:3]
    dev = arr.device
    sel = (mask[:, None, None]
           & (torch.arange(S, device=dev)[None, :, None] == slot[:, None, None])
           & (torch.arange(B, device=dev)[None, None, :] == pos[:, None, None]))
    value = as_tensor(value, arr.dtype, dev)
    if arr.ndim == 4:
        return torch.where(sel[..., None], value[:, None, None, :], arr)
    v = value[:, None, None] if value.ndim == 1 else value
    return torch.where(sel, v, arr)


def set_row(arr, mask, pos, value):
    """arr[H,R] (or [H,R,W] with value [H,W]) masked write at
    (lane, pos) via one-hot select."""
    return _put(arr, _onehot(mask, pos, arr.shape[1]), value)


def ring_push_at(head, count, capacity: int, mask, slot):
    """Write position for pushing one element into ring (lane, slot).
    Returns (ok[H], pos[H]) with pos=capacity for dropped lanes."""
    c = gather_hs(count, slot)
    h = gather_hs(head, slot)
    ok = mask & (c < capacity)
    pos = torch.where(ok, (h + c) % capacity, capacity)
    return ok, pos


def ring_advance_push(head, count, mask, slot, ok):
    """Commit a push: count += 1 where ok."""
    c = gather_hs(count, slot)
    return head, set_hs(count, mask & ok, slot, c + 1)


def ring_peek_at(head, count, mask, slot, capacity: int):
    """Position of the ring head element; pos=capacity when empty or
    masked out."""
    c = gather_hs(count, slot)
    h = gather_hs(head, slot)
    ok = mask & (c > 0)
    return ok, torch.where(ok, h % capacity, capacity)


def ring_advance_pop(head, count, mask, slot, capacity: int):
    """Commit a pop: head = (head+1)%capacity, count -= 1."""
    c = gather_hs(count, slot)
    h = gather_hs(head, slot)
    ok = mask & (c > 0)
    head = set_hs(head, ok, slot, (h + 1) % capacity)
    count = set_hs(count, ok, slot, c - 1)
    return head, count
