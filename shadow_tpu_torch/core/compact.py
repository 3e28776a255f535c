"""Active-lane compaction (PyTorch port of shadow_tpu/core/compact.py).

Gather the host rows that hold any event before the window end into a
compact [S]-lane view of the whole Sim, run the window fixpoint at
width S, and scatter the results back. The row rule is the
reference's: a leaf whose leading dimension is the host dimension is
gathered; the replicated lookup tables of NetState
(net.state.REPLICATED_FIELDS), the whole-sim subtrees (the telemetry
ring, the injection staging buffer, the lane and admission planes, the
flow ring and the causality advance plane) and scalars (the
specialization guard's two counters among them) pass through whole; the
lineage sub-rings gather by host row. The port's state has no pytree,
so the Sim's dataclasses are walked field by field, by name.

Bit-identity: the gathered indices are DISTINCT real rows (a stable
partition of the activity mask, actives first in ascending row order),
so per-row pop order, per-source sequence numbering and the scatter
back are exact. Padding lanes are inactive rows whose queues hold
nothing before wend: every handler is a masked batch update, and an
all-false mask is the identity.
"""

from __future__ import annotations

import dataclasses

import torch

from shadow_tpu_torch.core.events import is_static

I32 = torch.int32


def _replicated(names: tuple) -> bool:
    # Lazy import: core must not depend on net at module load.
    from shadow_tpu_torch.net.state import REPLICATED_FIELDS

    if names[0] in ("telem", "inject", "lanes", "flows", "admission"):
        return True
    # the causality advance plane's [W] leaves are window slots; its
    # [H, F] lineage sub-rings and [H] counters are host rows
    if names[0] == "causality" and names[-1].startswith("adv_"):
        return True
    return (len(names) > 1 and names[-2] == "net"
            and names[-1] in REPLICATED_FIELDS)


def _map(fn, obj, other=None, names=()):
    """Rebuild dataclass `obj` with fn(names, leaf, other_leaf) at every
    tensor leaf (None fields stay None)."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None or is_static(f):
            continue
        o = None if other is None else getattr(other, f.name)
        path = names + (f.name,)
        kw[f.name] = (_map(fn, v, o, path) if dataclasses.is_dataclass(v)
                      else fn(path, v, o))
    return dataclasses.replace(obj, **kw)


def gather_lanes(sim, idx: torch.Tensor):
    """Compact view of `sim` holding rows `idx` ([S] i32, distinct)."""
    rows = idx.long()

    def g(names, leaf, _):
        if _replicated(names) or leaf.ndim == 0:
            return leaf
        return leaf[rows]

    return _map(g, sim)


def scatter_lanes(full, compact, idx: torch.Tensor):
    """Write a compact Sim's rows back into the full-width `full`.
    Replicated and scalar leaves take the compact value (whole-sim
    state the fixpoint may have updated, e.g. overflow counters)."""
    rows = idx.long()

    def s(names, fleaf, cleaf):
        if _replicated(names) or fleaf.ndim == 0:
            return cleaf
        return fleaf.index_copy(0, rows, cleaf)

    return _map(s, full, compact)


def active_indices(active: torch.Tensor, s: int) -> torch.Tensor:
    """First `s` row indices with actives packed first ([S] i32,
    distinct, ascending within each group — a stable partition)."""
    order = torch.argsort((~active).to(torch.uint8), stable=True)
    return order[:s].to(I32)
