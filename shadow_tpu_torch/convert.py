"""Carry simulation state between shadow_tpu and this port.

State crosses as a flat dict of numpy arrays keyed by the reference's
flax field path, as ``jax.tree_util.keystr`` prints the paths of
``tree_flatten_with_path`` (".events.time", ".net.rng_keys",
".app.sock", ...). Optional fields left None contribute no key, as in
the reference. The reference's uint32 leaves (net.state.U32_FIELDS)
are int64 holding 32-bit values in the port and uint32 in the dict.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from shadow_tpu_torch.apps.phold import PholdApp
from shadow_tpu_torch.core.events import EventQueue, Outbox
from shadow_tpu_torch.net.state import U32_FIELDS, NetState, Sim

# The container class of each Sim field the port knows how to build.
_SIM_FIELDS = {"events": EventQueue, "outbox": Outbox, "net": NetState,
               "app": PholdApp}


def _to_numpy(name: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    if name in U32_FIELDS:
        a = a.astype(np.uint32)
    return a


def sim_to_numpy(sim: Sim) -> dict[str, np.ndarray]:
    """{flax field path: numpy leaf} of a port Sim."""
    out: dict[str, np.ndarray] = {}

    def walk(obj, prefix):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if v is None:
                continue
            path = f"{prefix}.{f.name}"
            if dataclasses.is_dataclass(v):
                walk(v, path)
            else:
                out[path] = _to_numpy(f.name, v)

    walk(sim, "")
    return out


def _leaf(name: str, a, device) -> torch.Tensor:
    a = np.asarray(a)
    if name in U32_FIELDS or a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.as_tensor(np.array(a, copy=True, order="C"), device=device)


def sim_from_numpy(leaves: dict, device=None) -> Sim:
    """A port Sim from {flax field path: numpy leaf}. Raises
    NotImplementedError for a Sim field the port does not implement."""
    groups: dict[str, dict] = {}
    for path, a in leaves.items():
        parts = path.lstrip(".").split(".")
        if len(parts) != 2:
            raise ValueError(f"unexpected leaf path {path!r}")
        groups.setdefault(parts[0], {})[parts[1]] = a
    kw = {}
    for name, fl in groups.items():
        cls = _SIM_FIELDS.get(name)
        if cls is None:
            raise NotImplementedError(
                f"shadow_tpu_torch: Sim field {name!r} is not ported yet")
        kw[name] = cls(**{k: _leaf(k, v, device) for k, v in fl.items()})
    return Sim(**kw)
