"""Carry simulation state between shadow_tpu and this port.

State crosses as a flat dict of numpy arrays keyed by the reference's
flax field path, as ``jax.tree_util.keystr`` prints the paths of
``tree_flatten_with_path`` (".events.time", ".net.rng_keys",
".app.sock", ...). Optional fields left None contribute no key, as in
the reference. The reference's uint32 leaves (net.state.U32_FIELDS)
are int64 holding 32-bit values in the port and uint32 in the dict; its
uint64 leaves (the causality keys, U64_PATHS) are int64 with the same
bits in the port and uint64 in the dict. Static fields (the reference's
non-pytree fields: sample periods, the lanes' stall limit, the
specialization guard's watch flags) are not leaves; sim_from_numpy
takes them from a template Sim when given, else their defaults.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from shadow_tpu_torch.apps.bulk import BulkApp
from shadow_tpu_torch.apps.echo import EchoApp
from shadow_tpu_torch.apps.gossip import GossipApp, GossipTcpApp
from shadow_tpu_torch.apps.phold import PholdApp
from shadow_tpu_torch.apps.pingpong import PingPongApp
from shadow_tpu_torch.apps.randdump import RandDumpApp
from shadow_tpu_torch.apps.relay import RelayApp, RelayMuxApp
from shadow_tpu_torch.apps.tgen import TgenApp
from shadow_tpu_torch.compile.specialize import GuardState
from shadow_tpu_torch.core.events import EventQueue, Outbox, is_static
from shadow_tpu_torch.core.lanes import LaneAdmission, LaneHealth
from shadow_tpu_torch.device import resolve_device
from shadow_tpu_torch.inject.staging import InjectStaging
from shadow_tpu_torch.net.state import U32_FIELDS, NetState, Sim
from shadow_tpu_torch.net.tcp import TcpState
from shadow_tpu_torch.telemetry.causality import CausalityState, U64_PLANES
from shadow_tpu_torch.telemetry.flows import FlowRing
from shadow_tpu_torch.telemetry.ring import TelemetryRing

# The container classes each Sim field the port knows how to build may
# hold; the one whose field names match the leaves is taken (no two
# classes of one field accept the same set of leaves).
_SIM_FIELDS = {"events": (EventQueue,), "outbox": (Outbox,),
               "net": (NetState,),
               "app": (PholdApp, PingPongApp, RelayApp, RelayMuxApp,
                       GossipApp, GossipTcpApp, BulkApp, EchoApp,
                       RandDumpApp, TgenApp),
               "tcp": (TcpState,), "telem": (TelemetryRing,),
               "inject": (InjectStaging,), "lanes": (LaneHealth,),
               "admission": (LaneAdmission,), "flows": (FlowRing,),
               "causality": (CausalityState,), "guard": (GuardState,)}

# the leaves that are uint64 in the reference
U64_PATHS = frozenset(f".causality.{n}" for n in U64_PLANES)


def _to_numpy(path: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    if path.rsplit(".", 1)[-1] in U32_FIELDS:
        a = a.astype(np.uint32)
    elif path in U64_PATHS:
        a = a.view(np.uint64)
    return a


def sim_tensors(sim: Sim) -> dict[str, torch.Tensor]:
    """{flax field path: tensor} of a port Sim, in field order."""
    out: dict[str, torch.Tensor] = {}

    def walk(obj, prefix):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if v is None or is_static(f):
                continue
            path = f"{prefix}.{f.name}"
            if dataclasses.is_dataclass(v):
                walk(v, path)
            else:
                out[path] = v

    walk(sim, "")
    return out


def numpy_dtype(path: str, t: torch.Tensor) -> np.dtype:
    """The dtype `path`'s leaf has in the reference (and in
    sim_to_numpy)."""
    if path.rsplit(".", 1)[-1] in U32_FIELDS:
        return np.dtype(np.uint32)
    if path in U64_PATHS:
        return np.dtype(np.uint64)
    return torch.empty(0, dtype=t.dtype).numpy().dtype


def sim_to_numpy(sim: Sim) -> dict[str, np.ndarray]:
    """{flax field path: numpy leaf} of a port Sim."""
    return {path: _to_numpy(path, t)
            for path, t in sim_tensors(sim).items()}


def _leaf(name: str, a, device) -> torch.Tensor:
    a = np.asarray(a)
    if name in U32_FIELDS or a.dtype == np.uint32:
        a = a.astype(np.int64)
    elif a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.as_tensor(np.array(a, copy=True, order="C"), device=device)


def sim_from_numpy(leaves: dict, device=None, template=None) -> Sim:
    """A port Sim from {flax field path: numpy leaf} on `device` (None
    -> "cuda"; raises when CUDA is missing, as every entry point does).
    Static fields come from `template` (a port Sim) where it carries
    the same container, else from their defaults. Raises
    NotImplementedError for a Sim field the port does not implement."""
    device = resolve_device(device)
    groups: dict[str, dict] = {}
    for path, a in leaves.items():
        parts = path.lstrip(".").split(".")
        if len(parts) != 2:
            raise ValueError(f"unexpected leaf path {path!r}")
        groups.setdefault(parts[0], {})[parts[1]] = a
    kw = {}
    for name, fl in groups.items():
        cls = _container(name, fl.keys())
        fields = {k: _leaf(k, v, device) for k, v in fl.items()}
        tmpl = getattr(template, name, None)
        if isinstance(tmpl, cls):
            fields.update({f.name: getattr(tmpl, f.name)
                           for f in dataclasses.fields(cls)
                           if is_static(f)})
        kw[name] = cls(**fields)
    return Sim(**kw)


def _container(name: str, keys) -> type:
    """The port's class for Sim field `name` with leaves `keys` (its
    required fields present, every key one of its fields)."""
    keys = set(keys)
    for cls in _SIM_FIELDS.get(name, ()):
        fields = dataclasses.fields(cls)
        required = {f.name for f in fields
                    if f.default is dataclasses.MISSING}
        if required <= keys <= {f.name for f in fields}:
            return cls
    raise NotImplementedError(
        f"shadow_tpu_torch: Sim field {name!r} with leaves {sorted(keys)} "
        f"is not ported yet")
