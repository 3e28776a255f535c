"""Random-source determinism probe (PyTorch port of
shadow_tpu/apps/randdump.py) — the workload of the reference's
determinism fixture (ref: src/test/determinism/test_determinism.c:
each host reads /dev/random, rand() and the emulated clocks and prints
the values; two runs must produce byte-identical per-host output) and
the app behind the `testdeterminism` and `testrandom` plugins of
config/loader.py.

At PROC_START every host draws NSAMPLES values from its per-host
counter-based random stream (core/rng.py, bit-identical to the
reference's threefry draws) and records them, plus the virtual start
time, in app state.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from shadow_tpu_torch.core import rng
from shadow_tpu_torch.core.events import EventKind, _Replace
from shadow_tpu_torch.net.state import NetConfig

NSAMPLES = 8


@dataclass
class RandDumpApp(_Replace):
    samples: torch.Tensor   # [H, NSAMPLES] f32 recorded draws
    start_at: torch.Tensor  # [H] i64 virtual time of PROC_START (-1)


def setup(sim):
    H = sim.net.host_ip.shape[0]
    dev = sim.net.host_ip.device
    return sim.replace(app=RandDumpApp(
        samples=torch.zeros((H, NSAMPLES), dtype=torch.float32, device=dev),
        start_at=torch.full((H,), -1, dtype=torch.int64, device=dev),
    ))


def handler(cfg: NetConfig, sim, popped, buf):
    app = sim.app
    start = popped.valid & (popped.kind == EventKind.PROC_START) \
        & (app.start_at < 0)
    net = sim.net
    samples = app.samples.clone()
    ctr = net.rng_ctr
    for i in range(NSAMPLES):
        v, ctr2 = rng.uniform(net.rng_keys, ctr)
        samples[:, i] = torch.where(start, v, samples[:, i])
        ctr = torch.where(start, ctr2, ctr)
    net = net.replace(rng_ctr=ctr)
    app = app.replace(
        samples=samples,
        start_at=torch.where(start, popped.time, app.start_at),
    )
    return sim.replace(net=net, app=app), buf
