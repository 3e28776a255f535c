#!/usr/bin/env python3
"""Count the PyTorch ops a steady window of bench.py's default PHOLD
program dispatches in the port, with and without the capability trim
(compile/specialize.py), on the CPU at a small host count.

The program is chip_smoke.py phase 4's (load 8, capacities 48, in_ring
16, the bulk pass, the default sparse budget, the ring); the windows
counted are those after window 0 to 150 ms — the windows chip_smoke.py
phase 17 profiles on the card. A TorchDispatchMode counts every non-view
op (on the GPU each is one kernel launch) and groups the difference
between the two programs by op name. Each window's work is per host, so
the counts at 512 hosts are the ones at 10,240.

    python tools/torch_window_ops.py              # 512 hosts
    python tools/torch_window_ops.py --hosts 1024
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ONE_VERTEX = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="latency" attr.type="double" for="edge" id="lat" />
  <key attr.name="bandwidthup" attr.type="int" for="node" id="up" />
  <key attr.name="bandwidthdown" attr.type="int" for="node" id="dn" />
  <graph edgedefault="undirected">
    <node id="poi"><data key="up">102400</data><data key="dn">102400</data>
    </node>
    <edge source="poi" target="poi"><data key="lat">50.0</data></edge>
  </graph>
</graphml>"""

# ops that only reinterpret a tensor or read a scalar: no kernel
VIEWS = {"view", "_unsafe_view", "expand", "slice", "select", "unsqueeze",
         "squeeze", "reshape", "alias", "t", "permute", "as_strided",
         "detach", "lift_fresh", "transpose", "_local_scalar_dense"}


class OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.by = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if name not in VIEWS:
            self.by[name] = self.by.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hosts", type=int, default=512)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

    from shadow_tpu_torch import telemetry
    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.compile import specialize
    from shadow_tpu_torch.net.build import HostSpec, build, make_runner
    from shadow_tpu_torch.net.state import NetConfig

    H = args.hosts
    cfg = NetConfig(num_hosts=H, tcp=False, seed=2, in_ring=16,
                    end_time=120_000_000, event_capacity=48,
                    outbox_capacity=48, router_ring=48)
    hosts = [HostSpec(name=f"peer{i}", proc_start_time=0) for i in range(H)]
    b = build(cfg, ONE_VERTEX, hosts, device="cpu")
    b.sim = telemetry.attach(phold.setup(b.sim, load=8))
    out = {}
    for name, bb in (("untrimmed", b),
                     ("trimmed", specialize.apply(
                         b, (phold.handler,), app_bulk=phold.BULK))):
        def runner(end, bb=bb):
            return make_runner(bb, app_handlers=(phold.handler,),
                               end_time=end, app_bulk=phold.BULK,
                               device="cpu")

        sim0, _ = runner(20_000_000)(bb.sim)
        count = OpCount()
        with count:
            _, stats = runner(150_000_000)(sim0)
        w = int(stats.windows)
        out[name] = {"windows": w, "micro_steps": int(stats.micro_steps),
                     "ops_per_window": sum(count.by.values()) / w,
                     "by": {k: v / w for k, v in count.by.items()}}
    full, trim = out["untrimmed"]["by"], out["trimmed"]["by"]
    diff = {k: full.get(k, 0) - trim.get(k, 0) for k in set(full) | set(trim)}
    print(json.dumps({
        "hosts": H,
        "ops_per_window": {k: out[k]["ops_per_window"] for k in out},
        "windows": out["trimmed"]["windows"],
        "removed_by_the_trim": {k: v for k, v in sorted(
            diff.items(), key=lambda kv: -abs(kv[1])) if v}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
