#!/usr/bin/env python3
"""Count what the PyTorch port's TCP bulk pass does on the relay cell,
on the CPU at a small host count: iterations and micro-steps per
window, PyTorch ops dispatched per iteration (a TorchDispatchMode
counting every non-view op inside each bulk call — on the GPU each is
one kernel launch), and the pass's host reads per iteration.

Every circuit of the one-vertex lossless relay moves in step, so the
counts per window at 10 hosts are the ones at 10,240; predictions for
chip_smoke.py phase 6 start from them.

    python tools/torch_relay_census.py            # 10 hosts, 2x5 hops
    python tools/torch_relay_census.py --hosts 20 --hop 2 \\
        --bytes 50000 --sim-s 10 --loss 0.01      # the lossy shape
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

GRAPH = """<graphml xmlns="http://graphml.graphdrawing.org/xmlns">
  <key attr.name="latency" attr.type="double" for="edge" id="lat" />
  <key attr.name="packetloss" attr.type="double" for="edge" id="pl" />
  <key attr.name="bandwidthup" attr.type="int" for="node" id="up" />
  <key attr.name="bandwidthdown" attr.type="int" for="node" id="dn" />
  <graph edgedefault="undirected">
    <node id="poi"><data key="up">102400</data><data key="dn">102400</data>
    </node>
    <edge source="poi" target="poi"><data key="lat">50.0</data>
      <data key="pl">%(loss)s</data></edge>
  </graph>
</graphml>"""

# ops that only reinterpret a tensor: no kernel on the device
VIEWS = {"view", "_unsafe_view", "expand", "slice", "select", "unsqueeze",
         "squeeze", "reshape", "alias", "t", "permute", "as_strided",
         "detach", "lift_fresh"}


class OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.split(".")[0] not in VIEWS:
            self.n += 1
        return func(*args, **(kwargs or {}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hosts", type=int, default=10)
    ap.add_argument("--hop", type=int, default=5)
    ap.add_argument("--bytes", type=int, default=100_000)
    ap.add_argument("--sim-s", type=float, default=4.0)
    ap.add_argument("--loss", type=float, default=0.0)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

    from shadow_tpu_torch import telemetry
    from shadow_tpu_torch.apps import relay
    from shadow_tpu_torch.core import simtime
    from shadow_tpu_torch.core.engine import resolve_sparse_lanes, run
    from shadow_tpu_torch.net.build import HostSpec, build
    from shadow_tpu_torch.net.state import NetConfig
    from shadow_tpu_torch.net.step import make_step_fn
    from shadow_tpu_torch.net.tcp_bulk import make_tcp_bulk_fn

    H, hop = args.hosts, args.hop
    cfg = NetConfig(num_hosts=H, seed=1,
                    end_time=int(args.sim_s * simtime.ONE_SECOND),
                    sockets_per_host=4, event_capacity=64,
                    outbox_capacity=64, router_ring=64)
    hosts = [HostSpec(name=f"n{i}", proc_start_time=simtime.ONE_SECOND)
             for i in range(H)]
    b = build(cfg, GRAPH % {"loss": args.loss}, hosts, device="cpu")
    circuits = [[c * hop + k for k in range(hop)] for c in range(H // hop)]
    sim = relay.setup(b.sim, circuits=circuits, total_bytes=args.bytes)
    sim = telemetry.attach(sim)

    fn = make_tcp_bulk_fn(b.cfg, relay.TCP_BULK)
    calls = []

    def bulk(sim, wend):
        count = OpCount()
        it0, r0 = fn.counters["iterations"], fn.counters["reads"]
        with count:
            out = fn(sim, wend)
        calls.append({"ops": count.n,
                      "iterations": fn.counters["iterations"] - it0,
                      "reads": fn.counters["reads"] - r0})
        return out

    sim, stats = run(sim, make_step_fn(b.cfg, (relay.handler,)),
                     end_time=b.cfg.end_time, min_jump=b.min_jump,
                     emit_capacity=b.cfg.emit_capacity,
                     lane_id=sim.net.lane_id, bulk_fn=bulk,
                     telem_fn=telemetry.make_telem_fn(),
                     sparse_lanes=resolve_sparse_lanes(b.cfg))
    st = stats.as_dict()
    iters = sum(c["iterations"] for c in calls)
    print(json.dumps({
        "stats": st,
        "iterations": iters,
        "iterations_per_window": iters / st["windows"],
        "micro_steps_per_window": st["micro_steps"] / st["windows"],
        "micro_steps_by_window":
            sim.telem.micro_steps[: int(sim.telem.count)].tolist(),
        "iterations_by_window": [c["iterations"] for c in calls],
        "ops_per_iteration": sum(c["ops"] for c in calls) / max(iters, 1),
        "reads_per_iteration": fn.counters["reads"] / max(iters, 1),
        "retx_segs": int(sim.tcp.retx_segs.sum()),
        "servers_done": sum(int(sim.app.rcvd[c[-1]]) == args.bytes
                            for c in circuits),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
