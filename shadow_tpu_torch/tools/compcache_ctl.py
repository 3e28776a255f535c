"""Operator console for the port's program store
(shadow_tpu_torch/compile/store.py; the port's tools/compcache_ctl.py)
— inspect, trim, and pre-populate the store that warm-start serving
loads from.

Subcommands:
  ls                    every entry, oldest-served first (key, size,
                        age, code/torch versions, whether THIS process
                        could serve it)
  stats                 one JSON summary (root, entry count, bytes,
                        code versions present)
  gc --max-bytes N      evict until the store fits in N bytes
                        (suffixes K/M/G ok). Entries from other code
                        versions go first — they can never be served
                        again — then least-recently-served.
  prewarm --config X    build the config's bundle (capacities
                        bucketed, exactly like a fleet scenario) and
                        build-or-confirm its dispatch program, so the
                        NEXT run of that shape starts dispatching
                        instead of building. --exact skips the
                        bucketing; --test uses the built-in example
                        config instead of a file.
  prewarm --sweep X     expand a sweep spec (sweep/plan.py) and
                        prewarm its distinct-program census: one
                        program per bucket + specialization variant,
                        printed with hit/compile counts — warm a cold
                        pool before `sweep run` launches.

The store root is $SHADOW_AOT_DIR, else <build root>/aot
(utils/compcache.py); --root overrides both. A prewarm builds for the
card unless --platform cpu asks for the CPU; without CUDA it fails and
names the device. Program keys hash torch, not jax, so they differ from
the reference's; the counts, the census and the affinity keys are the
reference's. Exit 0 = ok, 1 = error (gc/prewarm failures; ls/stats of
an empty or missing root are not errors — an empty store is a valid
store).

Usage: python -m shadow_tpu_torch.tools.compcache_ctl [--root DIR]
       [--platform cpu|gpu] {ls,stats,gc,prewarm} ...
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _parse_bytes(s: str) -> int:
    s = s.strip().upper()
    mult = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30}.get(s[-1:], 1)
    return int(float(s[:-1] if mult > 1 else s) * mult)


def _age(mtime: float) -> str:
    d = max(0.0, time.time() - mtime)
    for unit, sec in (("d", 86400), ("h", 3600), ("m", 60)):
        if d >= sec:
            return f"{d / sec:.1f}{unit}"
    return f"{d:.0f}s"


def _store(args):
    from shadow_tpu_torch.compile.store import ProgramStore, default_store

    return ProgramStore(args.root) if args.root else default_store()


def _device(args) -> str:
    from shadow_tpu_torch.device import resolve_device

    return resolve_device("cpu" if args.platform == "cpu" else None).type


def cmd_ls(args) -> int:
    import torch

    from shadow_tpu_torch.compile import buckets

    store = _store(args)
    entries = store.ls()
    code_now, torch_now = buckets.code_version(), torch.__version__
    print(f"# {store.root} — {len(entries)} entries")
    for m in entries:
        servable = (m.get("code") == code_now
                    and m.get("torch") == torch_now)
        # capability vector (compile/specialize.py): a trimmed
        # variant's sidecar records what was dropped — `full` means
        # the general program
        spec = m.get("specialization") or {}
        tag = spec.get("key_extra") or ("full" if not spec.get("dropped")
                                        else "-".join(spec["dropped"]))
        print(f"{m.get('key', '?'):20s} {int(m.get('nbytes', 0)):>12d}B "
              f"{_age(float(m.get('mtime', 0.0))):>7s} "
              f"code={str(m.get('code'))[:8]} torch={m.get('torch')} "
              f"spec={tag} "
              f"{'servable' if servable else 'STALE'}")
    return 0


def cmd_stats(args) -> int:
    print(json.dumps(_store(args).stats(), indent=1, sort_keys=True))
    return 0


def cmd_gc(args) -> int:
    out = _store(args).gc(_parse_bytes(args.max_bytes))
    print(json.dumps(out, indent=1))
    return 0


def sweep_census(path: str):
    """(spec, the points' job specs, the census, {affinity key: the
    first point's spec}) of a sweep spec file."""
    from shadow_tpu_torch.fleet.affinity import affinity_key
    from shadow_tpu_torch.sweep import plan as plan_mod

    spec = plan_mod.SweepSpec.from_file(path)
    points = plan_mod.expand(spec)
    specs = [spec.point_spec(p, 0) for p in points]
    census = plan_mod.plan_census(specs)
    reps = {}
    for s in specs:
        reps.setdefault(affinity_key(s), s)
    return spec, specs, census, reps


def cmd_prewarm_sweep(args) -> int:
    """Warm a cold pool for a whole sweep: expand the plan, compute
    its distinct-program census (sweep/plan.py — bucket-affinity keys
    + predicted specialization variants, no build involved), then
    build-or-confirm ONE representative program per distinct key
    through the same scenario build path the workers take."""
    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.compile import serve
    from shadow_tpu_torch.fleet import scenario

    device = _device(args)
    spec, specs, census, reps = sweep_census(args.sweep)
    print(f"# sweep {spec.id}: {len(specs)} points, "
          f"{census['distinct']} distinct program(s)")
    store = _store(args) if args.root else None
    keys, hits = [], 0
    for ak in sorted(reps):
        s = reps[ak]
        caps = {"event_capacity": s.event_capacity,
                "outbox_capacity": s.outbox_capacity,
                "router_ring": s.router_ring}
        b = scenario._build_scenario(s, caps, device=device)
        info = serve.prewarm(b, (phold.handler,), store=store,
                             log=lambda m: print(m), device=device)
        ok = bool(info.get("hit") or info.get("stored"))
        hits += bool(info.get("hit"))
        keys.append({"affinity_key": ak, "key": info.get("key"),
                     "hit": bool(info.get("hit")), "ok": ok,
                     "count": census["programs"][ak]["count"],
                     "specialization":
                     census["programs"][ak]["specialization"]})
    out = {"sweep": spec.id, "points": len(specs),
           "distinct": census["distinct"], "hits": hits,
           "compiled": len(keys) - hits, "keys": keys}
    print(json.dumps(out, indent=1, sort_keys=True, default=str))
    return 0 if all(k["ok"] for k in keys) else 1


def cmd_prewarm(args) -> int:
    if getattr(args, "sweep", None):
        return cmd_prewarm_sweep(args)
    from shadow_tpu_torch.compile import serve
    from shadow_tpu_torch.compile.buckets import CAPACITY_KEYS, quantize_pow2
    from shadow_tpu_torch.config.examples import example_config
    from shadow_tpu_torch.config.loader import load
    from shadow_tpu_torch.config.xmlconfig import parse_config

    if args.test:
        text, base = example_config(), None
    elif args.config:
        with open(args.config) as f:
            text = f.read()
        base = os.path.dirname(os.path.abspath(args.config))
    else:
        print("error: prewarm needs --config PATH, --test, or "
              "--sweep SPEC", file=sys.stderr)
        return 1

    device = _device(args)
    loaded = load(parse_config(text), seed=args.seed, base_dir=base,
                  device=device)
    b = loaded.bundle
    if not args.exact:
        # quantize AFTER the load so plugin capacity hints are already
        # merged, then rebuild — the same bucket lattice a fleet
        # scenario lands on (fleet/scenario.py), so this prewarms the
        # entry those jobs will actually load
        grown = {k: quantize_pow2(getattr(b.cfg, k))
                 for k in CAPACITY_KEYS
                 if quantize_pow2(getattr(b.cfg, k)) != getattr(b.cfg, k)}
        if grown:
            print(f"bucketing capacities: {grown}")
            b = b.rebuild(grown)
    if args.specialize != "off":
        # prewarm the variant a fleet run of this config will actually
        # serve: the capability-trimmed program when the build proves
        # trims sound, keyed by its own store entry
        from shadow_tpu_torch.compile import specialize

        b = specialize.apply(b, loaded.handlers,
                             app_bulk=getattr(b, "app_bulk", None),
                             mode=args.specialize)
        if b.caps is not None and b.caps.dropped():
            print(f"specializing: trimmed "
                  f"{','.join(b.caps.dropped())} "
                  f"(key extra {b.caps.key_extra()!r})")
    store = _store(args) if args.root else None
    info = serve.prewarm(b, loaded.handlers, store=store,
                         log=lambda m: print(m), device=device)
    print(json.dumps(info, indent=1, sort_keys=True, default=str))
    return 0 if info.get("hit") or info.get("stored") else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="compcache_ctl",
        description="inspect / trim / pre-populate the program store")
    ap.add_argument("--root", help="store root (default: "
                    "$SHADOW_AOT_DIR or <build root>/aot)")
    ap.add_argument("--platform", default=None, choices=("cpu", "gpu"),
                    help="prewarm for the CPU ('cpu'); unset or 'gpu' "
                         "is the card")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("ls", help="list entries, oldest-served first")
    sub.add_parser("stats", help="JSON summary")
    g = sub.add_parser("gc", help="evict down to a byte budget")
    g.add_argument("--max-bytes", required=True,
                   help="target size (suffixes K/M/G ok)")
    p = sub.add_parser("prewarm",
                       help="build a config's program into the store")
    p.add_argument("--config", help="shadow config XML path")
    p.add_argument("--test", action="store_true",
                   help="use the built-in example config")
    p.add_argument("--sweep",
                   help="sweep spec JSON (sweep/plan.py): prewarm "
                        "the plan's distinct-program census — one "
                        "program per bucket+specialization variant, "
                        "however many points share it")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--exact", action="store_true",
                   help="skip capacity bucketing (bespoke shapes)")
    p.add_argument("--specialize", choices=("auto", "off"),
                   default="auto",
                   help="prewarm the capability-trimmed variant the "
                        "fleet will serve (auto, default) or the full "
                        "general program (off)")
    args = ap.parse_args(argv)
    return {"ls": cmd_ls, "stats": cmd_stats, "gc": cmd_gc,
            "prewarm": cmd_prewarm}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
