"""Telemetry export: Chrome-trace JSON, Prometheus text, run manifest
(PyTorch port of shadow_tpu/telemetry/export.py: host code over the
harvested records, device counters read through the host).

Three host-side views over the harvested ring + phase timers:

- chrome_trace(): the Trace Event Format JSON that chrome://tracing
  and Perfetto load. One "sim-time" process track of per-window
  complete ("X") events whose ts/dur are *simulated* microseconds,
  plus one wall-time track per shard carrying the phase-timer spans
  (trace/compile vs device execute vs harvest/export overhead).
- prometheus_text(): the text exposition format, final counter values
  as gauges/counters — scrape-file style for dashboards.
- run_manifest(): the run's identity + outcome in one JSON object:
  config hash, seed, shard count, fault-plan digest, final counters,
  health verdict, telemetry summary, and the lanes, admission, flows
  and causality blocks of the runs that carry them. The CLI writes it
  next to the trace.

The elastic mesh transitions (ROADMAP.md Queue 1 item 9) are not
ported: chrome_trace refuses them by name.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json


def _us(ns: int) -> float:
    return ns / 1000.0


def chrome_trace(records, timers=None, num_shards: int = 1,
                 flow_records=None, adv_records=None,
                 chains=None, elastic=None) -> dict:
    """Build a Trace Event Format object (dict; json.dump it).

    Sim-time track: pid 0, one "X" event per window record, ts/dur in
    simulated µs (the format's native unit), counters in args.
    Wall-time tracks: pid 1, tid = shard id, phase spans in wall µs
    from the timer origin. Both Chrome and Perfetto accept mixed
    timelines as separate process groups.

    `flow_records` (harvested flows.FlowRecord list) adds pid 2: one
    thread per isolation lane, one "X" span per sampled packet from its
    staging window to its delivery timestamp. `adv_records` / `chains`
    (harvested causality.AdvanceRecord list and critical_chains()
    dicts) add pid 3, the critical-path group: one thread per chain
    drawing its events, plus "C" counter events of the window binding
    cause and jump utilization. The mesh-transition markers
    (`elastic`, ROADMAP.md Queue 1 item 9) raise when given."""
    if elastic:
        raise NotImplementedError(
            "shadow_tpu_torch: telemetry export of elastic mesh "
            "transitions is not ported yet (ROADMAP.md Queue 1 item 9)")
    events = [{"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
               "args": {"name": "sim-time (simulated µs)"}},
              {"ph": "M", "name": "thread_name", "pid": 0, "tid": 0,
               "args": {"name": "windows"}}]
    for r in records:
        events.append({
            "ph": "X", "pid": 0, "tid": 0,
            "name": f"window {r.index}",
            "ts": _us(r.wstart),
            # zero-duration complete events render invisibly; clamp at
            # 1 ns worth of µs so degenerate windows stay clickable
            "dur": max(_us(r.wend - r.wstart), 0.001),
            "args": {
                "events": r.events, "micro_steps": r.micro_steps,
                "routed_local": r.routed_local,
                "routed_cross": r.routed_cross,
                "drops": r.drops, "retx": r.retx,
                "queue_occupancy": {
                    "min": r.qocc_min, "max": r.qocc_max,
                    "sum": r.qocc_sum},
                "active_lanes": r.active_lanes,
                "fastpath": r.fastpath,
                "injected": r.injected,
                "inj_dropped": r.inj_dropped,
                "inj_deferred": r.inj_deferred,
            },
        })
    if timers is not None:
        events.append({"ph": "M", "name": "process_name", "pid": 1,
                       "tid": 0, "args": {"name": "wall-time (µs)"}})
        for s in range(max(num_shards, 1)):
            events.append({"ph": "M", "name": "thread_name", "pid": 1,
                           "tid": s, "args": {"name": f"shard {s}"}})
        for p in timers.phases:
            shards = ([p.shard] if p.shard is not None
                      else range(max(num_shards, 1)))
            for s in shards:
                events.append({
                    "ph": "X", "pid": 1, "tid": s, "name": p.name,
                    "ts": p.start_s * 1e6, "dur": p.dur_s * 1e6,
                    "args": {},
                })
    if flow_records:
        events.append({"ph": "M", "name": "process_name", "pid": 2,
                       "tid": 0,
                       "args": {"name": "flows per-lane (simulated µs)"}})
        for lane in sorted({r.lane for r in flow_records}):
            events.append({"ph": "M", "name": "thread_name", "pid": 2,
                           "tid": lane,
                           "args": {"name": f"lane {lane}"}})
        for r in flow_records:
            events.append({
                "ph": "X", "pid": 2, "tid": r.lane,
                "name": f"{r.src}->{r.dst} k{r.kind}",
                "ts": _us(r.t_enq),
                "dur": max(_us(r.t_deliver - r.t_enq), 0.001),
                "args": {
                    "src": r.src, "dst": r.dst, "kind": r.kind,
                    "flags": r.flags,
                    "latency_ns": r.t_deliver - r.t_enq,
                    "t_route": r.t_route,
                },
            })
    if adv_records or chains:
        events.append({"ph": "M", "name": "process_name", "pid": 3,
                       "tid": 0,
                       "args": {"name":
                                "critical path (simulated µs)"}})
        for rank, ch in enumerate(chains or ()):
            events.append({"ph": "M", "name": "thread_name", "pid": 3,
                           "tid": rank,
                           "args": {"name": f"chain {rank} "
                                            f"(len {ch['length']})"}})
            for ev in ch.get("events", ()):
                events.append({
                    "ph": "X", "pid": 3, "tid": rank,
                    "name": f"h{ev['host']}->h{ev['dst']} k{ev['kind']}",
                    "ts": _us(ev["t_emit"]),
                    "dur": max(_us(ev["t_due"] - ev["t_emit"]), 0.001),
                    "args": {"depth": ev["depth"], "key": ev["key"]},
                })
        for r in (adv_records or ()):
            util = r.utilization_pct
            args = {"cause": r.cause}
            if util is not None:
                args["jump_utilization_pct"] = util
            events.append({
                "ph": "C", "pid": 3, "tid": 0,
                "name": "window_advance",
                "ts": _us(r.wstart),
                "args": args,
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def prometheus_text(counters: dict, prefix: str = "shadow_tpu") -> str:
    """Flatten a {name: number} dict into Prometheus text exposition
    lines. Nested dicts become labeled samples
    (name{key="sub"} value)."""
    lines = []
    for name, val in sorted(counters.items()):
        metric = f"{prefix}_{name}"
        if isinstance(val, dict):
            lines.append(f"# TYPE {metric} gauge")
            for k, v in sorted(val.items()):
                lines.append(f'{metric}{{key="{k}"}} {_num(v)}')
        else:
            lines.append(f"# TYPE {metric} gauge")
            lines.append(f"{metric} {_num(val)}")
    return "\n".join(lines) + "\n"


def _num(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float):
        return repr(v)
    return str(int(v))


def config_hash(cfg) -> str:
    """sha256 of the canonicalized NetConfig — two runs with the same
    hash ran the same simulation parameters."""
    d = dataclasses.asdict(cfg)
    blob = json.dumps(d, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()


def fault_plan_digest(plan) -> str | None:
    """sha256 over the compiled plan's record columns (None = no plan
    installed)."""
    if plan is None:
        return None
    cols = [plan.t_ns, plan.kind, plan.a, plan.b, plan.value]
    blob = json.dumps([[int(x) for x in c] for c in cols])
    return hashlib.sha256(blob.encode()).hexdigest()


def final_counters(sim, stats=None) -> dict:
    """Final device counter totals for the manifest / metrics file
    (one host read)."""
    import torch

    from shadow_tpu_torch.net.state import drop_total

    net = sim.net
    I64 = torch.int64
    vals = {
        "drops_total": drop_total(net).sum(dtype=I64),
        # broken out so the lint can pin a loss-trimmed program's
        # reliability drops at exactly zero
        "drops_reliability_total": net.ctr_drop_reliability.sum(dtype=I64),
        "tx_packets_total": net.ctr_tx_packets.sum(dtype=I64),
        "rx_packets_total": net.ctr_rx_packets.sum(dtype=I64),
        "tx_bytes_total": net.ctr_tx_bytes.sum(dtype=I64),
        "rx_bytes_total": net.ctr_rx_bytes.sum(dtype=I64),
        "retx_bytes_total": net.ctr_tx_retx_bytes.sum(dtype=I64),
        "events_overflow": sim.events.overflow,
        "outbox_overflow": sim.outbox.overflow,
        "rq_overflow": net.rq_overflow,
        "route_elided": sim.outbox.route_elided,
    }
    if getattr(sim, "tcp", None) is not None:
        vals["retx_segments_total"] = sim.tcp.retx_segs.sum(dtype=I64)
    if stats is not None:
        for k in ("events_processed", "micro_steps", "windows",
                  "fastpath_hit", "fastpath_miss"):
            vals[k] = getattr(stats, k)
    flat = torch.stack([torch.as_tensor(v).to(I64).reshape(())
                        .to(net.host_ip.device) for v in vals.values()])
    return dict(zip(vals, (int(v) for v in flat.tolist())))


def lanes_manifest_block(health, incidents=()) -> dict | None:
    """Build the manifest's top-level "lanes" block for a lane-isolated
    (packed) run: per-lane counters from the health gather, with each
    quarantined lane carrying its salvage pointer + requeue context
    from the supervisor's LaneIncident records. None when the run
    carried no lane isolation. tools/telemetry_lint.py checks that the
    per-lane overflow counts sum to the run totals and that every
    quarantined lane names its salvage artifact."""
    if health is None or not getattr(health, "lanes_total", 0):
        return None
    inc_dicts = [i if isinstance(i, dict) else i.as_dict()
                 for i in (incidents or ())]
    by_lane = {d["lane"]: d for d in inc_dicts}
    per = []
    for d in health.lanes:
        d = dict(d)
        inc = by_lane.get(d["lane"])
        if inc is not None:
            d["salvage"] = inc.get("salvage")
            d["requeue"] = {"regrow": dict(inc.get("regrow") or {}),
                            "salvaged_from": inc.get("salvaged_from")}
        per.append(d)
    out = {
        "replicas": int(health.lanes_total),
        "quarantined": [int(r) for r in health.lanes_quarantined],
        "contained": bool(health.lane_contained),
        "per_lane": per,
    }
    if inc_dicts:
        out["incidents"] = inc_dicts
    return out


def admission_manifest_block(health) -> dict | None:
    """Build the manifest's top-level "admission" block for a
    STANDALONE resident run (`shadow-tpu --resident`): every lane is
    admitted at boot and holds an open lease, so the lease-count
    conservation the lint checks (admitted == completed + evicted +
    quarantined + resident) folds directly from the device planes —
    there is no host-side lease table in this mode. Fleet-managed
    resident programs build their block from fleet/admission.py's
    LeaseTable instead. None when the run carried no admission
    planes."""
    if health is None or not getattr(health, "resident", False):
        return None
    per = [dict(d) for d in health.admission]
    quarantined = {int(r) for r in
                   getattr(health, "lanes_quarantined", ())}
    completed = sum(1 for d in per
                    if d.get("completed") and d["lane"] not in quarantined)
    return {
        "admitted": len(per),
        "completed": completed,
        "evicted": 0,
        "quarantined": len(quarantined),
        "resident": len(per) - completed - len(quarantined),
        "deferred": 0,
        "per_lane": per,
    }


def run_manifest(*, cfg, seed: int, shards: int, sim, stats=None,
                 health=None, fault_plan=None, harvester=None,
                 timers=None, wall_seconds: float | None = None,
                 compile_s: float | None = None,
                 compile_fresh: bool | None = None,
                 conformance: dict | None = None,
                 run_id: str | None = None,
                 resume_of: str | None = None,
                 escalations=None,
                 preempted: bool | None = None,
                 dispatch: dict | None = None,
                 injection: dict | None = None,
                 lanes: dict | None = None,
                 compile_info: dict | None = None,
                 flows: dict | None = None,
                 admission: dict | None = None,
                 profile: dict | None = None,
                 causality: dict | None = None,
                 specialization: dict | None = None,
                 elastic: dict | None = None) -> dict:
    """The run's identity + outcome (see module docstring).
    `compile_s` is the wall time of the first (compiling) device call;
    `compile_fresh` says whether it actually compiled (True) or was
    served from the persistent compilation cache (False). `run_id` /
    `resume_of` chain preemption-split runs (--resume); `escalations`
    lists the supervisor's healed capacity trips (Escalation records
    or their dicts). `dispatch` records the chunked window loop's
    shape: {"windows_per_dispatch": K, "dispatches": N, "windows":
    [per-dispatch executed-window counts], "adaptive_jump_mean_ns":
    mean harvested window span} — the "windows" list, when present,
    must sum to counters.windows (tools/telemetry_lint.py)."""
    man = {
        "config_hash": config_hash(cfg),
        "seed": int(seed),
        "shards": int(shards),
        "num_hosts": int(cfg.num_hosts),
        "end_time_ns": int(cfg.end_time),
        "fault_plan_digest": fault_plan_digest(fault_plan),
        "counters": final_counters(sim, stats),
    }
    if wall_seconds is not None:
        man["wall_seconds"] = round(float(wall_seconds), 3)
    if compile_s is not None:
        man["compile_s"] = round(float(compile_s), 3)
    if compile_fresh is not None:
        man["compile_fresh"] = bool(compile_fresh)
    if health is not None:
        man["health"] = health.failure_report()
        man["health"]["verdict"] = "fatal" if health.fatal else (
            "warnings" if health.diagnostics() else "clean")
    tel = {"windows_recorded": 0, "records_lost": 0}
    if harvester is not None:
        tel = harvester.summary()
    man["telemetry"] = tel
    if timers is not None:
        man["wall_phases_s"] = {
            k: round(v, 6) for k, v in timers.totals().items()}
    if conformance is not None:
        # dual-mode verdicts (hostrun/runner.py:conformance_block):
        # which workloads ran both backends, and whether they agreed
        man["conformance"] = conformance
    if run_id is not None:
        man["run_id"] = run_id
    if resume_of is not None:
        man["resume_of"] = resume_of
    if escalations:
        man["escalations"] = [
            e if isinstance(e, dict) else e.as_dict()
            for e in escalations]
    if preempted is not None:
        man["preempted"] = bool(preempted)
    if dispatch is not None:
        man["dispatch"] = dispatch
    if injection is not None:
        # open-system event injection (inject/__init__.py
        # manifest_block): device latches + feeder accounting; the
        # lint reconciles injected+dropped+deferred == trace_events
        man["injection"] = injection
    if lanes is not None:
        # lane-isolated packed run (lanes_manifest_block): per-lane
        # counters, quarantine verdicts, salvage/requeue pointers
        man["lanes"] = lanes
    if compile_info is not None:
        # warm-program serving (compile/): program key, bucket plan,
        # hit/miss, and the compile-path timing (load_s on a hit,
        # lower_s+compile_s on a miss). tools/telemetry_lint.py
        # checks key format, hit/timing consistency, and that every
        # bucketed capacity >= its requested value
        man["compile"] = dict(compile_info)
    if flows is not None:
        # the flow flight-recorder (flows.flows_manifest_block):
        # sampling accounting, latency histograms, per-lane
        # percentiles, the traffic matrix
        man["flows"] = flows
    if admission is not None:
        # resident program (admission_manifest_block): lease-count
        # conservation and the per-lane lease planes
        man["admission"] = admission
    if profile is not None:
        # profiler capture: where the trace artifact landed, so the
        # manifest is the one pointer from a run to every artifact it
        # produced
        man["profile"] = dict(profile)
    if causality is not None:
        # causal critical-path profiling
        # (causality.causality_manifest_block): lineage accounting,
        # critical chains, the binding-cause histogram, jump
        # utilization
        man["causality"] = causality
    if specialization is not None:
        # compile-time capability trimming (compile/specialize.py
        # specialization_block): the derived capability vector, the
        # dropped-capability list baked into this program, and the
        # guard-latch counters proving no dead capability fired.
        # tools/telemetry_lint.py checks vector/dropped consistency,
        # that dropped capabilities' drop counters stayed zero, and
        # that a tripped guard was reported fatal
        man["specialization"] = specialization
    if elastic is not None:
        # elastic degraded-mesh recovery (parallel/elastic.py +
        # faults/supervisor.py _elastic_block): policy, initial/final
        # shard widths, every device loss and divergence record, the
        # ladder steps taken and the mesh transitions among them.
        # tools/telemetry_lint.py checks transition monotonicity
        # (pow2-down or serial), losses + divergences == ladder steps,
        # and the verified-window stamps against the checkpoints
        man["elastic"] = elastic
    return man


def metrics_from_manifest(man: dict) -> dict:
    """Flatten the manifest into the {name: number-or-dict} shape
    prometheus_text() takes."""
    out = dict(man["counters"])
    out["seed"] = man["seed"]
    out["shards"] = man["shards"]
    out["num_hosts"] = man["num_hosts"]
    tel = man.get("telemetry", {})
    out["telemetry_windows_recorded"] = tel.get("windows_recorded", 0)
    out["telemetry_records_lost"] = tel.get("records_lost", 0)
    if "events_per_window" in tel:
        out["events_per_window"] = tel["events_per_window"]
    if "health" in man:
        out["health_fatal"] = bool(man["health"]["fatal"])
    if "compile_s" in man:
        out["compile_seconds"] = man["compile_s"]
        if "compile_fresh" in man:
            out["compile_fresh"] = bool(man["compile_fresh"])
    if "compile" in man:
        c = man["compile"]
        if "hit" in c:
            out["compile_program_hit"] = bool(c["hit"])
        for k in ("load_s", "compile_s", "lower_s"):
            if c.get(k) is not None:
                out[f"compile_program_{k}"] = c[k]
    if "wall_phases_s" in man:
        out["wall_phase_seconds"] = man["wall_phases_s"]
    if "conformance" in man:
        out["conformance_agree"] = man["conformance"].get("agree", 0)
        out["conformance_diverge"] = man["conformance"].get("diverge", 0)
    if "escalations" in man:
        esc = man["escalations"]
        out["escalations_total"] = len(esc)
        # final capacity per grown knob — the dashboard's "what is
        # this run actually sized at now" gauge
        out["escalated_capacity"] = {
            e["knob"]: e["to"] for e in esc if "knob" in e}
    if "preempted" in man:
        out["preempted"] = bool(man["preempted"])
    if "dispatch" in man:
        d = man["dispatch"]
        out["windows_per_dispatch"] = d.get("windows_per_dispatch", 1)
        out["dispatches"] = d.get("dispatches", 0)
        if "adaptive_jump_mean_ns" in d:
            out["adaptive_jump_mean_ns"] = d["adaptive_jump_mean_ns"]
    if "injection" in man:
        inj = man["injection"]
        for k in ("injected", "dropped", "late", "backpressure"):
            if inj.get(k) is not None:
                out[f"inject_{k}"] = inj[k]
    if "lanes" in man:
        from shadow_tpu_torch.core.lanes import lane_metric_families

        ln = man["lanes"]
        out["lanes_replicas"] = ln.get("replicas", 0)
        out["lanes_quarantined_total"] = len(ln.get("quarantined", []))
        out["lanes_contained"] = bool(ln.get("contained", False))
        # per-lane gauge families: which tenant tripped
        out.update(lane_metric_families(ln.get("per_lane", [])))
    if "flows" in man:
        fl = man["flows"]
        for k in ("sampled", "recorded", "harvested", "lost_ring",
                  "lost_window_clamp"):
            if fl.get(k) is not None:
                out[f"flow_{k}"] = fl[k]
        if fl.get("sample_period"):
            out["flow_sample_period"] = fl["sample_period"]
        per_lane = fl.get("per_lane") or {}
        for stat in ("p50_ns", "p95_ns", "p99_ns"):
            fam = {lane: v[stat] for lane, v in sorted(per_lane.items())
                   if stat in v}
            if fam:
                out[f"flow_latency_{stat}"] = fam
        fam = {lane: v["count"] for lane, v in sorted(per_lane.items())
               if "count" in v}
        if fam:
            out["flow_lane_samples"] = fam
    if "admission" in man:
        adm = man["admission"]
        for k in ("admitted", "completed", "evicted", "quarantined",
                  "resident", "deferred"):
            if adm.get(k) is not None:
                out[f"admission_{k}"] = adm[k]
        if "program_key_stable" in adm:
            out["admission_program_key_stable"] = bool(
                adm["program_key_stable"])
        if adm.get("admission_events") is not None:
            out["admission_events"] = adm["admission_events"]
        if adm.get("retraces") is not None:
            out["admission_retraces"] = adm["retraces"]
        if adm.get("degrade_level") is not None:
            out["admission_degrade_level"] = adm["degrade_level"]
        # per-lane lease planes: which tenant occupies which lane, and
        # whether its lease is live — churn debugging needs the lane
        # attribution, not just the scalar counts above
        per = adm.get("per_lane") or []
        for stat, key in (("active", "active"),
                          ("epoch", "epoch"),
                          ("completed", "completed")):
            fam = {str(d["lane"]): int(d[key]) for d in per
                   if key in d}
            if fam:
                out[f"admission_lane_{stat}"] = fam
    if "causality" in man:
        cz = man["causality"]
        for k in ("sampled", "emitted", "harvested", "lost_ring",
                  "cross_host_harvested", "windows_attributed",
                  "windows_lost"):
            if cz.get(k) is not None:
                out[f"causality_{k}"] = cz[k]
        if cz.get("sample_period"):
            out["causality_sample_period"] = cz["sample_period"]
        # binding-cause histogram: one counter per clamp that decided
        # a window end (min_jump_floor / adaptive_edge / fault_record
        # / inject_horizon / end_time) — the dashboard's "what is the
        # simulator waiting on" breakdown
        if cz.get("causes"):
            out["window_binding_cause"] = dict(cz["causes"])
        if cz.get("edges"):
            out["window_binding_edge"] = dict(cz["edges"])
        for key, name in (("jump_utilization_pct",
                           "window_jump_utilization_pct"),
                          ("idle_lane_pct",
                           "causality_idle_lane_pct")):
            fam = cz.get(key) or {}
            if fam:
                out[name] = {k: v for k, v in sorted(fam.items())}
        chains = cz.get("chains") or []
        if chains:
            out["critical_chain_count"] = len(chains)
            out["critical_chain_len_max"] = max(
                c.get("length", 0) for c in chains)
            out["critical_chain_span_ns_max"] = max(
                c.get("span_ns", 0) for c in chains)
    if "elastic" in man:
        # elastic recovery counters: how many devices this run lost,
        # how many integrity trips it took, and how many times the
        # mesh shrank — the dashboard's "how degraded is this run"
        el = man["elastic"]
        out["device_lost_total"] = len(el.get("losses") or ())
        out["shard_divergence_total"] = len(el.get("divergences") or ())
        out["mesh_shrink_total"] = len(el.get("mesh_transitions") or ())
        if el.get("initial_shards") is not None:
            out["elastic_initial_shards"] = int(el["initial_shards"])
        if el.get("final_shards") is not None:
            out["elastic_final_shards"] = int(el["final_shards"])
    hl = man.get("health") or {}
    if hl.get("sentinel"):
        # cross-shard integrity sentinel: barrier checks performed and
        # the verified-state frontier (0 trips => frontier == end time)
        st = hl["sentinel"]
        out["sentinel_checks_total"] = int(st.get("checks", 0) or 0)
        out["sentinel_verified_through_ns"] = int(
            st.get("verified_through_ns", 0) or 0)
    return out


def write_trace(path: str, records, timers=None, num_shards: int = 1,
                flow_records=None, adv_records=None, chains=None):
    with open(path, "w") as f:
        json.dump(chrome_trace(records, timers, num_shards,
                               flow_records=flow_records,
                               adv_records=adv_records, chains=chains), f)
    return path


def write_metrics(path: str, manifest: dict):
    with open(path, "w") as f:
        f.write(prometheus_text(metrics_from_manifest(manifest)))
    return path


def write_manifest(path: str, manifest: dict):
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    return path
