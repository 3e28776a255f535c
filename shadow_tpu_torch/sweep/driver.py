"""The resumable sweep driver: rounds of fleet execution, journaled
with the fleet's CRC framing (PyTorch port of shadow_tpu/sweep/driver.py).

Every point runs on the fleet's device (`SweepDriver(device=...)`:
"cuda" unless the caller asks for the CPU, as `fleet.FleetRunner`
takes it; no fallback), and the prewarm builds each distinct program
in the driver process on that same device, so a worker's store lookup
finds the key the prewarm stored.

Layout: the sweep dir IS a fleet dir plus the sweep's own state —

    sweep_spec.json     durable copy of the SweepSpec (resume needs
                        no --spec; a changed spec is refused by digest)
    sweep.log           the sweep journal (fleet/journal.py framing):
                        sweep_created / round_planned / prewarmed /
                        round_reduced / sweep_complete frames
    journal.log         the fleet queue's journal (shared by every
                        round — round k+1 jobs are ADDED to the same
                        queue, so `fleet status --fleet-dir` sees the
                        whole sweep)
    jobs/<r..-p..>/     per-point job dirs (specs, checkpoints,
                        run manifests, results)
    fleet_manifest.json the roll-up, carrying the "sweep" block
    sweep_report.json   the final ranked report

Resume contract: every driver decision is either journaled or a pure
function of journaled state. `sweep run --resume` after SIGKILL
replays sweep.log, re-derives each recorded round from the plan +
recorded reduce tables (refusing to continue past a mismatch), skips
rounds already reduced, and re-enters the fleet with resume=True for
the round in flight — the fleet's own journal guarantees completed
points are not re-run, and the reducer's determinism (reduce.py)
guarantees the final ranking is byte-identical to an uninterrupted
run's. Divergent points (failed or quarantined jobs) rank ineligible
instead of sinking the sweep.
"""

from __future__ import annotations

import json
import os
import time

from shadow_tpu_torch.fleet import journal as journal_mod
from shadow_tpu_torch.sweep import plan as plan_mod
from shadow_tpu_torch.sweep import reduce as reduce_mod
from shadow_tpu_torch.sweep import search as search_mod

SWEEP_JOURNAL = "sweep.log"
SWEEP_SPEC = "sweep_spec.json"
SWEEP_REPORT = "sweep_report.json"

EXIT_OK = 0
EXIT_NO_RANKING = 1
EXIT_PREEMPTED = 5
EXIT_STALLED = 6


class SweepError(RuntimeError):
    pass


def _write_json(path: str, obj) -> str:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def load_sweep_dir(sweep_dir: str):
    """(spec, frames) of an existing sweep dir — the read-only entry
    point `sweep status` / `sweep report` / `fleet status` share."""
    spath = os.path.join(sweep_dir, SWEEP_SPEC)
    spec = None
    if os.path.isfile(spath):
        spec = plan_mod.SweepSpec.from_file(spath)
    frames, _ = journal_mod.replay(os.path.join(sweep_dir,
                                                SWEEP_JOURNAL))
    return spec, frames


def fold_rounds(frames) -> tuple[list, bool]:
    """Fold sweep-journal frames into per-round state:
    [{round, points, overrides, pruned, prewarm, table}], complete.
    Pure — replay and the live driver share it."""
    rounds: list = []
    complete = False
    for rec in frames:
        ev = rec.get("ev")
        if ev == "round_planned":
            k = int(rec["round"])
            while len(rounds) <= k:
                rounds.append(None)
            rounds[k] = {"round": k, "points": list(rec["points"]),
                         "overrides": dict(rec.get("overrides") or {}),
                         "pruned": list(rec.get("pruned") or []),
                         "census": rec.get("census"),
                         "prewarm": None, "table": None}
        elif ev == "prewarmed":
            k = int(rec["round"])
            if k < len(rounds) and rounds[k] is not None:
                rounds[k]["prewarm"] = {
                    "hits": int(rec.get("hits", 0)),
                    "compiled": int(rec.get("compiled", 0)),
                    "keys": list(rec.get("keys") or [])}
        elif ev == "round_reduced":
            k = int(rec["round"])
            if k < len(rounds) and rounds[k] is not None:
                rounds[k]["table"] = list(rec["table"])
        elif ev == "sweep_complete":
            complete = True
    if any(r is None for r in rounds):
        raise SweepError("sweep journal skips a round index — "
                         "refusing to interpret it")
    return rounds, complete


def point_categories(rounds, job_status: dict) -> dict:
    """Final lineage category of every round-0 lattice point:
    completed / failed / quarantined / pruned / pending. A point's
    LAST round decides — a survivor's earlier completions are
    superseded, a pruned point keeps "pruned" (its lineage ended by
    decision, not by verdict). Conservation — expanded == completed +
    failed + quarantined + pruned + pending — holds by construction,
    and the lint re-checks it on the manifest block."""
    cat: dict = {}
    for k, rd in enumerate(rounds):
        for pid in rd["pruned"]:
            cat[pid] = "pruned"
        for pid in rd["points"]:
            st = job_status.get(plan_mod.job_id(k, pid))
            cat[pid] = {"done": "completed", "failed": "failed",
                        "quarantined": "quarantined"}.get(st,
                                                          "pending")
    return cat


def sweep_block(spec, rounds, job_status: dict,
                complete: bool) -> dict:
    """The fleet manifest's "sweep" roll-up block (fleet/manifest.py
    threads it; tools/telemetry_lint.py validates it). Built from
    journaled sweep state + the queue's job statuses only, so a
    mid-run manifest rewrite is exactly as accurate as the journal."""
    cats = point_categories(rounds, job_status)
    counts = {"expanded": len(rounds[0]["points"]) if rounds else 0,
              "completed": 0, "failed": 0, "quarantined": 0,
              "pruned": 0, "pending": 0}
    for c in cats.values():
        counts[c] += 1
    census_tot: dict = {}
    prewarm_tot = None
    round_blocks = []
    for k, rd in enumerate(rounds):
        for ak, info in ((rd.get("census") or {}).get("programs")
                         or {}).items():
            census_tot[ak] = census_tot.get(ak, 0) + int(info["count"])
        if rd.get("prewarm"):
            if prewarm_tot is None:
                prewarm_tot = {"hits": 0, "compiled": 0, "keys": []}
            prewarm_tot["hits"] += rd["prewarm"]["hits"]
            prewarm_tot["compiled"] += rd["prewarm"]["compiled"]
            for ki in rd["prewarm"]["keys"]:
                if ki.get("key") and ki["key"] not in \
                        prewarm_tot["keys"]:
                    prewarm_tot["keys"].append(ki["key"])
        rc = {"done": 0, "failed": 0, "quarantined": 0, "pending": 0}
        for pid in rd["points"]:
            st = job_status.get(plan_mod.job_id(k, pid))
            rc[st if st in rc else "pending"] += 1
        round_blocks.append({"round": k, "points": list(rd["points"]),
                             "overrides": rd["overrides"],
                             "pruned": list(rd["pruned"]),
                             "counts": rc, "ranking": rd["table"]})
    final_table = rounds[-1]["table"] if rounds else None
    best = None
    if final_table:
        top = [r for r in final_table
               if r["verdict"] in reduce_mod.ELIGIBLE]
        best = top[0]["point"] if top else None
    return {
        "id": spec.id,
        "spec_digest": spec.digest(),
        "objective": spec.objective.as_dict(),
        "search": dict(spec.search),
        "lattice": spec.lattice_size(),
        "complete": bool(complete),
        "points": counts,
        "jobs_expanded": sum(len(rd["points"]) for rd in rounds),
        "census": {"distinct": len(census_tot),
                   "programs": {k: census_tot[k]
                                for k in sorted(census_tot)}},
        **({"prewarm": prewarm_tot} if prewarm_tot else {}),
        "rounds": round_blocks,
        "ranking": final_table,
        "best": best,
    }


def fold_sweep_status(frames, job_status: dict) -> dict:
    """Per-sweep progress for the read-only status paths (`sweep
    status`, and the `fleet status` fold): points done/failed/pruned
    per round, plus where the sweep stands."""
    rounds, complete = fold_rounds(frames)
    sid = next((r.get("id") for r in frames
                if r.get("ev") == "sweep_created"), None)
    out_rounds = []
    for k, rd in enumerate(rounds):
        rc = {"planned": len(rd["points"]), "done": 0, "failed": 0,
              "quarantined": 0, "pending": 0,
              "pruned": len(rd["pruned"]), "reduced":
              rd["table"] is not None}
        for pid in rd["points"]:
            st = job_status.get(plan_mod.job_id(k, pid))
            rc[st if st in ("done", "failed", "quarantined")
               else "pending"] += 1
        out_rounds.append(rc)
    return {"id": sid, "frames": len(frames), "complete": complete,
            "rounds": out_rounds}


def _default_prewarm(specs, log, device=None):
    """Build-or-confirm one representative program per distinct
    affinity key, in the driver process on the fleet's `device` (None
    -> "cuda"), through the same build path the workers take
    (fleet/scenario.py) — so the pool's first lease of every key loads
    from the program store instead of building."""
    from shadow_tpu_torch.apps import phold
    from shadow_tpu_torch.compile import serve
    from shadow_tpu_torch.fleet import scenario
    from shadow_tpu_torch.fleet.affinity import affinity_key

    reps: dict = {}
    for s in specs:
        if s.kind == "scenario":
            reps.setdefault(affinity_key(s), s)
    infos = []
    for ak in sorted(reps):
        s = reps[ak]
        caps = {"event_capacity": s.event_capacity,
                "outbox_capacity": s.outbox_capacity,
                "router_ring": s.router_ring}
        b = scenario._build_scenario(s, caps, device=device)
        info = serve.prewarm(b, (phold.handler,), log=log, device=device)
        infos.append({"affinity_key": ak, "key": info.get("key"),
                      "hit": bool(info.get("hit"))})
    return infos


class SweepDriver:
    """One sweep execution (or continuation). `make_runner` exists
    for the queue-level tests: it must return a FleetRunner-shaped
    object (queue, settable sweep_block_fn, run() -> exit code, and
    it must leave fleet_manifest.json behind); the default builds the
    real FleetRunner. `prewarm` is None (the real build path), False
    (off), or a callable(specs) -> [{affinity_key, key, hit}].
    `device` is the fleet's (None -> "cuda"): the workers run every
    point there and the prewarm builds there."""

    def __init__(self, sweep_dir: str, spec=None, *,
                 workers: int = 2, resume: bool = False,
                 fsync: bool = True, prewarm=None,
                 make_runner=None, on_fleet_event=None, log=None,
                 now=time.time, device: str | None = None):
        os.makedirs(sweep_dir, exist_ok=True)
        self.sweep_dir = sweep_dir
        self.device = "cuda" if device is None else str(device)
        self.workers = max(1, int(workers))
        self.fsync = fsync
        self.prewarm = prewarm
        self.make_runner = make_runner
        self.on_fleet_event = on_fleet_event
        self.log = log or (lambda m: None)
        self.now = now
        self._install_signals = False
        spath = os.path.join(sweep_dir, SWEEP_SPEC)
        jpath = os.path.join(sweep_dir, SWEEP_JOURNAL)
        frames, _ = journal_mod.replay(jpath)
        if resume:
            if spec is None:
                if not os.path.isfile(spath):
                    raise FileNotFoundError(
                        f"--resume: no {SWEEP_SPEC} in {sweep_dir}")
                spec = plan_mod.SweepSpec.from_file(spath)
            created = next((r for r in frames
                            if r.get("ev") == "sweep_created"), None)
            if created and created.get("spec_digest") != spec.digest():
                raise SweepError(
                    "sweep spec changed since this sweep was created "
                    f"(digest {spec.digest()} != journaled "
                    f"{created.get('spec_digest')}) — a resumed "
                    "search must replay the original plan")
        elif frames:
            raise FileExistsError(
                f"{jpath} already holds a sweep journal — pass "
                f"--resume to continue it or use a fresh directory")
        if spec is None:
            raise ValueError("a new sweep needs a SweepSpec")
        self.spec = spec
        if self.prewarm is None and not spec.prewarm:
            self.prewarm = False   # spec opted out ("prewarm": false)
        if not os.path.isfile(spath):
            _write_json(spath, spec.as_dict())
        # fleet-CLI interop: `fleet status --fleet-dir <sweep dir>`
        # (and a bare `fleet run --resume`) read the policy from here
        ppath = os.path.join(sweep_dir, "fleet_policy.json")
        if not os.path.isfile(ppath):
            _write_json(ppath, spec.policy.as_dict())
        self.journal = journal_mod.Journal(jpath, fsync=fsync)
        self.rounds, self.complete = fold_rounds(frames)
        if not frames:
            self._record({"ev": "sweep_created", "id": spec.id,
                          "spec_digest": spec.digest(),
                          "lattice": spec.lattice_size(),
                          "search": dict(spec.search)})

    # -- journal ------------------------------------------------------
    def _record(self, rec: dict) -> None:
        rec.setdefault("t", round(self.now(), 3))
        self.journal.append(rec)

    # -- manifest hook ------------------------------------------------
    def _sweep_block_fn(self, queue) -> dict:
        status = {jid: j.status for jid, j in queue.jobs.items()}
        return sweep_block(self.spec, self.rounds, status,
                           self.complete)

    # -- fleet execution ----------------------------------------------
    def _execute(self, specs) -> tuple[int, dict]:
        fleet_journal = os.path.join(self.sweep_dir, "journal.log")
        resume = bool(journal_mod.replay(fleet_journal)[0])
        if self.make_runner is not None:
            runner = self.make_runner(self.sweep_dir, self.spec.policy,
                                      specs, resume=resume,
                                      fsync=self.fsync)
        else:
            from shadow_tpu_torch.fleet.runner import FleetRunner

            runner = FleetRunner(
                self.sweep_dir, self.spec.policy, specs,
                workers=self.workers, resume=resume, fsync=self.fsync,
                on_event=self.on_fleet_event, log=self.log,
                device=self.device)
        runner.sweep_block_fn = self._sweep_block_fn
        rc = runner.run(install_signals=self._install_signals)
        man_path = os.path.join(self.sweep_dir, "fleet_manifest.json")
        with open(man_path) as f:
            return rc, json.load(f)["jobs"]

    def _prewarm_round(self, k: int, specs) -> None:
        if self.prewarm is False or self.rounds[k]["prewarm"]:
            return
        fn = self.prewarm if callable(self.prewarm) \
            else (lambda s: _default_prewarm(s, self.log, self.device))
        infos = fn(specs)
        hits = sum(1 for i in infos if i.get("hit"))
        rec = {"ev": "prewarmed", "round": k, "hits": hits,
               "compiled": len(infos) - hits, "keys": infos}
        self._record(rec)
        self.rounds[k]["prewarm"] = {"hits": hits,
                                     "compiled": len(infos) - hits,
                                     "keys": infos}
        self.log(f"sweep: round {k} prewarmed "
                 f"{len(infos)} program(s), {hits} hit")

    # -- main loop ----------------------------------------------------
    def run(self, *, install_signals: bool = False) -> int:
        self._install_signals = install_signals
        points = plan_mod.expand(self.spec)
        by_pid = {p.pid: p for p in points}
        strategy = search_mod.make_strategy(self.spec)
        tables: list = []
        k = 0
        while True:
            # derive round k from the plan + the journaled tables;
            # a journaled round must match its own re-derivation
            if k == 0:
                derived = {"points": strategy.initial(points),
                           "pruned": []}
            else:
                derived = strategy.next_round(tables)
            if k < len(self.rounds):
                rd = self.rounds[k]
                if derived is None or \
                        derived["points"] != rd["points"] or \
                        derived.get("pruned", []) != rd["pruned"]:
                    raise SweepError(
                        f"round {k} does not re-derive from the "
                        f"journaled reduce output — journal "
                        f"{rd['points']!r} vs derived {derived!r}")
            else:
                if derived is None:
                    break
                overrides = strategy.overrides(k)
                specs = [self.spec.point_spec(by_pid[pid], k,
                                              overrides)
                         for pid in derived["points"]]
                rd = {"round": k, "points": derived["points"],
                      "overrides": overrides,
                      "pruned": derived.get("pruned", []),
                      "census": plan_mod.plan_census(specs),
                      "prewarm": None, "table": None}
                self.rounds.append(rd)
                self._record({"ev": "round_planned", "round": k,
                              "points": rd["points"],
                              "overrides": rd["overrides"],
                              "pruned": rd["pruned"],
                              "census": rd["census"]})
                self.log(f"sweep: round {k} planned "
                         f"{len(rd['points'])} point(s), "
                         f"{rd['census']['distinct']} distinct "
                         f"program(s)")
            if rd["table"] is not None:
                tables.append(rd["table"])   # already reduced: skip
                k += 1
                continue
            specs = [self.spec.point_spec(by_pid[pid], k,
                                          rd["overrides"])
                     for pid in rd["points"]]
            self._prewarm_round(k, specs)
            rc, jobs = self._execute(specs)
            if rc == EXIT_PREEMPTED:
                return EXIT_PREEMPTED
            if rc == EXIT_STALLED:
                return EXIT_STALLED
            entries = {pid: jobs.get(plan_mod.job_id(k, pid), {})
                       for pid in rd["points"]}
            table = reduce_mod.rank(entries, self.spec.objective)
            self._record({"ev": "round_reduced", "round": k,
                          "table": table})
            rd["table"] = table
            tables.append(table)
            k += 1
        if not self.complete:
            best = None
            if tables and tables[-1]:
                top = [r for r in tables[-1]
                       if r["verdict"] in reduce_mod.ELIGIBLE]
                best = top[0]["point"] if top else None
            self._record({"ev": "sweep_complete", "rounds": k,
                          "best": best})
            self.complete = True
        self._finalize()
        block = self.report()
        return EXIT_OK if block.get("best") is not None \
            else EXIT_NO_RANKING

    # -- report -------------------------------------------------------
    def _job_status_from_manifest(self) -> dict:
        man_path = os.path.join(self.sweep_dir, "fleet_manifest.json")
        if not os.path.isfile(man_path):
            return {}
        with open(man_path) as f:
            man = json.load(f)
        return {jid: e.get("status")
                for jid, e in (man.get("jobs") or {}).items()}

    def report(self) -> dict:
        return sweep_block(self.spec, self.rounds,
                           self._job_status_from_manifest(),
                           self.complete)

    def _finalize(self) -> None:
        """Stamp the completed sweep into its durable artifacts: the
        final report, and the fleet manifest's sweep block (the last
        in-run manifest rewrite predates the sweep_complete frame)."""
        block = self.report()
        _write_json(os.path.join(self.sweep_dir, SWEEP_REPORT),
                    {"schema": "shadow-tpu-sweep-report",
                     "schema_version": 1, **block})
        man_path = os.path.join(self.sweep_dir, "fleet_manifest.json")
        if os.path.isfile(man_path):
            with open(man_path) as f:
                man = json.load(f)
            man["sweep"] = block
            from shadow_tpu_torch.fleet.manifest import write_fleet_manifest

            write_fleet_manifest(man_path, man)
