"""Pluggable search strategies over the sweep lattice.

Every strategy decision is a pure function of (spec, journaled
reduce tables): `initial()` picks round 0's points from the plan
alone, `next_round()` derives refinement rounds from the recorded
tables — never from live state — so a resumed search replays its own
history and then continues identically to an uninterrupted run. The
driver asserts this: on resume it re-derives each journaled round
and refuses to continue past a mismatch (a changed spec file or a
tampered journal).

- grid: every lattice point, one round.
- random: a seeded sample of the lattice, one round. The sample is
  derived by hashing (seed, point id) — deterministic across
  processes and Python versions, no RNG library state involved.
- halving: successive halving — rank round k, keep the top
  ceil(n/eta) eligible points (reduce.py survivors), re-run them in
  round k+1 with the budget field scaled (default: sim_s doubled),
  until one survivor remains or the round cap is hit.
"""

# The port's copy of shadow_tpu/sweep/search.py (host-only code; the port
# imports nothing of the reference).

from __future__ import annotations

import dataclasses
import hashlib

from shadow_tpu_torch.fleet.spec import JobSpec
from shadow_tpu_torch.sweep import reduce as reduce_mod


def make_strategy(spec):
    cfg = spec.search
    name = cfg.get("strategy", "grid")
    if name == "grid":
        return GridSearch()
    if name == "random":
        return RandomSearch(samples=int(cfg["samples"]),
                            seed=int(cfg.get("seed", 1)))
    if name == "halving":
        field = cfg.get("budget_field", "sim_s")
        base = spec.template.get(field)
        if base is None:
            # budget field left at the JobSpec default: scale that
            base = next(f.default for f in dataclasses.fields(JobSpec)
                        if f.name == field)
        return HalvingSearch(
            eta=int(cfg.get("eta", 2)),
            rounds=(None if cfg.get("rounds") is None
                    else int(cfg["rounds"])),
            budget_field=field,
            budget_scale=int(cfg.get("budget_scale", 2)),
            budget_base=base)
    raise ValueError(f"unknown search strategy {name!r}")


class GridSearch:
    name = "grid"

    def initial(self, points) -> list:
        return [p.pid for p in points]

    def overrides(self, round_no: int) -> dict:
        return {}

    def next_round(self, tables: list):
        return None


class RandomSearch:
    name = "random"

    def __init__(self, *, samples: int, seed: int):
        self.samples = samples
        self.seed = seed

    def initial(self, points) -> list:
        # seeded sample without replacement: order every point by
        # sha256(seed:pid) and take the prefix — stable across
        # processes, so a resumed sweep re-derives the same sample
        def key(p):
            return hashlib.sha256(
                f"{self.seed}:{p.pid}".encode()).hexdigest()
        chosen = sorted(points, key=key)[:self.samples]
        return sorted(p.pid for p in chosen)

    def overrides(self, round_no: int) -> dict:
        return {}

    def next_round(self, tables: list):
        return None


class HalvingSearch:
    name = "halving"

    def __init__(self, *, eta: int = 2, rounds=None,
                 budget_field: str = "sim_s", budget_scale: int = 2,
                 budget_base=None):
        self.eta = eta
        self.rounds = rounds
        self.budget_field = budget_field
        self.budget_scale = budget_scale
        self.budget_base = budget_base

    def initial(self, points) -> list:
        return [p.pid for p in points]

    def overrides(self, round_no: int) -> dict:
        """Round k runs at base * scale^k of the budget field — the
        JobSpec's template value when the field is not an axis (the
        common case; an axis-varied budget field keeps its per-point
        value in round 0 and is overridden from round 1 on)."""
        if round_no == 0 or self.budget_base is None:
            return {}
        val = self.budget_base * (self.budget_scale ** round_no)
        return {self.budget_field: val}

    def next_round(self, tables: list):
        """Derive round len(tables) from the LAST journaled table:
        prune to the top ceil(n/eta) eligible survivors
        (reduce.survivors — the same rule the lint re-derives), stop
        when pruning can no longer shrink the field or the round cap
        is reached. Returns {"points", "pruned"} or None."""
        if not tables:
            return None
        if self.rounds is not None and len(tables) >= self.rounds:
            return None
        last = tables[-1]
        eligible = [r["point"] for r in last
                    if r["verdict"] in reduce_mod.ELIGIBLE]
        if len(eligible) <= 1:
            return None
        keep = reduce_mod.halving_keep(len(eligible), self.eta)
        if keep >= len(eligible):
            return None
        kept = reduce_mod.survivors(last, keep)
        return {"points": kept,
                "pruned": sorted(set(eligible) - set(kept))}
