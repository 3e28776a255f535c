"""Warm-pool counterfactual sweeps: the fleet as a query service
(PyTorch port of shadow_tpu/sweep/).

One scenario template, expanded over declared axes into a
deterministic job lattice (plan.py), scheduled bucket-affinity-first
onto a prewarmed worker pool (driver.py on fleet/), reduced into a
ranked objective table (reduce.py), optionally refined by a search
strategy (search.py). Every decision is journaled with the fleet's
CRC framing, so `sweep run --resume` after SIGKILL re-runs zero
completed points and replays the search identically.
"""

from shadow_tpu_torch.sweep.plan import SweepSpec, expand, plan_census
from shadow_tpu_torch.sweep.reduce import rank

__all__ = ["SweepSpec", "expand", "plan_census", "rank"]
