"""Window-advance cause codes (a copy of the constants of
shadow_tpu/telemetry/causality.py). core.engine.make_wend_fn's
``explain`` attributes each window's end to one of them. The lineage
recorder of the reference's module is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

# Window-advance binding causes, in clamp-priority order: each clamp
# that STRICTLY lowers wend overwrites the cause, so ties report the
# earlier (weaker) constraint — deterministic on every path.
CAUSE_MIN_JUMP = 0        # static floor (or adaptive jump at the floor)
CAUSE_ADAPTIVE_EDGE = 1   # live latency table min over pair_mask
CAUSE_FAULT_RECORD = 2    # clamped to the next fault-plan record time
CAUSE_INJECT_HORIZON = 3  # clamped to the injection staging horizon
CAUSE_END_TIME = 4        # clamped to end_time + 1

CAUSE_NAMES = ("min_jump_floor", "adaptive_edge", "fault_record",
               "inject_horizon", "end_time")


def cause_name(code: int) -> str:
    return (CAUSE_NAMES[code] if 0 <= code < len(CAUSE_NAMES)
            else f"unknown_{code}")
