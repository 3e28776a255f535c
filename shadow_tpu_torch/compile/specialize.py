"""Program specialization: capability-trimmed variants (PyTorch port of
shadow_tpu/compile/specialize.py).

The step and bulk passes are written for the *general* network: every
window pays for a Bernoulli loss draw per send and for the timer
handler family even when the concrete build can prove neither can ever
fire (reliability table all-ones and no fault plan touching it; no
handler that can arm a host timer). In the port each of those is a run
of eager launches: the threefry draw alone is ~20 rounds of int64
elementwise ops.

This module removes them when the runner is built:

- `derive(bundle, ...)` computes a `Capabilities` vector from the
  CONCRETE build inputs (the boot reliability table, the installed
  fault plan's record kinds, the app handlers' declared emit-kind
  sets, the attached optional subsystems).
- `apply(bundle, ...)` attaches the vector to the bundle; the runner
  factories (net/build.py, utils/checkpoint.py run_windows) pass it to
  make_step_fn / make_bulk_fn / make_tcp_bulk_fn, which then leave the
  dead work out of the functions they build instead of masking it.
- The vector enters the program key (compile/buckets.py `extra`) ONLY
  when something was actually dropped, so a scenario with nothing
  trimmable runs the same program under the SAME key as an
  unspecialized build.

Safety is load-bearing: dropping a capability attaches a `GuardState`
to the Sim — one device predicate per dropped capability, evaluated
once per window at the fault boundary (core/engine.py step_window) as
a reduction on the device, never a host read. If a provably-dead
capability would have fired anyway (a snapshot restored a lossy
reliability table into a loss-trimmed program; an external path staged
a TIMER event into a timer-trimmed one), the latch trips a FATAL health
fault (faults/health.py): specialization can never silently change
results. The trimmed values are bit-identical wherever the
capabilities hold: the loss trim advances the RNG counters by exactly
the amount the skipped draw would have (rng.uniform returns
counters + 1, data-independently), and an omitted handler family is
the identity on every micro-step where its kinds cannot appear.

There is no fallback: an unknown mode raises, and so does a bundle the
analysis cannot read.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from shadow_tpu_torch.core import simtime
from shadow_tpu_torch.core.events import EventKind, _Replace, static

I64 = torch.int64

# The capabilities this pass can trim. `tcp` and `faults` are recorded
# in the vector for the manifest and operators but are already left out
# by older machinery (cfg.tcp selects the TCP handler families; a None
# fault_fn skips the table rewrite) and already keyed (cfg.tcp in the
# shape vector, the plan digest in the kind census).
TRIMMABLE = ("loss", "timers")
MODES = ("auto", "off")


@dataclass(frozen=True)
class Capabilities:
    """Static capability vector of one built scenario. True = the
    capability is LIVE (run in full); a False trimmable capability is
    OMITTED from the program and watched by the guard latch."""

    loss: bool = True      # any send can be reliability-dropped
    timers: bool = True    # a TIMER event can ever enter the queue
    tcp: bool = True       # cfg.tcp (recorded; selected by cfg already)
    faults: bool = True    # a fault plan is installed (recorded)
    # optional attachments known when the runner is built (the
    # None-contributes-no-leaves contract, net/state.py Sim), recorded
    # so an operator reads the program's full composition
    telemetry: bool = False
    lanes: bool = False
    inject: bool = False
    flows: bool = False
    admission: bool = False
    causality: bool = False

    def dropped(self) -> tuple:
        """Names of the capabilities this pass trimmed (a subset of
        TRIMMABLE), sorted."""
        return tuple(sorted(n for n in TRIMMABLE if not getattr(self, n)))

    def key_extra(self) -> str | None:
        """Program-key contribution: a stable token per dropped
        capability, None when nothing was dropped — so an untrimmed
        specialized build keys as an unspecialized one."""
        d = self.dropped()
        return "-".join("no_" + n for n in d) if d else None

    def as_dict(self) -> dict:
        """Manifest block."""
        return {
            "capabilities": {f.name: bool(getattr(self, f.name))
                             for f in dataclasses.fields(self)},
            "dropped": list(self.dropped()),
            "key_extra": self.key_extra(),
        }


def _plan_touches_reliability(plan) -> bool:
    """True when any record of the installed fault plan can rewrite
    the reliability table (faults/apply.py's reliability kinds)."""
    if plan is None or not getattr(plan, "n", 0):
        return False
    from shadow_tpu_torch.faults.plan import FaultKind

    k = np.asarray(plan.kind)
    return bool(np.isin(k, (FaultKind.LINK_DOWN, FaultKind.LINK_UP,
                            FaultKind.LOSS, FaultKind.PARTITION,
                            FaultKind.HEAL)).any())


def _timers_statically_dead(bundle, app_handlers) -> bool:
    """TIMER events are emitted only by net/timers.timer_set, reached
    only through handlers that arm host timers. A handler opts into the
    analysis by declaring `specialize_kinds` (a frozenset of the
    EventKind ints it can emit); every handler must declare, and none
    may declare TIMER. Injection staging can stage arbitrary kinds, so
    an attached inject lane keeps timers live. The guard latch backs
    the declaration: a queue-resident TIMER on a timer-trimmed program
    is a fatal health fault, never a silent no-op."""
    if getattr(bundle.sim, "inject", None) is not None:
        return False
    for h in app_handlers or ():
        kinds = getattr(h, "specialize_kinds", None)
        if kinds is None or int(EventKind.TIMER) in kinds:
            return False
    return True


def _reliability(bundle) -> np.ndarray:
    """The bundle's live reliability table on the host; raises when the
    bundle has none to read (the analysis never guesses)."""
    sim = getattr(bundle, "sim", None)
    rel = getattr(getattr(sim, "net", None), "reliability", None)
    if not isinstance(rel, torch.Tensor) or getattr(bundle, "cfg",
                                                    None) is None:
        raise ValueError(
            "specialize: the bundle has no config or no "
            "sim.net.reliability table to analyse — pass the SimBundle "
            "that net.build.build (or the config loader) returned")
    return rel.detach().cpu().numpy()


def derive(bundle, app_handlers=(), app_bulk=None,
           app_tcp_bulk=None) -> Capabilities:
    """Derive the capability vector from one built bundle's concrete
    inputs. Pure analysis — attaches nothing; see apply()."""
    rel = _reliability(bundle)
    plan = getattr(bundle, "fault_plan", None)
    lossless = bool((rel >= 1.0).all()) and not _plan_touches_reliability(plan)
    sim = bundle.sim
    return Capabilities(
        loss=not lossless,
        timers=not _timers_statically_dead(bundle, app_handlers),
        tcp=bool(bundle.cfg.tcp),
        faults=plan is not None,
        telemetry=getattr(sim, "telem", None) is not None,
        lanes=getattr(sim, "lanes", None) is not None,
        inject=getattr(sim, "inject", None) is not None,
        flows=getattr(sim, "flows", None) is not None,
        admission=getattr(sim, "admission", None) is not None,
        causality=getattr(sim, "causality", None) is not None,
    )


@dataclass
class GuardState(_Replace):
    """Device-side guard latch for a specialized program: one sticky
    trip counter per dropped capability, bumped once per window at the
    fault boundary (engine.step_window). The watch flags are static
    (not leaves: snapshots and convert take them from a template), so
    an unwatched predicate costs nothing; the counters are 0-d int64
    leaves, which lane compaction and lane extraction pass through
    untouched (core/compact.py)."""

    loss_trips: torch.Tensor    # [] i64
    timer_trips: torch.Tensor   # [] i64
    watch_loss: bool = static(False)
    watch_timers: bool = static(False)

    def watched(self) -> tuple:
        return tuple(n for n, w in (("loss", self.watch_loss),
                                    ("timers", self.watch_timers)) if w)


def make_guard(caps: Capabilities, device) -> GuardState | None:
    """Guard for a capability vector on `device`; None when nothing was
    dropped (no dropped capability -> no guard -> no extra leaves ->
    the same program as the unspecialized build)."""
    d = caps.dropped()
    if not d:
        return None
    return GuardState(
        loss_trips=torch.zeros((), dtype=I64, device=device),
        timer_trips=torch.zeros((), dtype=I64, device=device),
        watch_loss="loss" in d,
        watch_timers="timers" in d,
    )


def guard_update(sim, wend):
    """Per-window guard evaluation, called from engine.step_window
    right after the fault rewrite (the only in-window writer of the
    watched tables). Each watched predicate asks "could the dropped
    capability fire?" and bumps its sticky counter on the device (a
    reduction and an add; no host read); faults/health.py gather()
    folds a nonzero counter into a FATAL verdict."""
    g = sim.guard
    if g.watch_loss:
        trip = (sim.net.reliability < 1.0).any()
        g = g.replace(loss_trips=g.loss_trips + trip.to(I64))
    if g.watch_timers:
        q = sim.events
        pending = (q.time != simtime.INVALID) & (q.kind == EventKind.TIMER)
        g = g.replace(timer_trips=g.timer_trips + pending.any().to(I64))
    return sim.replace(guard=g)


def apply(bundle, app_handlers=(), app_bulk=None, app_tcp_bulk=None,
          mode: str = "auto"):
    """Specialize a built bundle: derive the capability vector and
    return a new bundle carrying it (SimBundle.caps — the runner
    factories read it) with the guard attached to its Sim when anything
    was dropped. mode="off" returns the bundle with caps=None (the
    --specialize off escape hatch). Apply it after every attachment
    (telemetry, lanes, recorders): the analysis reads the final Sim.
    Returns the (possibly new) bundle; read `bundle.caps` for the
    vector (None = unspecialized)."""
    if mode not in MODES:
        raise ValueError(f"--specialize must be auto|off, got {mode!r}")
    if mode == "off":
        return (dataclasses.replace(bundle, caps=None)
                if getattr(bundle, "caps", None) is not None else bundle)
    caps = derive(bundle, app_handlers, app_bulk, app_tcp_bulk)
    sim = bundle.sim
    guard = make_guard(caps, sim.events.time.device)
    if guard is not None:
        sim = sim.replace(guard=guard)
    return dataclasses.replace(bundle, sim=sim, caps=caps)


def loss_trimmed(caps) -> bool:
    """True when the loss capability was dropped — every draw site
    trims under this one predicate."""
    return caps is not None and not caps.loss


def timers_trimmed(caps) -> bool:
    return caps is not None and not caps.timers


def specialization_block(caps, sim=None, *, mode: str = "auto") -> dict | None:
    """run_manifest.json block for a specialized run (None when the
    run was not specialized): the capability vector, the dropped list,
    the key contribution, and — when the final sim is given — the
    guard-latch counters showing no dead capability fired.
    tools/telemetry_lint.py validates this block."""
    if caps is None:
        return None
    block = {"mode": mode, **caps.as_dict()}
    g = guard_report(sim) if sim is not None else None
    if g is not None:
        block["guard"] = g
    return block


def guard_report(sim) -> dict | None:
    """Host-side snapshot of the guard counters (one host read; None
    when the sim carries no guard)."""
    g = getattr(sim, "guard", None)
    if g is None:
        return None
    loss, timer = torch.stack([g.loss_trips, g.timer_trips]).tolist()
    return {"watched": list(g.watched()), "loss_trips": int(loss),
            "timer_trips": int(timer)}
