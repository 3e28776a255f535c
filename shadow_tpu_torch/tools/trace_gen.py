"""Synthetic injection-trace generator (the port's tools/trace_gen.py) —
stress patterns for the open-system on-ramp (shadow_tpu_torch/inject/,
docs/9-injection.md).

Two shapes the declarative <traffic> compiler doesn't express well:

- flash-crowd: many sources converge on one victim host with a rate
  that ramps up to a peak and decays back down (the classic
  thundering-herd curve). Exercises staging backpressure and the
  destination row's event_capacity (drops latch, never silent).
- ddos: a constant-rate saturation flood from every attacker to the
  victim for a fixed duration — the overflow-accounting test vector
  (tiny --event-capacity + this trace => injection.dropped > 0 plus
  the health warning).

Records are tgen-kind events (apps/tgen.py KIND_TGEN, payload
[dst, port, size]) so a config that registers the tgen app turns the
trace into real UDP datagrams; any other scenario still exercises the
full staging/merge/accounting path (unhandled kinds are consumed and
counted, not load-bearing).

Determinism: all jitter comes from random.Random(seed) — same args,
same trace, byte for byte. Events are generated per-source then
merge-sorted, so the t_ns ordering rule holds by construction.

Usage:
  python -m shadow_tpu_torch.tools.trace_gen flash-crowd --hosts 8 \
      --victim 0 --peak-rate 50000 \
      --ramp-s 0.2 --sustain-s 0.1 --out crowd.trace [--binary]
  python -m shadow_tpu_torch.tools.trace_gen ddos --hosts 8 \
      --victim 0 --rate 20000 \
      --duration-s 0.5 --out flood.trace [--binary]

The emitted file round-trips through inject.read_trace and is sized
for --inject-lanes via apps.tgen.lanes_for (printed on stderr).
"""

from __future__ import annotations

import argparse
import heapq
import random
import sys

from shadow_tpu_torch.apps.tgen import KIND_TGEN, lanes_for  # noqa: E402
from shadow_tpu_torch.inject.trace import write_trace        # noqa: E402

ONE_SECOND = 1_000_000_000


def _jittered(period_ns: int, rnd: random.Random) -> int:
    """A send interval around `period_ns` (+-25%), floor 1 ns — keeps
    per-source streams aperiodic so arrivals interleave instead of
    phase-locking into same-timestamp bursts."""
    return max(1, int(period_ns * (0.75 + 0.5 * rnd.random())))


def _source_stream(host: int, victim: int, port: int, size: int,
                   rate_at, rate_max: float, start_ns: int,
                   end_ns: int, rnd: random.Random):
    """Yield (t_ns, record) for one source. Time-varying rates use
    thinning (Lewis-Shedler): walk at the envelope rate `rate_max`,
    keep each slot with probability rate_at(t)/rate_max — the kept
    stream follows the ramp curve with bounded steps (a naive
    1/rate_at(t) walk overshoots the whole ramp where the rate is
    near zero)."""
    t = start_ns
    period = int(ONE_SECOND / rate_max)
    while t < end_ns:
        if rnd.random() * rate_max < rate_at(t):
            yield t, {"t_ns": t, "host": host, "kind": KIND_TGEN,
                      "payload": [victim, port, size]}
        t += _jittered(period, rnd)


def _merge(streams) -> list:
    """Merge per-source streams into one t_ns-sorted trace."""
    # key= keeps timestamp ties from falling through to dict
    # comparison; merge is stable, so ties keep source order
    return [rec for _, rec in heapq.merge(*streams,
                                          key=lambda x: x[0])]


def flash_crowd(*, hosts: int, victim: int, peak_rate: float,
                ramp_s: float, sustain_s: float, start_s: float,
                port: int, size: int, seed: int) -> list:
    """Linear ramp 0 -> peak over ramp_s, hold for sustain_s, linear
    decay back to 0 over ramp_s — per source; the victim sees the sum
    over hosts-1 sources."""
    start = int(start_s * ONE_SECOND)
    ramp = max(1, int(ramp_s * ONE_SECOND))
    sustain = max(0, int(sustain_s * ONE_SECOND))
    end = start + 2 * ramp + sustain

    def rate_at(t: int) -> float:
        dt = t - start
        if dt < ramp:
            return peak_rate * dt / ramp
        if dt < ramp + sustain:
            return peak_rate
        return peak_rate * max(0, end - t) / ramp

    streams = []
    for h in range(hosts):
        if h == victim:
            continue
        # string seeds hash via sha512 (stable across processes);
        # tuple seeds fall back to hash(), which PYTHONHASHSEED
        # randomizes — that would break byte-identical regeneration
        rnd = random.Random(f"{seed}:crowd:{h}")
        streams.append(_source_stream(h, victim, port, size,
                                      rate_at, peak_rate, start, end,
                                      rnd))
    return _merge(streams)


def ddos(*, hosts: int, victim: int, rate: float, duration_s: float,
         start_s: float, port: int, size: int, seed: int) -> list:
    """Constant-rate flood per attacker for duration_s."""
    start = int(start_s * ONE_SECOND)
    end = start + max(1, int(duration_s * ONE_SECOND))
    streams = []
    for h in range(hosts):
        if h == victim:
            continue
        rnd = random.Random(f"{seed}:ddos:{h}")  # see flash_crowd
        streams.append(_source_stream(h, victim, port, size,
                                      lambda t: rate, rate, start,
                                      end, rnd))
    return _merge(streams)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="synthesize injection traces (flash-crowd / ddos)")
    sub = ap.add_subparsers(dest="pattern", required=True)

    def common(p):
        p.add_argument("--hosts", type=int, default=8,
                       help="host count (sources = hosts - 1)")
        p.add_argument("--victim", type=int, default=0,
                       help="destination host index")
        p.add_argument("--start-s", type=float, default=0.1,
                       help="trace start time (simulated seconds)")
        p.add_argument("--port", type=int, default=9100,
                       help="destination UDP port (tgen payload)")
        p.add_argument("--size", type=int, default=64,
                       help="datagram bytes (tgen payload)")
        p.add_argument("--seed", type=int, default=1)
        p.add_argument("--out", required=True, help="trace file path")
        p.add_argument("--binary", action="store_true",
                       help="CRC-framed binary instead of line JSON")

    fc = sub.add_parser("flash-crowd",
                        help="ramp/sustain/decay convergence on one "
                             "victim")
    common(fc)
    fc.add_argument("--peak-rate", type=float, default=10000.0,
                    help="per-source peak events/s")
    fc.add_argument("--ramp-s", type=float, default=0.2,
                    help="ramp-up (and decay) span, simulated s")
    fc.add_argument("--sustain-s", type=float, default=0.1,
                    help="time held at peak, simulated s")

    dd = sub.add_parser("ddos", help="constant-rate saturation flood")
    common(dd)
    dd.add_argument("--rate", type=float, default=10000.0,
                    help="per-attacker events/s")
    dd.add_argument("--duration-s", type=float, default=0.5,
                    help="flood span, simulated s")

    args = ap.parse_args(argv)
    if not 0 <= args.victim < args.hosts:
        ap.error(f"--victim {args.victim} out of range for "
                 f"--hosts {args.hosts}")
    if args.hosts < 2:
        ap.error("need --hosts >= 2 (at least one source)")

    if args.pattern == "flash-crowd":
        events = flash_crowd(
            hosts=args.hosts, victim=args.victim,
            peak_rate=args.peak_rate, ramp_s=args.ramp_s,
            sustain_s=args.sustain_s, start_s=args.start_s,
            port=args.port, size=args.size, seed=args.seed)
    else:
        events = ddos(
            hosts=args.hosts, victim=args.victim, rate=args.rate,
            duration_s=args.duration_s, start_s=args.start_s,
            port=args.port, size=args.size, seed=args.seed)

    n = write_trace(args.out, events, binary=args.binary)
    print(f"{args.pattern}: {n} events -> {args.out} "
          f"(suggest --inject-lanes {lanes_for(n)})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
