"""The port's copy of shadow_tpu/hostrun/diff.py, over its own vproc.

Differential checker: compare normalized traces from the two
backends (hostrun/trace.py) and summarize agreement.

Comparison is exact on the canonical form — the tolerance for
legitimate timing divergence (ready-set ordering, partial-transfer
chunking, clock values, ephemeral ports, expiration counts) lives in
the normalizer, not here, so every rule is written down in one place
(docs/7-conformance.md) and the checker itself stays a strict
sequence equality with readable reporting.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class DiffResult:
    agree: bool
    divergences: list = field(default_factory=list)
    stats: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        return {"agree": self.agree, "divergences": self.divergences,
                "stats": self.stats}


def _observables(procs: dict) -> dict:
    """Roll-up per side: bytes moved, -1 returns, accepts, exits."""
    sent = received = accepts = errnos = 0
    exits = {}
    for proc, recs in procs.items():
        for rec in recs:
            op, _args, ret = rec
            if op in ("send", "send_data") and isinstance(ret, int) \
                    and ret > 0:
                sent += ret
            elif op == "recv" and isinstance(ret, int) and ret > 0:
                received += ret
            elif op in ("recv_data", "read") and isinstance(ret, list) \
                    and len(ret) == 2 and isinstance(ret[0], int):
                received += ret[0]
            elif op == "accept" and ret != -1:
                accepts += 1
            elif op == "_exit":
                exits[proc] = ret
            if ret == -1:
                errnos += 1
    return {"bytes_sent": sent, "bytes_received": received,
            "accepts": accepts, "error_returns": errnos, "exits": exits}


def diff_traces(sim_procs: dict, host_procs: dict) -> DiffResult:
    """Compare two normalized {proc: [records]} maps. Divergences
    carry enough context to localize the first disagreement per
    process; stats carry both sides' observables regardless."""
    div = []
    for proc in sorted(set(sim_procs) | set(host_procs)):
        a = sim_procs.get(proc)
        b = host_procs.get(proc)
        if a is None or b is None:
            div.append({"proc": proc, "index": None,
                        "kind": "missing-process",
                        "sim": None if a is None else len(a),
                        "host": None if b is None else len(b)})
            continue
        for i, (ra, rb) in enumerate(zip(a, b)):
            if ra != rb:
                div.append({"proc": proc, "index": i,
                            "kind": "record-mismatch",
                            "sim": ra, "host": rb})
                break               # first mismatch per proc: the
                # rest of the sequence diverges by construction
        else:
            if len(a) != len(b):
                div.append({"proc": proc, "index": min(len(a), len(b)),
                            "kind": "length-mismatch",
                            "sim": len(a), "host": len(b)})
    obs_sim = _observables(sim_procs)
    obs_host = _observables(host_procs)
    if not div and obs_sim != obs_host:
        div.append({"proc": "*", "index": None,
                    "kind": "observables-mismatch",
                    "sim": obs_sim, "host": obs_host})
    return DiffResult(
        agree=not div, divergences=div,
        stats={"procs": len(set(sim_procs) | set(host_procs)),
               "records_sim": sum(map(len, sim_procs.values())),
               "records_host": sum(map(len, host_procs.values())),
               "sim": obs_sim, "host": obs_host})


def render(res: DiffResult, label_a: str = "sim",
           label_b: str = "host") -> str:
    """Human-readable divergence report (tools/dualmode_diff.py)."""
    lines = []
    s = res.stats
    lines.append(
        f"{'AGREE' if res.agree else 'DIVERGE'}: "
        f"{s.get('procs', 0)} proc(s), "
        f"{s.get('records_sim', 0)} {label_a} / "
        f"{s.get('records_host', 0)} {label_b} records")
    for side, label in ((s.get("sim"), label_a), (s.get("host"), label_b)):
        if side:
            lines.append(
                f"  {label}: sent={side['bytes_sent']} "
                f"recv={side['bytes_received']} "
                f"accepts={side['accepts']} "
                f"errs={side['error_returns']}")
    for d in res.divergences:
        if d["kind"] == "missing-process":
            lines.append(f"  !! {d['proc']}: present only in "
                         f"{label_a if d['host'] is None else label_b}")
        elif d["kind"] == "length-mismatch":
            lines.append(
                f"  !! {d['proc']}: record counts differ after index "
                f"{d['index']} ({label_a}={d['sim']}, "
                f"{label_b}={d['host']})")
        elif d["kind"] == "observables-mismatch":
            lines.append(f"  !! observables differ: {label_a}={d['sim']} "
                         f"{label_b}={d['host']}")
        else:
            lines.append(f"  !! {d['proc']}[{d['index']}]:")
            lines.append(f"       {label_a}:  {d['sim']}")
            lines.append(f"       {label_b}: {d['host']}")
    return "\n".join(lines)
