"""The port's program-store console
(shadow_tpu_torch/tools/compcache_ctl.py) on the CPU:

- `prewarm --sweep` on tests/test_sweep_recovery.py's 4-point,
  2-program spec builds the census's 2 distinct programs into a cold
  store (0 hits) and hits both warm (0 built) under the same keys — the
  reference's slow test's expectations; the census (counts,
  specialization vectors) and its affinity keys equal the reference's
  sweep/plan.py census of the same spec (host-only, no reference
  compile). Program keys hash torch, so they are the port's own;
- `ls` lists both entries as servable, `stats` counts them, and
  `gc --max-bytes` down to one entry evicts the oldest-served;
- `prewarm --test` stores the built-in example's trimmed program.
"""

import json

import pytest
import torch

from shadow_tpu_torch.tools import compcache_ctl as tcc

torch.set_num_threads(1)


def _spec_obj():
    """tests/test_sweep_recovery.py's acceptance spec cut to the slow
    prewarm test's 2 x 2 lattice: two seeds, two capacity buckets."""
    return {
        "sweep": {"id": "accept",
                  "objective": {"metric": "events", "goal": "max"},
                  "search": {"strategy": "grid"}},
        "fleet": {"max_attempts": 3, "backoff_base_s": 0.0,
                  "backoff_cap_s": 0.0},
        "template": {"kind": "scenario", "hosts": 4, "sim_s": 1},
        "axes": [{"field": "seed", "values": [1, 2]},
                 {"field": "event_capacity", "values": [24, 48]}],
    }


def _run(capsys, *argv):
    rc = tcc.main(["--platform", "cpu", *argv])
    return rc, capsys.readouterr().out


def _summary(text):
    # the summary JSON is the last top-level object on stdout
    return json.loads(text[text.rindex("\n{") + 1:])


@pytest.fixture
def spec_path(tmp_path):
    p = tmp_path / "small.json"
    p.write_text(json.dumps(_spec_obj()))
    return str(p)


def test_prewarm_sweep_cold_then_warm(tmp_path, spec_path, capsys):
    root = str(tmp_path / "store")
    rc, out = _run(capsys, "--root", root, "prewarm", "--sweep", spec_path)
    cold = _summary(out)
    assert rc == 0, out
    assert out.startswith("# sweep accept: 4 points, 2 distinct program(s)")
    assert cold["points"] == 4 and cold["distinct"] == 2
    assert cold["hits"] == 0 and cold["compiled"] == 2
    rc, out = _run(capsys, "--root", root, "prewarm", "--sweep", spec_path)
    warm = _summary(out)
    assert rc == 0, out
    assert warm["hits"] == 2 and warm["compiled"] == 0
    assert [k["key"] for k in warm["keys"]] == \
        [k["key"] for k in cold["keys"]]
    assert all(k["ok"] and k["count"] == 2 for k in warm["keys"])


def test_sweep_census_equals_reference(spec_path):
    """The census the prewarm walks — distinct count, per-program point
    counts and specialization vectors, keyed by affinity key — is the
    reference's for the same spec."""
    from shadow_tpu.fleet.affinity import affinity_key as jaffinity
    from shadow_tpu.sweep import plan as jplan

    spec, specs, census, reps = tcc.sweep_census(spec_path)
    jspec = jplan.SweepSpec.from_file(spec_path)
    jspecs = [jspec.point_spec(p, 0) for p in jplan.expand(jspec)]
    assert census == jplan.plan_census(jspecs)
    assert sorted(reps) == sorted({jaffinity(s) for s in jspecs})
    assert [s.as_dict() for s in specs] == [s.as_dict() for s in jspecs]


def test_ls_stats_gc(tmp_path, spec_path, capsys):
    root = str(tmp_path / "store")
    assert _run(capsys, "--root", root, "prewarm", "--sweep",
                spec_path)[0] == 0
    rc, out = _run(capsys, "--root", root, "ls")
    lines = out.strip().splitlines()
    assert rc == 0 and lines[0].endswith("— 2 entries")
    assert len(lines) == 3 and all(ln.endswith(" servable")
                                   for ln in lines[1:])
    assert all(f"torch={torch.__version__}" in ln for ln in lines[1:])
    rc, out = _run(capsys, "--root", root, "stats")
    stats = json.loads(out)
    assert rc == 0 and stats["entries"] == 2 and stats["specialized"] == 2
    oldest = lines[1].split()[0]
    rc, out = _run(capsys, "--root", root, "gc", "--max-bytes",
                   str(stats["total_bytes"] - 1))
    assert rc == 0 and json.loads(out)["dropped"] == [oldest]
    assert json.loads(_run(capsys, "--root", root, "stats")[1])[
        "entries"] == 1
    # an empty or missing store is a valid store
    rc, out = _run(capsys, "--root", str(tmp_path / "none"), "stats")
    assert rc == 0 and json.loads(out)["entries"] == 0


def test_prewarm_test_config_stores_the_trimmed_program(tmp_path, capsys):
    root = str(tmp_path / "store")
    rc, out = _run(capsys, "--root", root, "prewarm", "--test")
    info = _summary(out)
    assert rc == 0 and info["stored"] and not info["hit"]
    assert "specializing: trimmed loss" in out
    rc, out = _run(capsys, "--root", root, "prewarm", "--test")
    assert rc == 0 and _summary(out)["hit"] is True
    # no config at all is a usage error
    assert _run(capsys, "--root", root, "prewarm")[0] == 1
