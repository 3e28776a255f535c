"""Shape buckets and program keys in the port
(shadow_tpu_torch.compile.buckets) against the reference's
(shadow_tpu.compile.buckets), on the CPU:

- quantize_pow2 on 0..4,097 (a negative raises), quantize_caps,
  bucket_config's plan and its off knobs (sparse_lanes / inject_lanes 0
  stay 0), shape_vector_for_sim on Sims carrying telemetry, lanes,
  admission, flows and injection staging, lane_bucket and its errors:
  equal to the reference's;
- kind_census and program_key: the relations the reference's keys have
  (stable across calls; changed by one capacity, by chunk_windows, by
  extra, by the handler set and the fault plan), the "pk" + 16-hex
  format. The values differ by design: the port hashes its own sources
  and torch's version;
- a bucketed 16-host PHOLD run (capacities 24 -> 32) equals the bespoke
  run on every capacity-independent leaf and its live events, and the
  reference's bucketed run on every leaf;
- faults/escalate.py's growth plans, now on the shared quantize_pow2,
  equal the reference's.

Tolerance zero.
"""

import dataclasses

import jax
import pytest
import torch

from shadow_tpu.apps import phold as jphold
from shadow_tpu.compile import buckets as jb
from shadow_tpu.faults import escalate as jescalate
from shadow_tpu.net import build as jbuild
from shadow_tpu.net.state import NetConfig as JConfig
from shadow_tpu_torch import convert
from shadow_tpu_torch.apps import phold as tphold
from shadow_tpu_torch.bench import ONE_VERTEX
from shadow_tpu_torch.compile import buckets as tb
from shadow_tpu_torch.core import lanes as tlanes
from shadow_tpu_torch.core import simtime
from shadow_tpu_torch.faults import escalate as tescalate
from shadow_tpu_torch.net import build as tbuild
from shadow_tpu_torch.net.state import NetConfig as TConfig
from torch_parity import assert_leaves_equal, jax_leaves, packed

torch.set_num_threads(1)

SEC = simtime.ONE_SECOND
CAPS24 = {"event_capacity": 24, "outbox_capacity": 24, "router_ring": 24}


def test_quantize_pow2_equals_reference():
    got = [tb.quantize_pow2(n) for n in range(4098)]
    assert got == [jb.quantize_pow2(n) for n in range(4098)]
    assert got[:6] == [0, 1, 2, 4, 4, 8] and got[4097] == 8192
    for mod in (tb, jb):
        with pytest.raises(ValueError, match="negative"):
            mod.quantize_pow2(-1)
    caps = {"event_capacity": 24, "router_ring": 33, "sparse_lanes": 0,
            "seed": 7, "num_hosts": 100}
    assert tb.quantize_caps(caps) == jb.quantize_caps(caps)
    assert tescalate.quantize_pow2 is tb.quantize_pow2


@pytest.mark.parametrize("kw", [
    CAPS24,
    dict(CAPS24, in_ring=12, out_ring=17, sparse_lanes=100,
         inject_lanes=3),
    dict(CAPS24, sparse_lanes=0, inject_lanes=0),
    {"event_capacity": 32, "outbox_capacity": 64, "router_ring": 16},
], ids=["caps24", "every_knob", "off_knobs", "already_buckets"])
def test_bucket_config_equals_reference(kw):
    plans = []
    for C, mod in ((JConfig, jb), (TConfig, tb)):
        cfg = C(num_hosts=8, tcp=False, end_time=SEC, seed=1, **kw)
        new, plan = mod.bucket_config(cfg)
        knobs = {k: getattr(new, k) for k in tb.BUCKET_KNOBS}
        plans.append((plan.as_dict(), plan.changed, knobs,
                      new is cfg))
    assert plans[1] == plans[0]
    knobs = plans[1][2]
    if kw.get("sparse_lanes") == 0:
        assert knobs["sparse_lanes"] == 0 and knobs["inject_lanes"] == 0
    for k, d in plans[1][0].items():
        assert d["bucketed"] >= d["requested"]
        assert d["bucketed"] == tb.quantize_pow2(d["bucketed"])


def _attached(pkg, inject):
    """A packed PHOLD Sim with the ring, lanes, admission and the flow
    ring attached, or (`inject`) one carrying injection staging."""
    if inject:
        return packed(pkg, lanes=False, replicas=False, inject_lanes=8,
                      flows=(3, 64)).sim, None
    b = packed(pkg, flows=(3, 64))
    ln = jax_lanes() if pkg == "jax" else tlanes
    return ln.admit_all(ln.attach_admission(b.sim)), b


def jax_lanes():
    from shadow_tpu.core import lanes

    return lanes


@pytest.mark.parametrize("inject", [False, True],
                         ids=["ring_lanes_admission_flows", "inject_flows"])
def test_shape_vector_for_sim_equals_reference(inject):
    vecs = []
    for pkg, mod in (("jax", jb), ("port", tb)):
        sim, _ = _attached(pkg, inject)
        b = packed(pkg, lanes=False, replicas=False,
                   inject_lanes=8 if inject else 0)
        vecs.append((mod.shape_vector_for_sim(b.cfg, sim),
                     mod.shape_vector(b.cfg, telem_capacity=64,
                                      lane_replicas=4, inject_lanes=8)))
    assert vecs[1] == vecs[0]
    want = {"flow_capacity", "flow_sample_period"} | (
        {"inject_lanes"} if inject else
        {"telem_capacity", "lane_replicas", "resident"})
    assert want <= set(vecs[1][0])


@pytest.mark.parametrize("counts", [[16], [3, 9, 16], [2, 2], [5, 100],
                                    [], [1, 8], [0]])
def test_lane_bucket_equals_reference(counts):
    out = []
    for mod in (jb, tb):
        try:
            out.append(mod.lane_bucket(counts))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    assert out[1] == out[0]


def test_kind_census_relations_equal_reference():
    """Same composition -> same digest; a handler, the bulk pass, the
    fault plan digest and `extra` each change it — in both packages."""
    def rel(mod, phold):
        other = (lambda *a: None)
        d = [mod.kind_census((phold.handler,), phold.BULK),
             mod.kind_census((phold.handler,), phold.BULK),
             mod.kind_census((phold.handler,)),
             mod.kind_census((phold.handler, other), phold.BULK),
             mod.kind_census((phold.handler,), phold.BULK,
                             fault_plan_digest="abc"),
             mod.kind_census((phold.handler,), phold.BULK,
                             extra={"x": 1})]
        assert all(len(x) == 16 for x in d)
        return [[a == b for b in d] for a in d]

    assert rel(tb, tphold) == rel(jb, jphold)


def test_program_key_relations_equal_reference():
    def keys(mod):
        shapes = {"event_capacity": 32, "num_hosts": 16, "tcp": False}
        k = [mod.program_key(shapes, census="c"),
             mod.program_key(dict(shapes), census="c"),
             mod.program_key(dict(shapes, event_capacity=64), census="c"),
             mod.program_key(shapes, census="c", chunk_windows=8),
             mod.program_key(shapes, census="c", extra={"caps": "no_loss"}),
             mod.program_key(shapes, census="d"),
             mod.program_key(shapes, census="c", adaptive=True,
                             end_time=SEC, min_jump=50)]
        assert all(mod.is_program_key(x) for x in k)
        return [[a == b for b in k] for a in k]

    assert keys(tb) == keys(jb)
    rel = keys(tb)
    assert rel[0][1] and not any(rel[0][2:])
    for bad in ("pk123", "PK" + "0" * 16, "pk" + "g" * 16, None,
                "pk" + "0" * 17):
        assert tb.is_program_key(bad) == jb.is_program_key(bad) is False
    assert tb.code_version() == tb.code_version()


# ------------------------------------------------------ bucketed runs


def _phold(pkg, bucketed):
    mod, C, dev, phold, bk = (
        (jbuild, JConfig, {}, jphold, jb) if pkg == "jax"
        else (tbuild, TConfig, {"device": "cpu"}, tphold, tb))
    cfg = C(num_hosts=16, tcp=False, end_time=SEC, seed=3, in_ring=8,
            **CAPS24)
    if bucketed:
        cfg, _ = bk.bucket_config(cfg)
    hosts = [mod.HostSpec(name=f"p{i}", proc_start_time=0)
             for i in range(16)]
    b = mod.build(cfg, ONE_VERTEX, hosts, **dev)
    b.sim = phold.setup(b.sim, load=4)
    runner = (mod.make_runner(b, app_handlers=(phold.handler,),
                              app_bulk=phold.BULK, **dev))
    sim, stats = runner(b.sim)
    if pkg == "jax":
        sim, stats = jax.device_get((sim, stats))
        leaves = jax_leaves(sim)
    else:
        leaves = convert.sim_to_numpy(sim)
    return leaves, {k: int(getattr(stats, k)) for k in (
        "events_processed", "windows", "micro_steps")}, b.cfg


def _live_events(leaves):
    """Per row, the sorted (time, kind, src, seq) of the pending events
    (their slots depend on the capacity, their values do not)."""
    t = leaves[".events.time"]
    rows = []
    for h in range(t.shape[0]):
        m = t[h] != simtime.INVALID
        rows.append(sorted(zip(t[h][m], leaves[".events.kind"][h][m],
                               leaves[".events.src"][h][m],
                               leaves[".events.seq"][h][m])))
    return rows


def test_bucketed_phold_run_equals_bespoke_and_reference():
    bespoke, bst, bcfg = _phold("port", False)
    got, gst, gcfg = _phold("port", True)
    want, wst, _ = _phold("jax", True)
    assert bcfg.event_capacity == 24 and gcfg.event_capacity == 32
    assert gst == bst == wst and gst["events_processed"] > 0
    assert_leaves_equal(want, got)
    assert int(got[".events.overflow"]) == 0
    # capacity-dependent by definition: the route's tier counters (at 24
    # columns the narrow tier is the whole outbox, so the route never
    # takes it or records its occupancy) and the router ring's head,
    # an index modulo its capacity
    same = [k for k in bespoke if bespoke[k].shape == got[k].shape
            and k not in (".outbox.narrow_hit", ".outbox.max_occupied",
                          ".net.rq_head")]
    assert ".net.rng_ctr" in same and ".app.rcvd" in same
    assert_leaves_equal(bespoke, got, keys=same)
    assert _live_events(bespoke) == _live_events(got)


# ---------------------------------------------------- escalation plans


@pytest.mark.parametrize("caps", [
    {"event_capacity": 24, "outbox_capacity": 8, "router_ring": 16},
    {"event_capacity": 1, "outbox_capacity": 33, "router_ring": 100},
])
def test_escalate_growth_plans_equal_reference(caps):
    from types import SimpleNamespace

    for latches in ({"events_overflow": 5}, {"outbox_overflow": 1,
                                             "rq_overflow": 2}):
        h = SimpleNamespace(**dict({"events_overflow": 0,
                                    "outbox_overflow": 0,
                                    "rq_overflow": 0}, **latches))
        out = []
        for esc in (jescalate, tescalate):
            grow, events = esc.plan_growth(
                h, dict(caps), esc.EscalationPolicy(max_grow=8), 0,
                time_ns=7)
            out.append((grow, [dataclasses.asdict(e) for e in events]))
        assert out[1] == out[0]
        assert all(v == tb.quantize_pow2(v) for v in out[1][0].values())
    for R in (1, 3, 7):
        assert tescalate.plan_lane_regrow(R, dict(caps)) == \
            jescalate.plan_lane_regrow(R, dict(caps))
