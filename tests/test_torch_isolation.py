"""The port stands alone: importing every module of shadow_tpu_torch
pulls in neither jax, flax nor shadow_tpu (checked in a fresh
interpreter), and its entry points never fall back to the CPU when
CUDA is missing."""

import json
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, json, pkgutil, sys
import shadow_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    shadow_tpu_torch.__path__, "shadow_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "shadow_tpu"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_import_pulls_in_no_jax_and_no_reference():
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    for mod in ("shadow_tpu_torch.core.events", "shadow_tpu_torch.net.nic",
                "shadow_tpu_torch.core.insert_kernels",
                "shadow_tpu_torch.convert", "shadow_tpu_torch.net.bulk",
                "shadow_tpu_torch.core.compact",
                "shadow_tpu_torch.telemetry.ring",
                "shadow_tpu_torch.telemetry.harvest",
                "shadow_tpu_torch.net.tcp", "shadow_tpu_torch.net.tcp_cong",
                "shadow_tpu_torch.apps.relay",
                "shadow_tpu_torch.apps.gossip",
                "shadow_tpu_torch.net.tcp_bulk",
                "shadow_tpu_torch.apps.pingpong",
                "shadow_tpu_torch.utils.checkpoint",
                "shadow_tpu_torch.telemetry.causality",
                "shadow_tpu_torch.bench",
                "shadow_tpu_torch.faults",
                "shadow_tpu_torch.faults.plan",
                "shadow_tpu_torch.faults.apply",
                "shadow_tpu_torch.faults.health",
                "shadow_tpu_torch.faults.escalate",
                "shadow_tpu_torch.faults.conserve",
                "shadow_tpu_torch.faults.supervisor",
                "shadow_tpu_torch.cli",
                "shadow_tpu_torch.config.xmlconfig",
                "shadow_tpu_torch.config.examples",
                "shadow_tpu_torch.config.loader",
                "shadow_tpu_torch.apps.bulk",
                "shadow_tpu_torch.apps.echo",
                "shadow_tpu_torch.apps.randdump",
                "shadow_tpu_torch.apps.ring",
                "shadow_tpu_torch.utils.shadowlog",
                "shadow_tpu_torch.utils.objcount",
                "shadow_tpu_torch.utils.tracker", *INJECTION, *LANES,
                *COMPILE, *OBSERVE, *VPROC, *PARALLEL, *FLEET, *SWEEP):
        assert mod in out["modules"]


# the injection slice's modules, each also imported alone
INJECTION = ("shadow_tpu_torch.inject", "shadow_tpu_torch.inject.trace",
             "shadow_tpu_torch.inject.staging",
             "shadow_tpu_torch.inject.feeder", "shadow_tpu_torch.apps.tgen",
             "shadow_tpu_torch.telemetry.export")


# the lane-isolation and recorder slice's modules
LANES = ("shadow_tpu_torch.core.lanes", "shadow_tpu_torch.telemetry.flows",
         "shadow_tpu_torch.telemetry.causality")


# the specialization and bucket slice's modules
COMPILE = ("shadow_tpu_torch.compile", "shadow_tpu_torch.compile.buckets",
           "shadow_tpu_torch.compile.specialize",
           "shadow_tpu_torch.compile.store", "shadow_tpu_torch.compile.serve",
           "shadow_tpu_torch.utils.compcache")


# the netstack observability slice's host modules
OBSERVE = ("shadow_tpu_torch.native", "shadow_tpu_torch.native.tally",
           "shadow_tpu_torch.native.pool", "shadow_tpu_torch.utils.pcap")


# the virtual-process slice's modules
VPROC = ("shadow_tpu_torch.process", "shadow_tpu_torch.process.vproc",
         "shadow_tpu_torch.apps.reftests", "shadow_tpu_torch.hostrun",
         "shadow_tpu_torch.hostrun.diff", "shadow_tpu_torch.hostrun.executor",
         "shadow_tpu_torch.hostrun.kernel", "shadow_tpu_torch.hostrun.runner",
         "shadow_tpu_torch.hostrun.trace")


# the sharded window loop's modules
PARALLEL = ("shadow_tpu_torch.parallel", "shadow_tpu_torch.parallel.shard",
            "shadow_tpu_torch.parallel.elastic")


# the warm-serving slice's fleet modules
FLEET = ("shadow_tpu_torch.fleet", "shadow_tpu_torch.fleet.journal",
         "shadow_tpu_torch.fleet.spec", "shadow_tpu_torch.fleet.state",
         "shadow_tpu_torch.fleet.affinity", "shadow_tpu_torch.fleet.manifest",
         "shadow_tpu_torch.fleet.scenario", "shadow_tpu_torch.fleet.worker",
         "shadow_tpu_torch.fleet.runner", "shadow_tpu_torch.fleet.cli",
         "shadow_tpu_torch.fleet.admission", "shadow_tpu_torch.fleet.__main__")


# the sweep slice's modules, and the profiler capture
SWEEP = ("shadow_tpu_torch.sweep", "shadow_tpu_torch.sweep.plan",
         "shadow_tpu_torch.sweep.reduce", "shadow_tpu_torch.sweep.search",
         "shadow_tpu_torch.sweep.driver", "shadow_tpu_torch.sweep.cli",
         "shadow_tpu_torch.telemetry.profile")


# {module: (exit code, stdout, stderr)} of each module's fresh
# interpreter, filled for every module at the first use
_ALONE: dict = {}
# fresh interpreters run at once (each imports torch)
_ALONE_AT_ONCE = 6


def _probe_alone(mods) -> dict:
    """Import each module alone in a fresh interpreter, _ALONE_AT_ONCE
    at a time; {module: (exit code, stdout, stderr)}."""
    out, todo, live = {}, list(mods), []
    while todo or live:
        while todo and len(live) < _ALONE_AT_ONCE:
            mod = todo.pop(0)
            probe = (f"import importlib, json, sys; "
                     f"importlib.import_module({mod!r}); print(json.dumps("
                     "sorted(m for m in sys.modules if m.split('.')[0] in "
                     "('jax', 'jaxlib', 'flax', 'shadow_tpu'))))")
            live.append((mod, subprocess.Popen(
                [sys.executable, "-c", probe], cwd=ROOT, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE)))
        mod, p = live.pop(0)
        stdout, stderr = p.communicate(timeout=300)
        out[mod] = (p.returncode, stdout, stderr)
    return out


def _imports_alone(mod):
    if not _ALONE:
        _ALONE.update(_probe_alone(INJECTION + LANES + COMPILE + OBSERVE
                                   + VPROC + PARALLEL + FLEET + SWEEP))
    code, stdout, stderr = _ALONE[mod]
    assert code == 0, stderr
    assert json.loads(stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("mod", INJECTION)
def test_injection_module_imports_alone_without_jax(mod):
    _imports_alone(mod)


@pytest.mark.parametrize("mod", LANES)
def test_lane_module_imports_alone_without_jax(mod):
    _imports_alone(mod)


@pytest.mark.parametrize("mod", COMPILE)
def test_compile_module_imports_alone_without_jax(mod):
    _imports_alone(mod)


@pytest.mark.parametrize("mod", OBSERVE)
def test_observe_module_imports_alone_without_jax(mod):
    _imports_alone(mod)


@pytest.mark.parametrize("mod", VPROC)
def test_vproc_module_imports_alone_without_jax(mod):
    _imports_alone(mod)


@pytest.mark.parametrize("mod", PARALLEL)
def test_parallel_module_imports_alone_without_jax(mod):
    _imports_alone(mod)


@pytest.mark.parametrize("mod", FLEET)
def test_fleet_module_imports_alone_without_jax(mod):
    _imports_alone(mod)


@pytest.mark.parametrize("mod", SWEEP)
def test_sweep_module_imports_alone_without_jax(mod):
    _imports_alone(mod)


def test_sweep_driver_needs_cuda_by_default(tmp_path):
    """A sweep runs its fleet and its prewarm on the card unless the
    caller asks for the CPU: without CUDA the default prewarm raises
    before any worker starts, and no point moves to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behavior without a CUDA device")
    from shadow_tpu_torch.sweep.driver import SweepDriver
    from shadow_tpu_torch.sweep.plan import SweepSpec

    spec = SweepSpec.from_obj({
        "sweep": {"id": "c"},
        "template": {"kind": "scenario", "hosts": 4, "load": 1,
                     "sim_s": 1},
        "axes": [{"field": "seed", "values": [1, 2]}]})
    drv = SweepDriver(str(tmp_path / "s"), spec, fsync=False)
    assert drv.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        drv.run()
    assert not (tmp_path / "s" / "journal.log").exists()
    assert SweepDriver(str(tmp_path / "c"), spec, fsync=False,
                       device="cpu").device == "cpu"


def test_sharded_fleet_job_needs_cuda_by_default(tmp_path):
    """A sharded job leases its ranks on the card unless the fleet asks
    for the CPU: without CUDA it fails visibly before starting any rank."""
    if torch.cuda.is_available():
        pytest.skip("checks the behavior without a CUDA device")
    from shadow_tpu_torch.fleet.scenario import RANK_FILE, run_job
    from shadow_tpu_torch.fleet.spec import JobSpec

    spec = JobSpec(id="m", kind="scenario", seed=1, hosts=4, load=1,
                   sim_s=1, shards=2)
    res = run_job(spec, str(tmp_path / "m"))
    assert res["ok"] is False and "CUDA" in res["error"]
    assert not (tmp_path / "m" / RANK_FILE).exists()


def test_fleet_job_needs_cuda_by_default(tmp_path):
    """A fleet job runs on the card unless the fleet asks for the CPU:
    without CUDA the default fails the job visibly (an error in its
    result, ok false), it never moves to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behavior without a CUDA device")
    from shadow_tpu_torch.fleet.scenario import run_job
    from shadow_tpu_torch.fleet.spec import JobSpec

    spec = JobSpec(id="j", kind="scenario", seed=1, hosts=4, load=1,
                   sim_s=1)
    res = run_job(spec, str(tmp_path / "j"))
    assert res["ok"] is False and "CUDA" in res["error"]
    assert json.loads((tmp_path / "j" / "result.json").read_text()) == res


def test_mesh_needs_cuda_by_default():
    """A Mesh's rank device is the card unless the caller asks for the
    CPU: without CUDA the default raises (no quiet gloo-on-CPU mesh),
    and a wider mesh needs its rendezvous."""
    if torch.cuda.is_available():
        pytest.skip("checks the behavior without a CUDA device")
    from shadow_tpu_torch.parallel import Mesh

    with pytest.raises(RuntimeError, match="CUDA"):
        Mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        Mesh(2, 0, init_method="tcp://127.0.0.1:1")
    m = Mesh(device="cpu")
    assert (m.size, m.rank, m.device.type, m.backend) == (1, 0, "cpu", None)
    with pytest.raises(ValueError, match="init_method"):
        Mesh(2, 0, device="cpu")
    with pytest.raises(ValueError, match="timeout"):
        Mesh(device="cpu", timeout_s=600)


def test_native_library_builds_without_the_reference():
    """The port's native library loads from the port's own build, in a
    process that never imports shadow_tpu."""
    probe = ("import json, sys; from shadow_tpu_torch import native; "
             "lib = native.require(); print(json.dumps([native."
             "library_path(), sorted(m for m in sys.modules if m.split('.')"
             "[0] in ('jax', 'jaxlib', 'flax', 'shadow_tpu'))]))")
    r = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    path, bad = json.loads(r.stdout.strip().splitlines()[-1])
    assert bad == [] and "shadow_tpu_torch/_build/" in path


def test_program_key_hashes_torch_not_jax():
    """The port's program key reads torch's version; computing it pulls
    in no jax (the reference's imports jax inside program_key)."""
    probe = ("import json, sys; from shadow_tpu_torch.compile import "
             "buckets; k = buckets.program_key({'num_hosts': 4}); "
             "print(json.dumps([buckets.is_program_key(k), sorted(m for m "
             "in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
             "'flax', 'shadow_tpu'))]))")
    r = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == [True, []]


@pytest.mark.parametrize("make", ["lanes", "admission", "flows",
                                  "causality"])
def test_new_state_defaults_to_cuda(make):
    """The lane and recorder planes are built on the card unless the
    caller names the CPU, like every other entry point."""
    if torch.cuda.is_available():
        pytest.skip("checks the behavior without a CUDA device")
    from shadow_tpu_torch.core import lanes
    from shadow_tpu_torch.telemetry import causality, flows

    create = {"lanes": lambda **kw: lanes.LaneHealth.create(4, **kw),
              "admission": lambda **kw: lanes.LaneAdmission.create(4, **kw),
              "flows": lambda **kw: flows.FlowRing.create(**kw),
              "causality": lambda **kw: causality.CausalityState.create(
                  4, **kw)}[make]
    with pytest.raises(RuntimeError, match="CUDA"):
        create()
    state = create(device="cpu")
    assert all(t.device.type == "cpu" for t in vars(state).values()
               if isinstance(t, torch.Tensor))


def test_lane_isolated_sim_crosses_into_the_port_classes():
    """convert takes every new container by its field names, keeps the
    static fields of a template, and round-trips the uint64 keys."""
    import numpy as np

    from shadow_tpu_torch import convert, telemetry
    from shadow_tpu_torch.core import lanes

    b = _tiny_build(device="cpu")
    sim = lanes.admit_all(lanes.attach_admission(lanes.attach(b.sim, 2)))
    sim = telemetry.attach(sim, capacity=8)
    sim = telemetry.attach_flows(sim, sample_period=5, capacity=16)
    sim = telemetry.attach_causality(sim, sample_period=3, capacity=4)
    sim = sim.replace(causality=sim.causality.replace(
        key=sim.causality.key - 1))             # all ones: 2**64 - 1
    leaves = convert.sim_to_numpy(sim)
    assert leaves[".causality.key"].dtype == np.uint64
    assert int(leaves[".causality.key"].max()) == 2**64 - 1
    back = convert.sim_from_numpy(leaves, device="cpu", template=sim)
    for name, cls in (("lanes", lanes.LaneHealth),
                      ("admission", lanes.LaneAdmission),
                      ("flows", telemetry.FlowRing),
                      ("causality", telemetry.CausalityState)):
        assert type(getattr(back, name)) is cls
    assert back.flows.sample_period == 5
    assert back.causality.sample_period == 3
    assert back.telem.lane_events.shape == (8, 2)
    assert bool((back.causality.key == -1).all())
    for k, v in convert.sim_to_numpy(back).items():
        np.testing.assert_array_equal(v, leaves[k], err_msg=k)
    # without a template the static fields take their defaults
    assert convert.sim_from_numpy(leaves, device="cpu").flows.sample_period \
        == telemetry.DEFAULT_SAMPLE_PERIOD


def test_each_app_state_crosses_into_its_own_class():
    """convert picks the app class by its field names: each app's full
    leaf set (and its required fields alone) matches exactly one
    class."""
    import dataclasses

    from shadow_tpu_torch import convert

    classes = convert._SIM_FIELDS["app"]
    for cls in classes:
        fields = dataclasses.fields(cls)
        for keys in ({f.name for f in fields},
                     {f.name for f in fields
                      if f.default is dataclasses.MISSING}):
            assert convert._container("app", keys) is cls
            required = [c for c in classes if {
                f.name for f in dataclasses.fields(c)
                if f.default is dataclasses.MISSING} <= keys <= {
                f.name for f in dataclasses.fields(c)}]
            assert required == [cls]


def _tiny_build(**kw):
    from shadow_tpu_torch.net.build import HostSpec, build
    from shadow_tpu_torch.net.state import NetConfig

    graph = (ROOT / "tests" / "test_torch_phold.py").read_text().split(
        'ONE_VERTEX = """')[1].split('"""')[0]
    cfg = NetConfig(num_hosts=2, tcp=False)
    return build(cfg, graph, [HostSpec(name="a"), HostSpec(name="b")], **kw)


def test_entry_points_default_to_cuda_and_never_fall_back():
    if torch.cuda.is_available():
        pytest.skip("checks the behavior without a CUDA device")
    from shadow_tpu_torch.net.build import make_runner, run

    with pytest.raises(RuntimeError, match="CUDA"):
        _tiny_build()
    b = _tiny_build(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_runner(b)
    with pytest.raises(RuntimeError, match="CUDA"):
        run(b)


def test_sim_from_numpy_defaults_to_cuda():
    """Carrying state across builds on the card unless the caller asks
    for the CPU, like every other entry point."""
    if torch.cuda.is_available():
        pytest.skip("checks the behavior without a CUDA device")
    from shadow_tpu_torch import convert

    leaves = convert.sim_to_numpy(_tiny_build(device="cpu").sim)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.sim_from_numpy(leaves)
    sim = convert.sim_from_numpy(leaves, device="cpu")
    assert sim.events.time.device.type == "cpu"


def test_tcp_bulk_runner_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("checks the behavior without a CUDA device")
    from shadow_tpu_torch.apps.relay import TCP_BULK
    from shadow_tpu_torch.net.build import make_runner, run

    b = _tiny_build(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_runner(b, app_tcp_bulk=TCP_BULK)
    with pytest.raises(RuntimeError, match="CUDA"):
        run(b, app_tcp_bulk=TCP_BULK, tcp_bulk_lossless=True)


def test_process_runtime_needs_cuda_by_default():
    """ProcessRuntime is a runner: without a device it is the card, and
    without CUDA it raises rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behavior without a CUDA device")
    from shadow_tpu_torch.process.vproc import ProcessRuntime

    b = _tiny_build(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ProcessRuntime(b)
    assert ProcessRuntime(b, device="cpu").device.type == "cpu"
