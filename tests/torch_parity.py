"""Helpers shared by the lane-isolation and recorder parity tests
(tests/test_torch_lanes.py, _flows.py, _causality.py, _lanes_cli.py):
one packed PHOLD program built the same way in both packages, and the
leaf maps that hold one package's state against the other's;
side_by_side, which runs a fixture's independent reference runs at
once (tests/test_torch_qdisc.py, _parallel.py); and bench_in_process,
the port's bench entry point run in this process for the runs that end
in its argument and device checks (tests/test_torch_bench.py,
_lanes_cli.py)."""

import jax
import numpy as np

from shadow_tpu import telemetry as jtelemetry
from shadow_tpu.apps import phold as jphold
from shadow_tpu.core import lanes as jlanes
from shadow_tpu.net import build as jbuild
from shadow_tpu.net.state import NetConfig as JConfig
from shadow_tpu_torch import convert
from shadow_tpu_torch import telemetry as ttelemetry
from shadow_tpu_torch.apps import phold as tphold
from shadow_tpu_torch.bench import ONE_VERTEX
from shadow_tpu_torch.core import lanes as tlanes
from shadow_tpu_torch.net import build as tbuild
from shadow_tpu_torch.net.state import NetConfig as TConfig

SEC = 1_000_000_000


def packed(pkg, H=16, R=4, load=2, end=SEC, seed=1, cap=16, lanes=True,
           ring=True, flows=None, causality=None, sparse_lanes=None,
           replicas=True, active_hosts=None, inject_lanes=0):
    """bench.py's packed PHOLD (`replicas`: H/R-host replicas, R lanes
    when `lanes`; `active_hosts`: bench's sparse shape), capacities
    `cap`, `inject_lanes` injection staging lanes; the ring, and the flow and
    causality recorders as (sample period, capacity) pairs when given.
    `pkg` is "jax" or "port" (on the CPU)."""
    jax_side = pkg == "jax"
    mod = jbuild if jax_side else tbuild
    C = JConfig if jax_side else TConfig
    cfg = C(num_hosts=H, tcp=False, end_time=end, seed=seed,
            event_capacity=cap, outbox_capacity=cap, router_ring=cap,
            in_ring=max(16, 2 * load), sparse_lanes=sparse_lanes,
            inject_lanes=inject_lanes)
    hosts = [mod.HostSpec(name=f"peer{i}", proc_start_time=0)
             for i in range(H)]
    kw = {} if jax_side else {"device": "cpu"}
    b = mod.build(cfg, ONE_VERTEX, hosts, **kw)
    app, tel, ln = ((jphold, jtelemetry, jlanes) if jax_side
                    else (tphold, ttelemetry, tlanes))
    b.sim = app.setup(b.sim, load=load,
                      replica_size=H // R if replicas else None,
                      active_hosts=active_hosts)
    if lanes:
        b.sim = ln.attach(b.sim, R)
    if ring:
        b.sim = tel.attach(b.sim)
    if flows is not None:
        b.sim = tel.attach_flows(b.sim, sample_period=flows[0],
                                 capacity=flows[1])
    if causality is not None:
        b.sim = tel.attach_causality(b.sim, sample_period=causality[0],
                                     capacity=causality[1])
    return b


def jax_leaves(sim) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(sim)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def to_jax(port_sim, jax_template):
    """The port Sim's state in the reference's classes: the template
    (same leaf set) gives the structure and the static fields."""
    leaves = convert.sim_to_numpy(port_sim)
    flat, treedef = jax.tree_util.tree_flatten_with_path(jax_template)
    keys = [jax.tree_util.keystr(p) for p, _ in flat]
    assert sorted(keys) == sorted(leaves), \
        sorted(set(keys) ^ set(leaves))
    return jax.tree_util.tree_unflatten(
        treedef, [jax.numpy.asarray(leaves[k]) for k in keys])


def assert_leaves_equal(want: dict, got: dict, keys=None):
    """Every leaf (or those in `keys`) equal, dtype included."""
    if keys is None:
        assert sorted(want) == sorted(got), \
            sorted(set(want) ^ set(got))
        keys = sorted(want)
    for k in keys:
        assert want[k].dtype == got[k].dtype, (k, want[k].dtype,
                                               got[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def side_by_side(fns):
    """The results of the zero-argument callables `fns`, run in threads
    at once: a fixture's independent reference programs compile side by
    side (XLA compiles with the interpreter lock released). Raises the
    first exception a call raised."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(fns)) as pool:
        futures = [pool.submit(f) for f in fns]
        return [f.result() for f in futures]


def bench_in_process(*argv, **env):
    """`python -m shadow_tpu_torch.bench ARGV` with the BENCH_* environment
    `env` (None: unset) but in this process, for a run that ends in the
    module's argument and device checks: a CompletedProcess of the exit
    status, standard output and errors the subprocess gives (SystemExit
    with a message: status 1 and the message on stderr)."""
    import contextlib
    import io
    import os
    import subprocess

    import pytest

    from shadow_tpu_torch import bench as tbench

    out, err = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        for k in [k for k in os.environ if k.startswith("BENCH_")]:
            mp.delenv(k)
        for k, v in env.items():
            if v is None:
                mp.delenv(k, raising=False)
            else:
                mp.setenv(k, v)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                code = tbench.main(list(argv))
            except SystemExit as e:
                code = e.code
    if isinstance(code, str):
        err.write(code + "\n")
        code = 1
    return subprocess.CompletedProcess(["-m", "shadow_tpu_torch.bench", *argv],
                                       code or 0, out.getvalue(),
                                       err.getvalue())
