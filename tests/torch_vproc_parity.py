"""Helpers of the virtual-process parity tests (tests/test_torch_vproc*.py,
_reftests.py, _hostrun.py): a reference test module's cases run twice —
as written, on the JAX package, and rendered for the port (every
``shadow_tpu.`` becomes ``shadow_tpu_torch.``; every build, runner and
ProcessRuntime on the CPU) — and every ProcessRuntime a case makes is
kept, so a test can hold the port's runs against the reference's: the
final Sim leaf by leaf, EngineStats, the syscall and dispatch counts,
the syscall trace (raw, and normalized by each package's own
hostrun.trace.TraceRecorder) and the payload pool's counts. The
reference's own assertions run in both.

The reference's runtimes of one NetConfig (end_time aside: the window
program never reads it) share one jitted window, so a file compiles
each JAX program once.
"""

import contextlib
import dataclasses
import pathlib
import types

import numpy as np
import pytest
import torch

import shadow_tpu.process.vproc as jvproc
import shadow_tpu_torch.hostrun.runner as trunner
import shadow_tpu_torch.net.build as tbuild
import shadow_tpu_torch.process.vproc as tvproc
from shadow_tpu.config import loader as jloader
from shadow_tpu.config import xmlconfig as jxml
from shadow_tpu.hostrun.trace import TraceRecorder as JRecorder
from shadow_tpu_torch import convert
from shadow_tpu_torch.config import examples
from shadow_tpu_torch.config import loader as tloader
from shadow_tpu_torch.config import xmlconfig as txml
from shadow_tpu_torch.hostrun.trace import TraceRecorder as TRecorder
from torch_parity import assert_leaves_equal, jax_leaves

torch.set_num_threads(1)

TESTS = pathlib.Path(__file__).resolve().parent

# (NetConfig without end_time, handlers) -> the reference's jitted window
_JAX_WINDOWS: dict = {}


@dataclasses.dataclass
class RunRecord:
    """What one ProcessRuntime left behind."""

    leaves: dict
    stats: dict | None
    syscalls: int
    dispatches: int
    trace: dict
    raw: list
    pool: tuple


@dataclasses.dataclass
class CaseRun:
    """One case in one package: its error (None when it passed) and its
    runtimes in creation order."""

    error: BaseException | None
    runs: list


def _canon(v):
    """A trace value with functions named, for comparing across
    packages (a coroutine's thread and signal handlers are different
    function objects in each)."""
    if callable(v):
        return ("fn", getattr(v, "__qualname__", repr(v)))
    if isinstance(v, (list, tuple)):
        return tuple(_canon(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _canon(x)) for k, x in v.items()))
    if isinstance(v, (bytes, bytearray)):
        return bytes(v)
    if isinstance(v, (np.integer, np.bool_)):
        return v.item()
    return v


def _recorder(cls, bundle):
    return cls(ip_names={int(bundle.ip_of(n)): n for n in bundle.host_names})


def _recording(base, made, port):
    class Recording(base):
        def __init__(self, bundle, *args, **kw):
            if port:
                kw["device"] = kw.get("device") or "cpu"
            super().__init__(bundle, *args, **kw)
            if not port:
                handlers = kw.get("app_handlers", args[0] if args else ())
                key = (dataclasses.replace(self.cfg, end_time=0),
                       tuple(handlers))
                self._jit_window = _JAX_WINDOWS.setdefault(
                    key, self._jit_window)
            self.trace = _recorder(TRecorder if port else JRecorder, bundle)
            self.last = None
            made.append(self)

        def run(self, *args, **kw):
            self.last = super().run(*args, **kw)
            return self.last

    return Recording


def _on_cpu(fn):
    def wrapped(*args, device=None, **kw):
        return fn(*args, device=device or "cpu", **kw)
    return wrapped


@contextlib.contextmanager
def world(port: bool, made: list):
    """The reference (port=False) or the port with every entry point a
    case reaches on the CPU; the runtimes made inside land in `made`."""
    with pytest.MonkeyPatch.context() as mp:
        if port:
            mp.setattr(tbuild, "build", _on_cpu(tbuild.build))
            mp.setattr(tbuild, "run", _on_cpu(tbuild.run))
            mp.setattr(trunner, "build", _on_cpu(trunner.build))
            mp.setattr(tvproc, "ProcessRuntime",
                       _recording(tvproc.ProcessRuntime, made, True))
        else:
            mp.setattr(jvproc, "ProcessRuntime",
                       _recording(jvproc.ProcessRuntime, made, False))
        yield


def render(text: str, port: bool) -> str:
    """Reference source (a test module or a plugin template) for one
    package."""
    return text.replace("shadow_tpu.", "shadow_tpu_torch.") if port else text


def load_module(stem: str, port: bool):
    """A reference test module, executed for one package (call inside
    world(port, ...): its module-level imports bind there)."""
    path = TESTS / f"{stem}.py"
    mod = types.ModuleType(f"_{'port' if port else 'ref'}_{stem}")
    mod.__file__ = str(path)
    exec(compile(render(path.read_text(), port), str(path), "exec"),
         mod.__dict__)
    return mod


def record(rt, port: bool) -> RunRecord:
    sim = rt.sim
    leaves = convert.sim_to_numpy(sim) if port else jax_leaves(sim)
    stats = rt.last[1].as_dict() if rt.last is not None else None
    pool = rt.pool
    return RunRecord(
        leaves=leaves, stats=stats, syscalls=rt.stat_syscalls,
        dispatches=rt.stat_device_dispatches, trace=rt.trace.normalized(),
        raw=[_canon(r) for r in rt.trace._records],
        pool=(pool.total_allocs(), pool.live_bytes(), pool.live_refs()))


def run_case(port: bool, fn) -> CaseRun:
    """Run `fn(port)` in one package's world (port=False: the
    reference): its error, and a record of every runtime it made."""
    made: list = []
    err = None
    with world(port, made):
        try:
            fn(port)
        except Exception as e:  # noqa: BLE001 — the test reports it
            err = e
        runs = [record(rt, port) for rt in made]
    return CaseRun(error=err, runs=runs)


def run_module_cases(stem: str, names=None) -> dict:
    """{case name: (reference CaseRun, port CaseRun)} for the
    fixture-free test functions of tests/<stem>.py (or `names`)."""
    out = {}
    for port in (False, True):
        made: list = []
        with world(port, made):
            mod = load_module(stem, port)
        cases = names or sorted(
            n for n, f in vars(mod).items()
            if n.startswith("test_") and callable(f)
            and f.__code__.co_argcount == 0)
        for name in cases:
            def fn(_port, _stem=stem, _name=name):
                # each case in a fresh module: globals a case mutates
                # (logs, dicts) start clean, as under pytest
                getattr(load_module(_stem, _port), _name)()
            out.setdefault(name, [None, None])[int(port)] = run_case(port, fn)
    return {k: tuple(v) for k, v in out.items()}


def assert_runs_equal(ref: CaseRun, port: CaseRun, what: str) -> None:
    """The parity checks, one kind at a time (`what` in "state",
    "stats", "trace")."""
    assert ref.error is None, f"reference failed: {ref.error!r}"
    assert port.error is None, f"port failed: {port.error!r}"
    assert len(ref.runs) == len(port.runs), (len(ref.runs), len(port.runs))
    for i, (r, p) in enumerate(zip(ref.runs, port.runs)):
        if what == "state":
            assert_leaves_equal(r.leaves, p.leaves)
        elif what == "stats":
            assert (p.stats, p.syscalls, p.dispatches, p.pool) == \
                (r.stats, r.syscalls, r.dispatches, r.pool), i
        else:
            assert p.trace == r.trace, i
            assert p.raw == r.raw, i


# --- the reftests syscall plugins through both loaders -----------------

ONE = '<host id="testnode"><process plugin="p" starttime="1"/></host>'
# a reftests plugin name -> its hosts (one, or two for the plugins with
# the TCP stream hints)
REFTESTS = {
    "testbind": ONE,
    "libshadow-plugin-test-epoll.so": ONE,
    "test_epoll_writeable": (
        '<host id="testnode"><process plugin="p" starttime="1" '
        'arguments="server"/></host>\n  <host id="client"><process '
        'plugin="p" starttime="2" arguments="client testnode"/></host>'),
    "testpoll": ONE,
    "libshadow-plugin-test-sockbuf.so": ONE,
    "testtimerfd": ONE,
    "libshadow-plugin-test-sleep.so": ONE,
    "testshutdown": (
        '<host id="testnode"><process plugin="p" starttime="1"/></host>\n'
        '  <host id="other"><process plugin="p" starttime="2"/></host>'),
    "libshadow-plugin-test-file.so": ONE,
    "testrandom": ONE,
    "testsignal": ONE,
    "libshadow-plugin-test-pthreads.so": ONE,
    "test-unistd": ('<host id="testnode"><process plugin="p" starttime="1" '
                    'arguments="x testnode"/></host>'),
}


def reftests_config(name: str) -> str:
    return (f'<shadow stoptime="30">\n  <topology><![CDATA['
            f'{examples.EXAMPLE_GRAPHML}]]></topology>\n'
            f'  <plugin id="p" path="{name}"/>\n  {REFTESTS[name]}\n'
            f'</shadow>')


def run_reftests(name, port, out):
    """CaseRun of one reftests plugin's config in one package; `out`
    gains what the test checks beyond the runtime records."""
    def fn(_port):
        loader, xml, vp, kw = ((tloader, txml, tvproc, {"device": "cpu"})
                               if port else (jloader, jxml, jvproc, {}))
        loaded = loader.load(xml.parse_config(reftests_config(name)),
                             seed=7, **kw)
        rt = vp.ProcessRuntime(loaded.bundle, app_handlers=loaded.handlers,
                               **kw)
        for hi, f, st, sp in loaded.vprocs:
            rt.spawn(hi, f, start_time=st, stop_time=sp)
        sim, _ = rt.run()
        out[port] = {
            "cfg": dataclasses.asdict(loaded.bundle.cfg),
            "vprocs": [(h, st, sp) for h, _, st, sp in loaded.vprocs],
            "done": [p.done for p in rt.procs],
            "overflow": int(sim.events.overflow),
            "stdout": rt.stdio_of(rt.procs[0].host, rt.procs[0].pid, 1),
        }
    return run_case(port, fn)
