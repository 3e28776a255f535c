"""Parity of the port's TCP echo app (shadow_tpu_torch.apps.echo, the
`testtcp` plugin) with the reference's, through each package's config
loader: the reference's dual-mode tcp test shape (test_tcp.c: a client
streams 20,000 bytes, the server echoes them back), lossless and over a
0.25-packetloss self-loop (the reference's tcp-blocking-lossy config),
seed 7. Boot state, EngineStats and every final leaf equal (tolerance
zero), and both echoes complete.

One JAX TCP program: the two configs differ only in the reliability
table (state), so the reference's runner is built once and runs both.
"""

import jax
import numpy as np
import pytest
import torch

from shadow_tpu.config import loader as jloader
from shadow_tpu.config import xmlconfig as jxml
from shadow_tpu.net import build as jbuild
from shadow_tpu_torch import convert
from shadow_tpu_torch.apps import echo as techo
from shadow_tpu_torch.config import examples
from shadow_tpu_torch.config import loader as tloader
from shadow_tpu_torch.config import xmlconfig as txml
from shadow_tpu_torch.net import build as tbuild

torch.set_num_threads(1)

SEED = 7


def _config(loss: float, mode: str) -> str:
    graph = examples.EXAMPLE_GRAPHML.replace(
        '<data key="d4">0.0</data>', f'<data key="d4">{loss}</data>')
    return f'''<shadow stoptime="20">
  <topology><![CDATA[{graph}]]></topology>
  <plugin id="testtcp" path="shadow-plugin-test-tcp"/>
  <host id="testserver">
    <process plugin="testtcp" starttime="1" arguments="{mode} server"/>
  </host>
  <host id="testclient">
    <process plugin="testtcp" starttime="2"
      arguments="{mode} client testserver"/>
  </host>
</shadow>'''


CASES = {"lossless": _config(0.0, "blocking"),
         "lossy": _config(0.25, "nonblocking-epoll")}


def _jax_leaves(sim):
    flat, _ = jax.tree_util.tree_flatten_with_path(sim)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _assert_leaves_equal(want, got):
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].dtype == got[k].dtype, (k, want[k].dtype, got[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def runs():
    jl = {n: jloader.load(jxml.parse_config(t), seed=SEED)
          for n, t in CASES.items()}
    first = jl["lossless"]
    assert jl["lossy"].bundle.cfg == first.bundle.cfg
    runner = jbuild.make_runner(first.bundle, app_handlers=first.handlers)
    out = {}
    for name, text in CASES.items():
        jb = jl[name].bundle
        boot = _jax_leaves(jb.sim)
        jsim, jstats = runner(jb.sim)
        tl = tloader.load(txml.parse_config(text), seed=SEED, device="cpu")
        assert tl.handlers == (techo.handler,)
        tboot = convert.sim_to_numpy(tl.bundle.sim)
        tsim, tstats = tbuild.run(tl.bundle, app_handlers=tl.handlers,
                                  device="cpu")
        out[name] = {"boot": (boot, tboot),
                     "stats": (jstats.as_dict(), tstats.as_dict()),
                     "final": (_jax_leaves(jsim), convert.sim_to_numpy(tsim))}
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_boot_state_matches_reference(runs, name):
    _assert_leaves_equal(*runs[name]["boot"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_stats_match_reference(runs, name):
    want, got = runs[name]["stats"]
    assert got == want


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_every_leaf_matches_reference(runs, name):
    _assert_leaves_equal(*runs[name]["final"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_echo_completes(runs, name):
    """tests/test_reference_configs.py's checks on the port: the server
    drained and echoed BUFFERSIZE bytes, the client got them back and
    closed; the lossy run retransmitted."""
    leaves = runs[name]["final"][1]
    cli, srv = leaves[".app.is_client"], leaves[".app.is_server"]
    assert cli.sum() == 1 and srv.sum() == 1
    assert leaves[".app.s_rcvd"][srv].min() == techo.BUFFERSIZE
    assert leaves[".app.s_echoed"][srv].min() == techo.BUFFERSIZE
    assert leaves[".app.c_rcvd"][cli].min() == techo.BUFFERSIZE
    assert leaves[".app.c_closed"][cli].all()
    assert int(leaves[".events.overflow"]) == 0
    retx = int(leaves[".tcp.retx_segs"].sum())
    assert (retx > 0) == (name == "lossy")
