"""ProcessRuntime on a mesh in the port (process/vproc.py with `mesh`):
two gloo ranks, each running the coroutines of its own hosts, against
the single-device port and the reference, tolerance zero:

- tests/test_vproc_sharded.py's program (4 UDP client/server pairs):
  the same sorted log, the same events_processed, and every `sim.net`
  leaf equal to the reference's single-device run and the port's (the
  reference's own shard-count-invariance oracle);
- what the hosts share across ranks, each client talking to a server
  on the other rank: UDP datagrams with content through the payload
  pool (its ids ride packet words, so they are allocated in the
  single-device order), an echo run by a thread (its pid), and TCP
  streams both ways through the content FIFOs — the same log, events
  and every leaf as the port's single-device run (but the outbox's
  per-shard-count counters).

The reference's single-device run is the file's one JAX program; the
mesh cases run in one spawn of two ranks beside it.
"""

import jax
import numpy as np
import pytest
import torch

import torch_shard_ranks as R
from shadow_tpu_torch import convert
from shadow_tpu_torch.parallel import spawn
from test_vproc_sharded import _run as jrun
from torch_parity import side_by_side

torch.set_num_threads(1)

# the leaves the reference gives per shard count (parallel/shard.py)
PER_SHARD_COUNT = (".outbox.narrow_hit", ".outbox.narrow_miss",
                   ".outbox.max_occupied", ".outbox.route_elided")


@pytest.fixture(scope="module")
def runs():
    def single():
        out = {}
        for name, fn in (("udp_echo", R.vproc_udp_echo),
                         ("shared", R.vproc_shared)):
            log, ev, sim, *rest = fn(None)
            out[name] = (log, ev, convert.sim_to_numpy(sim), *rest)
        return out

    ref, mesh, port = side_by_side([
        lambda: jrun(mesh=None),
        lambda: spawn(R.vproc_cases, 2, deadline_s=300)[0],
        single])
    return {"ref": ref, "mesh": mesh, "port": port}


def _net(leaves):
    return {k: v for k, v in leaves.items() if k.startswith(".net.")}


def test_vproc_sharded_matches_reference(runs):
    jlog, jev, jsim = runs["ref"]
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jsim.net)[0]}
    for key in ("port", "mesh"):
        log, ev, leaves = runs[key]["udp_echo"]
        # the reference logs (host, n, t) with jax ints
        assert log == [tuple(int(x) for x in e) for e in jlog], key
        assert ev == int(jev)
        got = {k[len(".net"):]: v for k, v in _net(leaves).items()}
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{key} {k}")
    assert len(jlog) == R.VPROC_H


def test_vproc_sharded_state_matches_single_device(runs):
    """Both programs on 2 ranks: every leaf of the final state equals
    the single-device port's, but the per-shard-count counters."""
    for name in ("udp_echo", "shared"):
        want, got = runs["port"][name][2], runs["mesh"][name][2]
        assert sorted(want) == sorted(got)
        for k in sorted(set(want) - set(PER_SHARD_COUNT)):
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{name} {k}")


def test_shared_state_crosses_ranks(runs):
    """The shared program: every datagram answered with its content
    reversed and the server's host id, every TCP digest right, the
    thread pids the single-device ones, the pool drained, all equal to
    the single-device run."""
    log, ev, _, live = runs["mesh"]["shared"]
    want = runs["port"]["shared"]
    assert (log, ev, live) == (want[0], want[1], want[3])
    udp = [e for e in log if e[1] == "udp"]
    tcp = [e for e in log if e[1] == "tcp"]
    threads = [e for e in log if e[1] == "thread"]
    assert len(udp) == 4 and len(tcp) == 2 and len(threads) == 2
    n = R.VPROC_H // 2
    for host, _, data in udp:
        assert data[-1] == 2 * (n - 1 - host // 2) + 1, (host, data)
        assert data[:-1] in [(f"c{host}-{k}".encode() * 7)[::-1]
                             for k in (0, 1)], (host, data)
    assert all(ok for *_, ok in tcp)
    assert live == []
