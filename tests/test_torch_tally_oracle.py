"""The tally oracle of tests/test_tally_oracle.py on the port: the port's
device TCP scoreboard (net/tcp.py sack_clip_len over the 3-range
advertised SACK list) against the port's native interval tally
(native/tally.py, built from native/src/retransmit_tally.cc).

The reference test's drivers run unchanged with the port's two
components swapped in. Each device decision is also held to the
reference's sack_clip_len on the same inputs, and each tally query to
the reference's tally fed the same operations, so the port agrees with
the reference as well as with itself. Tolerance: zero."""

import numpy as np
import pytest
import torch

import test_tally_oracle as ref
from shadow_tpu.native.tally import RetransmitTally as JTally
from shadow_tpu_torch.net import tcp as ttcp
from shadow_tpu_torch.native.tally import RetransmitTally as TTally

torch.set_num_threads(1)

_REF_CLIP = ref._device_clip


def _port_clip(una, proposed, adv):
    """tcp.sack_clip_len of the port on one lane, checked against the
    reference's decision."""
    S = 3
    sl = torch.zeros((1, S), dtype=torch.int32)
    sr = torch.zeros((1, S), dtype=torch.int32)
    for i, (b, e) in enumerate(adv):
        sl[0, i], sr[0, i] = b, e
    got = int(ttcp.sack_clip_len(
        torch.tensor([una], dtype=torch.int32),
        torch.tensor([proposed], dtype=torch.int32), sl, sr)[0])
    assert got == _REF_CLIP(una, proposed, adv), (una, proposed, adv)
    return got


class _CheckedTally:
    """The port's native tally, with the reference's tally fed the same
    operations and every answer compared."""

    def __init__(self, snd_una=0):
        self.port, self.ref = TTally(snd_una), JTally(snd_una)
        assert self.port.native

    def __getattr__(self, name):
        def call(*args):
            got = getattr(self.port, name)(*args)
            assert got == getattr(self.ref, name)(*args), (name, args)
            return got
        return call


@pytest.fixture
def port_components(monkeypatch):
    monkeypatch.setattr(ref, "RetransmitTally", _CheckedTally)
    monkeypatch.setattr(ref, "_device_clip", _port_clip)


@pytest.mark.parametrize("seed", [0, 2])
@pytest.mark.parametrize("loss", [0.2, 0.45])
def test_device_scoreboard_matches_interval_tally(port_components, seed,
                                                  loss):
    ref.test_device_scoreboard_matches_interval_tally(seed, loss)


@pytest.mark.parametrize("seed", [1, 4])
@pytest.mark.parametrize("loss", [0.15, 0.55])
@pytest.mark.parametrize("reorder", [False, True])
def test_full_retransmission_sequence_equivalence(port_components, seed,
                                                  loss, reorder):
    ref.test_full_retransmission_sequence_equivalence(seed, loss, reorder)


def test_oracle_agreement_under_many_parked_ranges(port_components):
    ref.test_oracle_agreement_under_many_parked_ranges()


def test_the_port_components_were_used(port_components):
    """The drivers above ran on the port's tally and clip."""
    assert ref.RetransmitTally is _CheckedTally
    assert ref._device_clip is _port_clip
    rng = np.random.default_rng(5)
    nseg = 30
    delivered = rng.random(nseg) >= 0.3
    order = list(range(nseg))
    assert ref._run_recovery("device", nseg, delivered, order) \
        == ref._run_recovery("tally", nseg, delivered, order)
