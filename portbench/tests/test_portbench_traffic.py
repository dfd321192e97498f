"""The traffic is a function of the seed: the same seed makes the same
frames and speeds, another seed others, with the same pairs and cuts."""

from __future__ import annotations

import json

import pytest
import torch

from portbench import harness
from portbench.streams import Streams
from portbench.weights import make

MIXES = sorted(p.stem for p in (harness.ROOT / "traffic").glob("*.json"))


def _mix(name):
    return dict(json.loads((harness.ROOT / "traffic" / f"{name}.json").read_text()), pool=4)


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_frames_other_seed_others(name):
    big = 2 ** 31 + 977  # past 32 signed bits, as the driver's seeds are
    a, b, c = (Streams(_mix(name), s, (36, 64), "cpu") for s in (big, big, big + 1))
    assert torch.equal(a.frames, b.frames) and a.pans == b.pans
    assert not torch.equal(a.frames, c.frames) and a.pans != c.pans
    lo, hi = _mix(name)["pan_px"]
    assert all(lo <= p <= hi for p in a.pans)
    assert [a.indices(g) for g in range(8)] == [c.indices(g) for g in range(8)]


def test_cuts_one_pair_in_the_pool_per_stream():
    s = Streams(dict(_mix("streams4"), pool=8), 5, (36, 64), "cpu")
    assert s.period == 16
    cut_pairs = sum(i % 8 == 7 for g in range(16) for i in s.indices(g))
    assert cut_pairs == 2 * s.n
    assert sum(s.is_cut(g) for g in range(16)) == 8  # the streams cut on different steps


def test_weights_same_seed_same_values():
    shapes = [("a.Conv_0.weight", (4, 3, 3, 3)), ("a.Conv_0.bias", (4,)),
              ("b.s6_fwd.A_log", (2, 16)), ("b.LayerNorm_0.weight", (4,))]
    w1, w2, w3 = make(shapes, 11, "cpu"), make(shapes, 11, "cpu"), make(shapes, 12, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert not torch.equal(w1["a.Conv_0.weight"], w3["a.Conv_0.weight"])
    assert float(w1["a.Conv_0.weight"].abs().max()) <= 1 / 27 ** 0.5
    assert torch.allclose(w1["b.s6_fwd.A_log"].mean(0),
                          torch.log(torch.arange(1, 17.0)), atol=0.1)
    assert float((w1["b.LayerNorm_0.weight"] - 1).abs().max()) <= 0.1
