"""The traffic generator: the same schedule for the same seed, the same
multiset of requests for every seed, and lengths at the file's
distribution."""

import math
from collections import Counter

import numpy as np
import pytest

from perfbench import spec, traffic

MIXES = ("chat", "complete", "solo")


def _key(items):
    return [(it.segment, round(it.due, 9), it.prompt.tolist(), it.n_out,
             it.sampling) for it in items]


def _schedule(name, seed, seconds=20.0):
    mix = spec.traffic(name)
    if mix["kind"] == "open_loop":
        return traffic.open_loop(mix, seed, seconds, 32000)
    return traffic.closed_loop(mix, seed, 32000)


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_schedule(name):
    seed = 2 ** 31 + 12345
    assert _key(_schedule(name, seed)) == _key(_schedule(name, seed))
    assert _key(_schedule(name, seed)) != _key(_schedule(name, seed + 1))


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_serves_the_same_schedule(name):
    """Sizes, order and due times are the mix's; the seed draws ids."""
    def schedule(items):
        return [(it.segment, round(it.due, 9), len(it.prompt), it.n_out,
                 it.sampling) for it in items]
    a, b = _schedule(name, 7), _schedule(name, 2 ** 31 + 7)
    assert schedule(a) == schedule(b)
    assert any(x.prompt.tolist() != y.prompt.tolist() for x, y in zip(a, b))
    sizes = Counter((len(it.prompt), it.n_out) for it in a
                    if it.segment in ("win", "calls"))
    assert sum(sizes.values()) == len([it for it in a
                                      if it.segment in ("win", "calls")])


@pytest.mark.parametrize("name", ("chat", "complete"))
def test_open_loop_window_count_and_span(name):
    mix = spec.traffic(name)
    seconds = 30.0
    items = traffic.open_loop(mix, 99, seconds, 32000)
    win = [it for it in items if it.segment == "win"]
    assert len(win) == round(mix["rate_rps"] * seconds)
    pre = mix["preroll_s"]
    assert all(pre < it.due <= pre + seconds + 1e-9 for it in win)
    assert max(it.due for it in win) == pytest.approx(pre + seconds)
    assert [it.due for it in items] == sorted(it.due for it in items)
    assert all(traffic.ID_MARGIN <= t < 32000 - traffic.ID_MARGIN
               for it in win for t in it.prompt)


@pytest.mark.parametrize("name", MIXES)
def test_lengths_follow_the_file(name):
    mix = spec.traffic(name)
    for part in ("prompt", "output"):
        d = mix[part]
        x = traffic.lengths(d, 1001)
        assert x.min() >= d["min"] and x.max() <= d["max"]
        assert np.median(x) == pytest.approx(
            min(max(d["median"], d["min"]), d["max"]), rel=0.01)
        # the quartiles of a lognormal, where the clip does not reach
        for q, z in ((0.25, -0.6745), (0.75, 0.6745)):
            want = d["median"] * math.exp(d["sigma"] * z)
            if d["min"] < want < d["max"]:
                assert np.quantile(x, q) == pytest.approx(want, rel=0.02)


def test_gaps_are_exponential_quantiles_scaled_to_the_span():
    rng = np.random.default_rng(0)
    g = traffic.gaps(4.0, 400, 100.0, rng)
    assert g.sum() == pytest.approx(100.0)
    assert np.median(g) == pytest.approx(math.log(2) / 4.0, rel=0.02)
    assert traffic.gaps(4.0, 0, 1.0, rng).size == 0


def test_weights_layout_is_the_ports():
    """The benchmark's packed bytes unpack, by the port's own reader, to
    the codes its reference uses, and dequantize alike."""
    import torch

    from perfbench.model import model_from_config
    from perfbench.weights import Weights
    from tinychatengine_tpu_torch.ops import ref
    m = model_from_config("m", dict(
        spec.config("mistral_7b-w4a8"), hidden_size=256,
        intermediate_size=512, num_attention_heads=4, num_key_value_heads=2,
        vocab_size=512))
    w = Weights(m, 2 ** 31 + 3, "cpu")
    packed, scales = w.packed("down", 1)
    assert torch.equal(ref.unpack_int4(packed).to(torch.uint8),
                       w.codes("down", 1))
    assert torch.equal(ref.dequantize_int4(packed, scales, 128, torch.float32),
                       w.dense("down", 1))
