"""The port's prompt-lookup decoding (generation/speculative.py) on the CPU:
the draft lookup against JAX's on random histories, generate_pld against
the port's greedy generate_device and JAX's generate_pld on one tiny
model, acceptance on repetitive prompts, and multi-turn continuation
through the returned cache (both exits of the loop)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinychatengine_tpu.core.config import ModelConfig as JModelConfig
from tinychatengine_tpu.core.config import QuantConfig as JQuantConfig
from tinychatengine_tpu.generation import speculative as jspec
from tinychatengine_tpu.generation.engine import Engine as JEngine
from tinychatengine_tpu.models import llama as jllama
from tinychatengine_tpu.tools import checkpoint as jckpt
from tinychatengine_tpu_torch.core.config import (GenerationConfig,
                                                  ModelConfig, QuantConfig)
from tinychatengine_tpu_torch.generation import speculative as spec
from tinychatengine_tpu_torch.generation.engine import Engine
from tinychatengine_tpu_torch.models import llama

TINY = dict(name="tiny", family="llama", num_heads=4, num_kv_heads=2,
            num_layers=2, max_sqlen=256, embed_dim=128, hidden_dim=256,
            vocab_size=256, rms_norm_eps=1e-5)
GREEDY = GenerationConfig(temp=0.0, n_predict=24, repeat_penalty=1.0,
                          repeat_last_n=1)
PROMPTS = ([5, 9, 11, 42], [7, 3, 7, 3, 7, 3, 7, 3], list(range(30, 60)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """The JAX package's tiny model and the port's copy of its weights."""
    jcfg, jq = JModelConfig(**TINY), JQuantConfig(scheme="fp")
    jp = jllama.init_random_params(jcfg, jq, seed=0)
    cfg, q = ModelConfig(**TINY), QuantConfig(scheme="fp")
    tp = llama.params_from_numpy(jckpt._flatten(jp)[0], cfg, q, device="cpu")
    return (jp, jcfg, jq), (tp, cfg, q)


def _engine(models):
    tp, cfg, q = models[1]
    return Engine(tp, cfg, q, batch=1, device="cpu")


@pytest.mark.parametrize("seed", range(4))
def test_lookup_draft_matches_jax(seed):
    """Rows of random histories over a small alphabet (so bigrams repeat),
    random valid counts and bigrams: the port's vectorised lookup gives
    JAX's draft and found flag for every row."""
    rng = np.random.default_rng(seed)
    b, t, k = 16, 40, 5
    hist = rng.integers(0, 4, (b, t))
    h = rng.integers(1, t + 1, b)
    prev, last = rng.integers(0, 4, b), rng.integers(0, 4, b)
    got, found = spec._lookup_draft(*(torch.from_numpy(a) for a in
                                      (hist, h, prev, last)), k)
    for r in range(b):
        want, wfound = jspec._lookup_draft(
            jnp.asarray(hist[r], jnp.int32), jnp.int32(h[r]),
            jnp.int32(prev[r]), jnp.int32(last[r]), k)
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(want))
        assert bool(found[r]) == bool(wfound)
    assert found.any() and not found.all()


def test_pld_matches_greedy_and_jax(models):
    """Tokens equal the port's greedy generate_device and JAX's
    generate_pld on the same weights, in no more steps than tokens; the
    step counts equal JAX's."""
    eng = _engine(models)
    jp, jcfg, jq = models[0]
    jeng = JEngine(jp, jcfg, jq, batch=1)
    for prompt in PROMPTS:
        ids = np.asarray([prompt])
        want = eng.generate_device(ids, GREEDY, n_tokens=24)[0].numpy()
        got, steps, _ = spec.generate_pld(eng, ids, n_tokens=24, K=7)
        np.testing.assert_array_equal(got, want)
        assert steps <= 24
        jgot, jsteps, _ = jspec.generate_pld(jeng, ids.astype(np.int32),
                                             n_tokens=24, K=7)
        np.testing.assert_array_equal(got, np.asarray(jgot))
        assert steps == jsteps


def test_pld_accepts_on_repetitive_continuations(models):
    """Greedy decoding of the tiny model soon loops; the lookup then
    accepts several drafts a step."""
    got, steps, _ = spec.generate_pld(_engine(models), [[7, 3, 7, 3]],
                                      n_tokens=48, K=7)
    assert len(got) == 48
    assert steps < 40, steps


@pytest.mark.parametrize("n1", [2, 3, 4, 5, 6, 7])
def test_pld_multi_turn_continuation(models, n1):
    """A second turn through the first turn's cache equals a fresh run of
    the whole conversation, whether the first turn's last verify landed
    exactly (the last token fed afterwards) or overshot (the length cut
    back): JAX's no-overshoot sweep, and its 6-token first turn at K = 7."""
    eng = _engine(models)
    for ids1, ids2, k, n2 in (([100, 50, 25], [60, 61], 4, 5),
                              ([5, 9, 11], [20, 21], 7, 6)):
        if k == 7 and n1 != 6:
            continue
        t1, _, cache = spec.generate_pld(eng, [ids1], n_tokens=n1, K=k)
        assert cache.length == len(ids1) + n1
        t2, _, _ = spec.generate_pld(eng, [ids2], n_tokens=n2, K=k,
                                     cache=cache, start=len(ids1) + n1)
        full = [ids1 + t1.tolist() + ids2]
        want, _, _ = spec.generate_pld(_engine(models), full, n_tokens=n2,
                                       K=k)
        np.testing.assert_array_equal(t2, want, err_msg=f"n_tokens={n1}")


def test_verify_emits_accepted_prefix_plus_one(models):
    """verify on two rows at their own positions (the model's greedy loop
    cut at two lengths): each row's emitted tokens are the greedy chain's
    next ones, a row whose history predicts its continuation accepts
    drafts, and the argmax tokens land in its history at h."""
    tp, cfg, q = models[1]
    eng = _engine(models)
    prompt = [7, 3, 7, 3, 7, 3, 7, 3]
    want = eng.generate_device(np.asarray([prompt]), GREEDY,
                               n_tokens=20)[0].tolist()
    from tinychatengine_tpu_torch.generation import kv_cache as kvc
    cache = kvc.init_cache(cfg.num_layers, 2, 64, cfg.num_kv_heads,
                           cfg.head_dim, device="cpu")
    seq = prompt + want
    lens = [len(prompt) + 12, len(prompt) + 9]
    llama.forward(tp, cfg, torch.tensor([seq[:lens[0] - 1]] * 2), cache, 0)
    hist = torch.zeros((2, 64 + 4), dtype=torch.int64)
    for r, n in enumerate(lens):
        hist[r, :n] = torch.tensor(seq[:n])
    h = torch.tensor(lens)
    last = torch.tensor([seq[n - 1] for n in lens])
    starts = torch.tensor([n - 1 for n in lens], dtype=torch.int32)
    g, emitted = spec.verify(llama.forward, tp, cfg, last, cache, starts,
                             hist, h, 3)
    for r, n in enumerate(lens):
        e = int(emitted[r])
        assert 2 <= e <= 4
        assert g[r, :e].tolist() == seq[n:n + e]
        assert hist[r, n:n + 4].tolist() == g[r].tolist()
