"""Divisions by a constant, held bit for bit to the jitted JAX functions.

Under ``jax.jit`` XLA's simplifier rewrites ``x / c`` for a constant ``c``
as ``x * (f32(1) / f32(c))``; the JAX package's production paths are
jitted, so the port multiplies by that reciprocal (``ops.ref.xla_recip``).
Each test feeds the same seeded numpy inputs to the port and to the jitted
JAX function, asserts equal bits, and asserts that true f32 division
differs from the jitted result on at least one element of its input (so
the test could not pass without the reciprocal)."""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from test_torch_w4a8 import _jax_quantize, a8_quantize
from tinychatengine_tpu.core.config import GenerationConfig
from tinychatengine_tpu.generation import kv_cache as jkv
from tinychatengine_tpu.generation import sampling as jsamp
from tinychatengine_tpu_torch.generation import kv_cache as tkv
from tinychatengine_tpu_torch.generation import sampling as tsamp
from tinychatengine_tpu_torch.ops import int4_matmul as tim
from tinychatengine_tpu_torch.ops.ref import xla_recip
from tinychatengine_tpu_torch.quant.packing import numpy_to_torch


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _true_div(a: np.ndarray, c: float) -> np.ndarray:
    """IEEE f32 division of f32 values by f32(c)."""
    return np.asarray(a, np.float32) / np.float32(c)


def test_xla_recip_is_the_f32_reciprocal_of_the_f32_constant():
    """1.1 is not an f32: the factor is f32(1) / f32(1.1), not the f32
    rounding of the f64 1 / 1.1."""
    assert xla_recip(1.1) == float(np.float32(1) / np.float32(1.1))
    assert np.float32(xla_recip(1.1)) != np.float32(1.0 / 1.1)
    assert xla_recip(127.0) == float(np.float32(1) / np.float32(127))


def test_quantize_kv_matches_jitted_jax_bit_for_bit():
    """``_quantize_kv`` (dense and paged int8 KV writes): codes and scales
    of bf16 K [2, 8, 256, 128] equal jitted JAX ``_quantize_kv``."""
    rng = np.random.default_rng(0)
    k = (rng.standard_normal((2, 8, 256, 128)) * 2.0).astype(
        ml_dtypes.bfloat16)
    want_q, want_s = jax.jit(jkv._quantize_kv)(jnp.asarray(k))
    got_q, got_s = tkv._quantize_kv(numpy_to_torch(k))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(_bits(got_s.numpy()), _bits(want_s))
    absmax = np.abs(k.astype(np.float32)).max(axis=-1)
    assert (_bits(_true_div(absmax, 127.0)) != _bits(want_s)).any()


def _window(rng, b, t, v):
    """A [B, T] int32 window of recent tokens, -1 padded at the front of
    every other row."""
    last = rng.integers(0, v, (b, t)).astype(np.int32)
    last[::2, : t // 4] = -1
    return last


def test_repetition_penalty_matches_jitted_jax_bit_for_bit():
    """``apply_repetition_penalty`` at 1.1 against the jitted JAX function
    (the penalty static, as the Engine's ``gcfg`` is)."""
    rng = np.random.default_rng(1)
    b, t, v = 8, 64, 512
    logits = (rng.standard_normal((b, v)) * 4.0).astype(np.float32)
    last = _window(rng, b, t, v)
    fn = jax.jit(functools.partial(jsamp.apply_repetition_penalty,
                                   penalty=1.1))
    want = np.asarray(fn(jnp.asarray(logits), jnp.asarray(last)))
    got = tsamp.apply_repetition_penalty(torch.from_numpy(logits),
                                         torch.from_numpy(last), 1.1)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    hit = np.zeros((b, v), bool)
    for r in range(b):
        hit[r, last[r][last[r] >= 0]] = True
    pos = hit & (logits > 0)
    assert (_bits(_true_div(logits, 1.1))[pos] != _bits(want)[pos]).any()


def test_greedy_penalized_candidates_match_jitted_jax():
    """``greedy_penalized`` at penalty 1.1 against the jitted JAX function
    with the Engine's static ``gcfg``. Each row holds a window token A of
    raw logit a > 0 and a free token B of raw logit f32(a / 1.1), for an a
    whose true quotient lies one ulp above a * f32(1 / 1.1): under jit A's
    penalized value lies below B's, so B wins; with true division they tie
    and A wins (its raw logit is higher). The picked tokens equal jit's,
    and eager JAX (true division) picks otherwise."""
    rng = np.random.default_rng(2)
    b, t, v = 16, 32, 256
    r = np.float32(xla_recip(1.1))
    cand = (rng.uniform(1.0, 8.0, 4096)).astype(np.float32)
    above = cand[(cand / np.float32(1.1)) > (cand * r)]
    logits = (rng.standard_normal((b, v)) * 0.1).astype(np.float32)
    last = _window(rng, b, t, v)
    for row in range(b):
        a_id = int(last[row, -1])
        b_id = (a_id + 1) % v
        while b_id in last[row]:
            b_id = (b_id + 1) % v
        logits[row, a_id] = above[row]
        logits[row, b_id] = above[row] / np.float32(1.1)
    gcfg = GenerationConfig(repeat_penalty=1.1)
    jitted = jax.jit(lambda lg, lt: jsamp.greedy_penalized(lg, lt, gcfg))
    want = np.asarray(jitted(jnp.asarray(logits), jnp.asarray(last)))
    got = tsamp.greedy_penalized(torch.from_numpy(logits),
                                 torch.from_numpy(last), gcfg)
    np.testing.assert_array_equal(got.numpy(), want)
    eager = np.asarray(jsamp.greedy_penalized(jnp.asarray(logits),
                                              jnp.asarray(last), gcfg))
    assert (eager != want).any()


def test_temperature_matches_jitted_jax_bit_for_bit():
    """``apply_temperature`` at 0.7 (static under the Engine's jit)."""
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((4, 4096)) * 5.0).astype(np.float32)
    fn = jax.jit(functools.partial(jsamp.apply_temperature, temp=0.7))
    want = np.asarray(fn(jnp.asarray(logits)))
    got = tsamp.apply_temperature(torch.from_numpy(logits), 0.7)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert (_bits(_true_div(logits, 0.7)) != _bits(want)).any()


def test_mirostat_surprise_in_bits_matches_jitted_jax():
    """Mirostat's surprise in bits (``-log_probs / jnp.log(2.0)`` in the
    JAX package's v1, v2 and per-row mirostat), jitted, against
    ``surprise_bits`` on the same log-probabilities."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((4, 4096)) * 3.0).astype(np.float32)
    lp = np.array(jax.nn.log_softmax(jnp.asarray(x), axis=-1))
    want = np.asarray(jax.jit(lambda a: -a / jnp.log(2.0))(jnp.asarray(lp)))
    got = tsamp.surprise_bits(torch.from_numpy(lp))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    ln2 = np.log(np.float32(2.0))
    assert (_bits(-lp / ln2) != _bits(want)).any()


@pytest.mark.parametrize("gs", [32, 128])
def test_a8_plain_quantizer_matches_the_jax_body(gs):
    """``int4_matmul_a8_plain``'s q_a and a_scale (``a8_quantize_plain``)
    equal the kernel's quantizer model and the TPU body's quantizer as XLA
    runs it (``test_torch_w4a8``), bit for bit."""
    rng = np.random.default_rng(5 + gs)
    x = (rng.standard_normal((16, 1024)) * 1.5).astype(ml_dtypes.bfloat16)
    q_a, a_scale = tim.a8_quantize_plain(numpy_to_torch(x).float(), gs)
    want_q, want_s = _jax_quantize(x, gs)
    model_q, model_s = a8_quantize(numpy_to_torch(x), gs)
    np.testing.assert_array_equal(q_a.reshape(16, 1024).numpy(), want_q)
    np.testing.assert_array_equal(q_a.to(torch.int8).reshape(16, 1024),
                                  model_q)
    np.testing.assert_array_equal(_bits(a_scale[..., 0].numpy()),
                                  _bits(want_s))
    np.testing.assert_array_equal(_bits(a_scale[..., 0].numpy()),
                                  _bits(model_s.numpy()))
    absmax = np.abs(x.astype(np.float32)).reshape(16, -1, gs).max(-1)
    assert (_bits(_true_div(np.maximum(absmax, 1e-8), 127.0))
            != _bits(want_s)).any()
