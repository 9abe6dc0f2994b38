"""The port's llama forward, parameter loading and requantization against
the JAX package on the CPU. The JAX parameters are flattened to numpy
(the checkpoint format's tree-path keys) and handed to the port through
``params_from_numpy``; the port never sees a JAX object."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinychatengine_tpu.core.config import ModelConfig as JModelConfig
from tinychatengine_tpu.core.config import QuantConfig as JQuantConfig
from tinychatengine_tpu.generation import kv_cache as jkvc
from tinychatengine_tpu.models import llama as jllama
from tinychatengine_tpu.ops import int4_matmul as jim
from tinychatengine_tpu.tools import checkpoint as jckpt
from tinychatengine_tpu.tools.convert import requantize_llama as j_requantize
from tinychatengine_tpu_torch.core.config import ModelConfig, QuantConfig
from tinychatengine_tpu_torch.generation import kv_cache as tkvc
from tinychatengine_tpu_torch.models import llama as tllama
from tinychatengine_tpu_torch.ops import int4_matmul as tim
from tinychatengine_tpu_torch.tools import checkpoint as tckpt
from tinychatengine_tpu_torch.tools.convert import requantize_llama

CKPT = Path(__file__).resolve().parent.parent / "assets" / "bytellama_5m"
TINY = dict(name="tiny", family="llama", num_heads=4, num_kv_heads=2,
            num_layers=2, max_sqlen=64, embed_dim=256, hidden_dim=512,
            vocab_size=300)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers: one intra-op thread per worker
    keeps torch's many small CPU ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _flat(jparams) -> dict:
    return jckpt._flatten(jparams)[0]


def _port_params(jparams, cfg, qcfg):
    return tllama.params_from_numpy(_flat(jparams), cfg, qcfg, device="cpu")


def _bits(t):
    """Exact comparison form of a leaf on either side."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.itemsize == 2 and a.dtype.kind == "V" \
        else a


def _port_flat(p: tllama.LlamaParams) -> dict:
    out = {}

    def walk(obj, prefix):
        if isinstance(obj, torch.Tensor):
            out[prefix] = obj
        elif obj is not None:
            for name, val in vars(obj).items():
                walk(val, f"{prefix}/{name}" if prefix else name)
    walk(p, "")
    return out


# per-step logits of a 2-layer model: the two sides round bf16 activations
# at the same points but may sum in other orders, so a few bf16 steps of
# logits of order 1 (W4A8 adds an int8 code flip now and then).
# "w4a16-kouter": W4A16 with every stacked linear listed in both sides'
# DECODE_KOUTER; a CPU forward on either side never reaches a kernel, so the
# logits stay the unlisted ones' (on the card these calls run
# int4_matmul_kouter, chip_smoke.py phase 4f)
@pytest.mark.parametrize("scheme,kv,tol", [
    ("fp", "bf16", 2e-2), ("w4a16", "bf16", 2e-2), ("w4a8", "bf16", 4e-2),
    ("fp", "int8", 2e-2), ("w4a16", "int8", 2e-2), ("w4a8", "int8", 4e-2),
    ("w4a16-kouter", "bf16", 2e-2)])
def test_forward_prefill_and_decode_match_jax(scheme, kv, tol, monkeypatch):
    jcfg, cfg = JModelConfig(**TINY), ModelConfig(**TINY)
    if scheme.endswith("-kouter"):
        scheme = scheme.removesuffix("-kouter")
        e, f, d = cfg.embed_dim, cfg.hidden_dim, cfg.head_dim
        table = dict.fromkeys(
            [(e, (cfg.num_heads + 2 * cfg.num_kv_heads) * d),
             (cfg.num_heads * d, e), (e, 2 * f), (f, e)], (256, 256))
        monkeypatch.setattr(jim, "DECODE_KOUTER", dict(table))
        monkeypatch.setattr(tim, "DECODE_KOUTER", dict(table))
    jq = JQuantConfig(scheme=scheme, kv_cache_dtype=kv)
    jp = jllama.init_random_params(jcfg, jq, seed=1)
    tp = _port_params(jp, cfg, QuantConfig(scheme=scheme, kv_cache_dtype=kv))
    for name in ("wqkv", "wo", "wgate_up", "down") if tim.DECODE_KOUTER \
            else ():
        p = getattr(tp.layers, name)
        assert (2 * p.packed.shape[-2], p.packed.shape[-1]) \
            in tim.DECODE_KOUTER, name
    quant_kv = kv == "int8"
    jc = jkvc.init_cache(2, 1, 64, 2, 64, quantized=quant_kv)
    tc = tkvc.init_cache(2, 1, 64, 2, 64, quantized=quant_kv,
                         device="cpu")
    ids = np.random.default_rng(0).integers(0, 300, (1, 16))
    # prefill: a 12-token prompt right-padded to 16 (bucket padding)
    jl, jc = jllama.forward(jp, jcfg, jnp.asarray(ids), jc, jnp.int32(0),
                            true_len=jnp.int32(12))
    tl, tc = tllama.forward(tp, cfg, torch.from_numpy(ids), tc, 0, true_len=12)
    assert tc.length == 12 and tl.shape == (1, 300)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol, rtol=tol)
    for step in range(4):
        tok = int(np.argmax(np.asarray(jl)[0]))
        jl, jc = jllama.forward(jp, jcfg, jnp.asarray([[tok]]), jc,
                                jnp.int32(12 + step))
        tl, tc = tllama.forward(tp, cfg, torch.tensor([[tok]]), tc, 12 + step)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol,
                                   rtol=tol)


def test_full_logits_match_jax():
    jcfg, cfg = JModelConfig(**TINY), ModelConfig(**TINY)
    jp = jllama.init_random_params(jcfg, JQuantConfig(scheme="w4a16"), seed=2)
    tp = _port_params(jp, cfg, QuantConfig(scheme="w4a16"))
    ids = np.random.default_rng(1).integers(0, 300, (2, 8))
    jl, _ = jllama.forward(jp, jcfg, jnp.asarray(ids),
                           jkvc.init_cache(2, 2, 64, 2, 64), jnp.int32(0),
                           full_logits=True)
    tl, _ = tllama.forward(tp, cfg, torch.from_numpy(ids),
                           tkvc.init_cache(2, 2, 64, 2, 64, device="cpu"), 0,
                           full_logits=True)
    assert tl.shape == (2, 8, 300)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("scheme,fast", [("fp", False), ("w4a16", False),
                                         ("w4a8", True)])
def test_init_random_params_has_the_jax_structure(scheme, fast):
    """Same leaves, shapes and dtypes as the JAX tree (lm_head padded to a
    multiple of 2048), so checkpoints and params_from_numpy line up."""
    jcfg, cfg = JModelConfig(**TINY), ModelConfig(**TINY)
    jflat = _flat(jllama.init_random_params(
        jcfg, JQuantConfig(scheme=scheme), seed=0, fast=fast))
    tp = tllama.init_random_params(cfg, QuantConfig(scheme=scheme), seed=0,
                                   fast=fast, device="cpu")
    tflat = _port_flat(tp)
    assert sorted(tflat) == sorted(jflat)
    for key, t in tflat.items():
        assert tuple(t.shape) == jflat[key].shape, key
        assert t.element_size() == jflat[key].dtype.itemsize, key
    assert tllama.lmhead_padded(128256) == 129024
    out, _ = tllama.forward(tp, cfg, torch.tensor([[1, 2, 3]]),
                            tkvc.init_cache(2, 1, 64, 2, 64, device="cpu"), 0)
    assert out.shape == (1, 300) and torch.isfinite(out).all()


@pytest.fixture(scope="module")
def trained():
    if not (CKPT / "meta.json").exists():
        pytest.skip("trained checkpoint not present")
    from tinychatengine_tpu.core.config import get_model_config
    jparams, _ = jckpt.load_checkpoint(str(CKPT),
                                       get_model_config("bytellama_5m"))
    return jparams


def test_checkpoint_load_matches_jax_leaf_by_leaf(trained):
    params, qcfg = tckpt.load_checkpoint(str(CKPT), device="cpu")
    assert qcfg.scheme == "fp"
    jflat, tflat = _flat(trained), _port_flat(params)
    assert sorted(tflat) == sorted(jflat)
    for key in jflat:
        np.testing.assert_array_equal(_bits(tflat[key]), _bits(jflat[key]),
                                      err_msg=key)


@pytest.mark.parametrize("scheme", ["w4a16", "w4a8"])
def test_requantize_bit_identical_to_jax(trained, scheme):
    params, _ = tckpt.load_checkpoint(str(CKPT), device="cpu")
    q = requantize_llama(params, QuantConfig(scheme=scheme, group_size=128))
    jq = j_requantize(trained, JQuantConfig(scheme=scheme, group_size=128))
    jflat, tflat = _flat(jq), _port_flat(q)
    assert sorted(tflat) == sorted(jflat)
    for key in jflat:
        np.testing.assert_array_equal(_bits(tflat[key]), _bits(jflat[key]),
                                      err_msg=key)
        assert tflat[key].is_contiguous(), key  # the kernels require it
    kind = type(q.layers.wqkv).__name__
    assert kind == ("Int4A8Linear" if scheme == "w4a8" else "Int4Linear")
