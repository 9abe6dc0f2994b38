"""The fused decode path against the JAX package on the CPU: the plain
version of ``int4_matmul_fused`` against the TPU kernel in interpret mode in
each of its variants, and the llama forward's fused branch against JAX's
(forced on with ``FUSED_DECODE`` / ``FUSED_FORCE``, as its own tests do),
contiguous and paged, rows at different positions, and the shape gate.
Inputs are made with numpy from a seed and fed to both sides; the JAX
parameters reach the port through ``params_from_numpy``."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tinychatengine_tpu.core.config import ModelConfig as JModelConfig
from tinychatengine_tpu.core.config import QuantConfig as JQuantConfig
from tinychatengine_tpu.generation import kv_cache as jkvc
from tinychatengine_tpu.models import llama as jllama
from tinychatengine_tpu.ops import int4_matmul as jim
from tinychatengine_tpu.ops import ref as jref
from tinychatengine_tpu.quant import numerics as jnum
from tinychatengine_tpu.quant import packing as jpack
from tinychatengine_tpu.runtime import paged as jpaged
from tinychatengine_tpu.tools import checkpoint as jckpt
from tinychatengine_tpu_torch.core.config import ModelConfig, QuantConfig
from tinychatengine_tpu_torch.generation import kv_cache as tkvc
from tinychatengine_tpu_torch.models import llama
from tinychatengine_tpu_torch.ops import _build
from tinychatengine_tpu_torch.ops import int4_matmul as tim
from tinychatengine_tpu_torch.quant.packing import numpy_to_torch
from tinychatengine_tpu_torch.runtime import paged as tpaged
from test_torch_kouter import mma_contraction

# JAX's tests/test_fused_decode.py config: the smallest llama whose every
# matmul passes the fused gate (K a superblock multiple with K/G % 8 == 0,
# head_dim 128)
FUSABLE = dict(name="tiny-fusable", family="llama", num_heads=8,
               num_kv_heads=4, num_layers=2, max_sqlen=64, embed_dim=1024,
               hidden_dim=1024, vocab_size=512, rms_norm_eps=1e-5,
               rope_theta=10000.0)
K, N, D, QK = 1024, 512, 128, 384  # kernel cases: RoPE on 3 of 4 heads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers: one intra-op thread per worker
    keeps torch's many small CPU ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def force_fused(monkeypatch):
    """The fused branch on, on both sides (JAX needs FUSED_FORCE off the
    TPU, where it runs the Pallas kernels in interpret mode)."""
    monkeypatch.setattr(jim, "FUSED_DECODE", True)
    monkeypatch.setattr(jim, "FUSED_FORCE", True)
    monkeypatch.setattr(tim, "FUSED_DECODE", True)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _bf16(a) -> np.ndarray:
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)


def _operands(rng, m, scale_dtype, gs=128):
    """Two stacked layers of weights (group ``gs``), norm weights, biases,
    a residual and per-row RoPE tables, as numpy."""
    packs, scales = [], []
    for _ in range(2):
        w = (rng.standard_normal((N, K)) * 0.02).astype(np.float32)
        q, s = jnum.quantize_groupwise_int4(w, gs)
        packs.append(jpack.pack_qm_tpu(q, gs))
        scales.append(jpack.pack_scales(s, scale_dtype, gs))
    cos, sin = jref.make_rope_cache(D, 64)
    pos = rng.integers(0, 64, m)
    return dict(
        x=_bf16(rng.standard_normal((m, K)) * 2.0 + 0.5),
        packed=np.stack(packs), scales=np.stack(scales),
        norm_w=_bf16(rng.standard_normal((2, K)) * 0.3 + 1.0),
        norm_b=_bf16(rng.standard_normal((2, K)) * 0.2),
        bias=(rng.standard_normal((2, N)) * 0.05).astype(np.float32),
        residual=_bf16(rng.standard_normal((m, N))),
        cos=np.asarray(cos)[pos], sin=np.asarray(sin)[pos])


VARIANTS = {  # the fused parts each model's call sites use
    "rmsnorm": ("norm_w",),                       # llama gate_up, lm_head
    "rmsnorm_rope": ("norm_w", "rope"),           # llama qkv
    "layernorm_bias": ("norm_w", "norm_b", "bias"),  # StarCoder c_attn, fc_in
    "bias": ("bias",),
    "residual": ("residual",),                    # llama wo, down
    "bias_residual": ("bias", "residual"),        # StarCoder c_proj, fc_out
}


def _kwargs(ops, parts, conv):
    kw = {}
    for name in parts:
        if name == "rope":
            kw.update(rope_cos=conv(ops["cos"]), rope_sin=conv(ops["sin"]),
                      rope_qk_cols=QK, head_dim=D)
        else:
            kw[name] = conv(ops[name])
    return kw


@pytest.mark.parametrize("scale_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_fused_plain_matches_jax_kernel(variant, m, scale_dtype):
    """Held within one bf16 step (rtol 8e-3) of the element, or of the
    output's largest value (a step of the product before a bias or residual
    add survives a cancellation there). Also rows through layer 1 of the
    stack."""
    rng = np.random.default_rng(len(variant) * 10 + m)
    ops = _operands(rng, m, scale_dtype)
    parts = VARIANTS[variant]
    want = jim.int4_matmul_fused(
        jnp.asarray(ops["x"]), jnp.asarray(ops["packed"]),
        jnp.asarray(ops["scales"]), 128, layer_idx=1, interpret=True,
        **_kwargs(ops, parts, jnp.asarray))
    _build.reset_launches()
    got = tim.int4_matmul_fused(
        numpy_to_torch(ops["x"]), numpy_to_torch(ops["packed"]),
        numpy_to_torch(ops["scales"]), 128, layer_idx=1,
        **_kwargs(ops, parts, numpy_to_torch))
    assert got.dtype == torch.bfloat16 and got.shape == (m, N)
    assert _build.LAUNCHES["int4_matmul_fused"] == 0  # the CPU: plain
    want = _f32(want)
    np.testing.assert_allclose(_f32(got), want, rtol=8e-3,
                               atol=8e-3 * np.abs(want).max())
    if "rope" in parts:  # the roped q|k columns and the pass-through v,
        # each against its own largest value
        for cols in (slice(0, QK), slice(QK, N)):
            w = want[:, cols]
            np.testing.assert_allclose(_f32(got)[:, cols], w, rtol=8e-3,
                                       atol=8e-3 * np.abs(w).max())


@pytest.mark.parametrize("gs,scale_dtype", [(32, "bf16"), (64, "f32"),
                                             (128, "f32")])
@pytest.mark.parametrize("m", [2, 8])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_fused_mma_model_matches_jax_kernel(monkeypatch, variant, m, gs,
                                            scale_dtype):
    """The CUDA kernel's arithmetic on the CPU: the plain version with its
    contraction replaced by ``mma_contraction`` (k16 steps into per-group
    f32 sums folded by fma, the K split of ``fused_kernel_split`` summed in
    K order), the norm, RoPE, bias and residual as the plain version takes
    them, against interpret-mode Pallas ``int4_matmul_fused``: within one
    bf16 step of the element or of the output's largest value, the
    tolerance of the plain version's own test (the two round to bf16 after
    f32 sums taken in other orders)."""
    rng = np.random.default_rng(len(variant) * 100 + m + gs)
    ops = _operands(rng, m, scale_dtype, gs)
    parts = VARIANTS[variant]
    want = _f32(jim.int4_matmul_fused(
        jnp.asarray(ops["x"]), jnp.asarray(ops["packed"]),
        jnp.asarray(ops["scales"]), gs, layer_idx=1, interpret=True,
        **_kwargs(ops, parts, jnp.asarray)))
    per = tim.fused_kernel_split(m, N, K)[0]
    monkeypatch.setattr(
        tim, "factored_int4",
        lambda xb, packed, scales, group_size: mma_contraction(
            xb, packed, scales, group_size, per))
    got = _f32(tim.int4_matmul_fused_plain(
        numpy_to_torch(ops["x"]), numpy_to_torch(ops["packed"]),
        numpy_to_torch(ops["scales"]), gs, layer_idx=1,
        **_kwargs(ops, parts, numpy_to_torch)))
    regions = ((slice(0, QK), slice(QK, N)) if "rope" in parts
               else (slice(0, N),))
    for cols in regions:
        w = want[:, cols]
        np.testing.assert_allclose(got[:, cols], w, rtol=8e-3,
                                   atol=8e-3 * np.abs(w).max())
    assert tim.fused_kernel_split(m, N, K)[1] > 1  # the splits' sums added


def test_fused_plain_against_the_unfused_composition():
    """The fused product uses the exact codes and f32 scales; the unfused
    plain path (``int4_matmul_xla``'s cast points) first rounds each
    dequantized weight to bf16. The two differ, by under 2e-2 of the
    largest output at K = 1024; the norm, bias and residual steps match
    the unfused ops."""
    from tinychatengine_tpu_torch.ops import ref
    rng = np.random.default_rng(5)
    ops = _operands(rng, 4, "f32")
    t = {k: numpy_to_torch(v) for k, v in ops.items()}
    fused = tim.int4_matmul_fused_plain(
        t["x"], t["packed"], t["scales"], 128, layer_idx=0,
        norm_w=t["norm_w"], norm_b=t["norm_b"], bias=t["bias"],
        residual=t["residual"]).float()
    h = ref.layer_norm_ref(t["x"], t["norm_w"][0], t["norm_b"][0])
    y = tim.int4_matmul_plain(h, t["packed"], t["scales"], 128, layer_idx=0)
    y = (y + t["bias"][0].to(torch.bfloat16)) + t["residual"]
    diff = float((fused - y.float()).abs().max() / y.float().abs().max())
    assert 0.0 < diff < 2e-2, diff


def test_fused_wrapper_refuses_what_jax_refuses():
    rng = np.random.default_rng(1)
    ops = _operands(rng, 1, "f32")
    t = {k: numpy_to_torch(v) for k, v in ops.items()}
    with pytest.raises(ValueError, match="unpadded"):  # a pack-padded K
        tim.int4_matmul_fused(t["x"][:, :768], t["packed"], t["scales"], 128,
                              layer_idx=0)
    with pytest.raises(ValueError, match="needs norm_w"):
        tim.int4_matmul_fused(t["x"], t["packed"], t["scales"], 128,
                              layer_idx=0, norm_b=t["norm_b"])
    with pytest.raises(ValueError, match="layer_idx"):
        tim.int4_matmul_fused(t["x"], t["packed"][0], t["scales"][0], 128,
                              layer_idx=0)
    one = tim.int4_matmul_fused(t["x"], t["packed"][1], t["scales"][1], 128,
                                norm_w=t["norm_w"][1], bias=t["bias"][1])
    both = tim.int4_matmul_fused(t["x"], t["packed"], t["scales"], 128,
                                 layer_idx=1, norm_w=t["norm_w"],
                                 bias=t["bias"])
    assert torch.equal(one, both)  # unstacked operands wrap as L = 1


# ---- the llama forward's fused branch --------------------------------------

def _flat(jparams) -> dict:
    return jckpt._flatten(jparams)[0]


def _models(seed, **over):
    cfg = dict(FUSABLE, **over)
    jcfg = JModelConfig(**cfg)
    jp = jllama.init_random_params(jcfg, JQuantConfig(scheme="w4a16"),
                                   seed=seed)
    tp = llama.params_from_numpy(_flat(jp), ModelConfig(**cfg),
                                 QuantConfig(scheme="w4a16"), device="cpu")
    return jcfg, ModelConfig(**cfg), jp, tp


def _count_fused(monkeypatch):
    calls = []
    real = tim.int4_matmul_fused

    def counted(*a, **kw):
        calls.append(kw.get("layer_idx"))
        return real(*a, **kw)
    monkeypatch.setattr(tim, "int4_matmul_fused", counted)
    return calls


def test_fused_llama_decode_matches_jax_fused(force_fused, monkeypatch):
    """A 6-token prompt (S > 1: unfused on both sides), then two fused
    decode steps: logits and the K/V written there (the in-kernel RoPE)
    against JAX's fused forward, and against the port's unfused step."""
    jcfg, cfg, jp, tp = _models(0)
    calls = _count_fused(monkeypatch)
    ids = np.random.default_rng(0).integers(0, 512, (1, 6))
    jc = jkvc.init_cache(2, 1, 64, 4, 128)
    tc = tkvc.init_cache(2, 1, 64, 4, 128, device="cpu")
    _, jc = jllama.forward(jp, jcfg, jnp.asarray(ids), jc, jnp.int32(0))
    llama.forward(tp, cfg, torch.from_numpy(ids), tc, 0)
    assert calls == []
    for step, tok in enumerate((7, 300)):
        jl, jc = jllama.forward(jp, jcfg, jnp.asarray([[tok]]), jc,
                                jnp.int32(6 + step))
        tl, tc = llama.forward(tp, cfg, torch.tensor([[tok]]), tc, 6 + step)
        np.testing.assert_allclose(tl.numpy(), _f32(jl), atol=2e-2,
                                   rtol=2e-2)
    assert calls == [0, 0, 0, 0, 1, 1, 1, 1, None] * 2  # 4 per layer + head
    for got, want in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_allclose(_f32(got)[:, :, :, :8],
                                   _f32(want)[:, :, :, :8], atol=2e-2,
                                   rtol=2e-2)
    tim.FUSED_DECODE = False  # the same step unfused, in the port
    tc2 = tkvc.init_cache(2, 1, 64, 4, 128, device="cpu")
    llama.forward(tp, cfg, torch.from_numpy(ids), tc2, 0)
    ul, _ = llama.forward(tp, cfg, torch.tensor([[7]]), tc2, 6)
    assert len(calls) == 18
    tc3 = tkvc.init_cache(2, 1, 64, 4, 128, device="cpu")
    llama.forward(tp, cfg, torch.from_numpy(ids), tc3, 0)
    tim.FUSED_DECODE = True
    fl, _ = llama.forward(tp, cfg, torch.tensor([[7]]), tc3, 6)
    rel = float((fl - ul).abs().max() / ul.abs().max())
    assert 0.0 < rel < 2e-2, rel


def test_fused_llama_rows_at_different_positions(force_fused):
    """B = 2 decode at positions 3 and 9 (per-row RoPE tables) against JAX
    and against each row's own B = 1 step."""
    jcfg, cfg, jp, tp = _models(1)
    toks = np.array([[11], [222]])
    starts = np.array([3, 9], np.int32)
    jl, _ = jllama.forward(jp, jcfg, jnp.asarray(toks),
                           jkvc.init_cache(2, 2, 64, 4, 128),
                           jnp.asarray(starts))
    tl, _ = llama.forward(tp, cfg, torch.from_numpy(toks),
                          tkvc.init_cache(2, 2, 64, 4, 128, device="cpu"),
                          torch.from_numpy(starts))
    np.testing.assert_allclose(tl.numpy(), _f32(jl), atol=2e-2, rtol=2e-2)
    for r in range(2):
        one, _ = llama.forward(tp, cfg, torch.from_numpy(toks[r:r + 1]),
                               tkvc.init_cache(2, 1, 64, 4, 128,
                                               device="cpu"),
                               torch.from_numpy(starts[r:r + 1]))
        assert torch.allclose(one, tl[r:r + 1], rtol=1e-3, atol=1e-3), r


def test_fused_llama_paged_decode_matches_jax(force_fused):
    """The paged (serving) decode with the fused wo / gate_up / down
    epilogues: a 6-token prefix in page 3 (page size 16), one decode step
    against JAX's fused paged step; logits and the K written at offset 6."""
    jcfg, cfg, jp, tp = _models(2)
    ids = np.random.default_rng(2).integers(0, 512, (1, 6))
    jc = jkvc.init_cache(2, 1, 64, 4, 128)
    _, jc = jllama.forward(jp, jcfg, jnp.asarray(ids), jc, jnp.int32(0))
    jpc = jpaged.init_paged_cache(2, n_pages=8, num_kv_heads=4, page_size=16,
                                  head_dim=128)
    jpc = jpaged.insert_prefix(jpc, jc.k[:, 0, :, :16], jc.v[:, 0, :, :16],
                               jnp.asarray([3], jnp.int32))
    tpc = tpaged.paged_cache_from_numpy(np.asarray(jpc.k), np.asarray(jpc.v),
                                        device="cpu")
    table = np.array([[3, 5]], np.int32)
    lengths = np.array([6], np.int32)
    jl, jpc = jllama.forward(jp, jcfg, jnp.asarray([[9]]), jpc,
                             jnp.asarray(lengths),
                             page_table=jnp.asarray(table))
    tl, tpc = llama.forward(tp, cfg, torch.tensor([[9]]), tpc,
                            torch.from_numpy(lengths),
                            page_table=torch.from_numpy(table))
    np.testing.assert_allclose(tl.numpy(), _f32(jl), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(_f32(tpc.k)[:, 3, :, 6],
                               _f32(jpc.k)[:, 3, :, 6], atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("case", ["narrow_embed", "w4a8", "fp", "padded_k"])
def test_fused_gate_falls_back_exactly(force_fused, monkeypatch, case):
    """Shapes and kinds the gate refuses take the unfused path: the logits
    equal the switch-off step bit for bit and no fused call is made. A
    256-wide embed has K/G = 2 (JAX's own ineligible case); W4A8 and fp are
    not W4A16 linears; llama-2's F = 11008 packs with a padded K."""
    over = {"narrow_embed": dict(embed_dim=256, hidden_dim=512, num_heads=4,
                                 num_kv_heads=2),
            "w4a8": {}, "fp": {},
            "padded_k": dict(hidden_dim=1152)}[case]
    scheme = case if case in ("w4a8", "fp") else "w4a16"
    cfg = ModelConfig(**dict(FUSABLE, **over))
    tp = llama.init_random_params(cfg, QuantConfig(scheme=scheme), seed=3,
                                  device="cpu")
    assert llama.fused_group_size(tp.layers, cfg, 1) == 0
    calls = _count_fused(monkeypatch)

    def step():
        c = tkvc.init_cache(2, 1, 64, cfg.num_kv_heads, cfg.head_dim,
                            device="cpu")
        return llama.forward(tp, cfg, torch.tensor([[5]]), c, 0)[0]
    on = step()
    tim.FUSED_DECODE = False
    assert torch.equal(on, step()) and calls == []
    if case == "narrow_embed":  # and JAX falls back the same way
        jcfg = JModelConfig(**dict(FUSABLE, **over))
        jp = jllama.init_random_params(jcfg, JQuantConfig(scheme="w4a16"),
                                       seed=3)
        tp = llama.params_from_numpy(_flat(jp), cfg,
                                     QuantConfig(scheme="w4a16"),
                                     device="cpu")
        tim.FUSED_DECODE = True
        jl, _ = jllama.forward(jp, jcfg, jnp.asarray([[5]]),
                               jkvc.init_cache(2, 1, 64, 2, 64),
                               jnp.int32(0))
        np.testing.assert_allclose(step().numpy(), _f32(jl), atol=2e-2,
                                   rtol=2e-2)
        assert calls == []


def test_fused_switch_reads_its_own_variable():
    """The switch is off by default and its environment variable does not
    use the JAX package's TCE_ prefix (whose registry warns on unknown
    names)."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    code = ("from tinychatengine_tpu_torch.ops import int4_matmul as m; "
            "print(m.FUSED_DECODE)")
    base = {k: v for k, v in os.environ.items()
            if k not in ("TINYCHAT_DECODE_FUSED", "TCE_DECODE_FUSED")}
    for env, want in (({}, "False"), ({"TINYCHAT_DECODE_FUSED": "1"}, "True"),
                      ({"TCE_DECODE_FUSED": "1"}, "False")):
        out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             text=True, env={**base, **env}, timeout=120,
                             cwd=Path(__file__).resolve().parent.parent)
        assert out.stdout.strip() == want, (env, out.stderr)
