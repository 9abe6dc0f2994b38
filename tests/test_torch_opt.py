"""The port's OPT family (fp, int4 and SmoothQuant W8A8) against the JAX
package on the CPU: the forward and its int8 KV cache, ``int8_decode``'s
plain version, the exact int8 products, calibration, checkpoints, the
Engine, serving and perplexity. Inputs are made with numpy from a seed and
the JAX parameters reach the port as numpy (the checkpoint format's
tree-path keys) through ``opt.params_from_numpy``."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinychatengine_tpu.core.config import GenerationConfig as JGen
from tinychatengine_tpu.core.config import ModelConfig as JModelConfig
from tinychatengine_tpu.core.config import QuantConfig as JQuantConfig
from tinychatengine_tpu.generation import kv_cache as jkvc
from tinychatengine_tpu.generation.engine import Engine as JEngine
from tinychatengine_tpu.models import opt as jopt
from tinychatengine_tpu.tools import calibrate_opt as jcal
from tinychatengine_tpu.tools import checkpoint as jckpt
from tinychatengine_tpu_torch.core.config import (GenerationConfig,
                                                  ModelConfig, QuantConfig,
                                                  get_model_config)
from tinychatengine_tpu_torch.generation import kv_cache as tkvc
from tinychatengine_tpu_torch.generation.engine import Engine
from tinychatengine_tpu_torch.models import opt
from tinychatengine_tpu_torch.ops import attention as att
from tinychatengine_tpu_torch.ops import ref
from tinychatengine_tpu_torch.ops.linear import (W8A8Linear, apply_linear,
                                                 s8_matmul)
from tinychatengine_tpu_torch.runtime.serving import ServingEngine
from tinychatengine_tpu_torch.tokenizers.byte_fallback import ByteTokenizer
from tinychatengine_tpu_torch.tools import calibrate_opt as tcal
from tinychatengine_tpu_torch.tools.checkpoint import load_checkpoint
from tinychatengine_tpu_torch.tools.perplexity import perplexity

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "assets" / "byteopt_4m"
# tests/test_opt.py's configs: TINY for fp and W8A8; the int4 packer needs
# K % 256 == 0, so the int4 schemes run TINY4
TINY = dict(name="tiny_opt", family="opt", num_heads=4, num_kv_heads=4,
            num_layers=2, max_sqlen=32, embed_dim=128, hidden_dim=256,
            vocab_size=300)
TINY4 = dict(TINY, name="tiny_opt4", embed_dim=256, hidden_dim=512)


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


def _jax_model(scheme, seed=0, **over):
    """(JAX cfg, port cfg, JAX params, the same params in the port)."""
    d = dict(TINY4 if scheme in ("w4a16", "w4a8") else TINY, **over)
    jcfg, cfg = JModelConfig(**d), ModelConfig(**d)
    jq = JQuantConfig(scheme=scheme, group_size=64)
    jp = jopt.init_random_params(jcfg, quantized=scheme == "w8a8", seed=seed,
                                 qcfg=jq if scheme in ("w4a16", "w4a8")
                                 else None)
    tp = opt.params_from_numpy(_flat(jp), cfg, QuantConfig(scheme=scheme),
                               device="cpu")
    return jcfg, cfg, jp, tp


def _port_flat(p) -> dict:
    out = {}

    def walk(obj, prefix):
        if isinstance(obj, torch.Tensor):
            out[prefix] = obj
        elif obj is not None:
            for name, val in vars(obj).items():
                walk(val, f"{prefix}/{name}" if prefix else name)
    walk(p, "")
    return out


def _as_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype.kind == "V" else a


# prefill and decode logits of the 2-layer models: fp and int4 round bf16
# caches and sum in other orders (a few bf16 steps of logits of order 1,
# W4A8 adds an activation-code flip now and then); W8A8's integer products
# are exact on both sides, so only the f32 rounding of LN, softmax and
# acc * alpha + bias remains: an int8 code on a .5 boundary may come out
# one apart (XLA may fuse the multiply-add), a handful in the cache
@pytest.mark.parametrize("scheme,tol", [("fp", 2e-2), ("w8a8", 1e-3),
                                        ("w4a16", 2e-2), ("w4a8", 4e-2)])
def test_forward_prefill_decode_and_cache_match_jax(scheme, tol):
    jcfg, cfg, jp, tp = _jax_model(scheme)
    s8 = scheme == "w8a8"
    shape = (2, 1, 32, 4, cfg.head_dim)
    jc = jkvc.init_cache(*shape, dtype=jnp.int8 if s8 else jnp.bfloat16)
    tc = tkvc.init_cache(*shape, dtype=torch.int8 if s8 else torch.bfloat16,
                         device="cpu")
    ids = np.random.default_rng(0).integers(0, 300, (1, 16))
    # a 12-token prompt right-padded to 16 (bucket padding)
    jl, jc = jopt.forward(jp, jcfg, jnp.asarray(ids), jc, jnp.int32(0),
                          true_len=jnp.int32(12))
    tl, tc = opt.forward(tp, cfg, torch.from_numpy(ids), tc, 0, true_len=12)
    assert tc.length == 12 and tl.shape == (1, 300)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol, rtol=tol)
    for step in range(3):
        tok = int(np.argmax(np.asarray(jl)[0]))
        jl, jc = jopt.forward(jp, jcfg, jnp.asarray([[tok]]), jc,
                              jnp.int32(12 + step))
        tl, tc = opt.forward(tp, cfg, torch.tensor([[tok]]), tc, 12 + step)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol,
                                   rtol=tol)
    jk, jv = (np.asarray(c).astype(np.float32)[:, :, :, :15]
              for c in (jc.k, jc.v))
    tk, tv = (c.float().numpy()[:, :, :, :15] for c in (tc.k, tc.v))
    if s8:  # raw int8 codes, no scales
        assert tc.k.dtype == torch.int8 and tc.k_scale is None
        for t, j in ((tk, jk), (tv, jv)):
            assert np.abs(t - j).max() <= 1 and (t != j).mean() <= 5e-3
    else:
        np.testing.assert_allclose(tk, jk, atol=tol, rtol=tol)
        np.testing.assert_allclose(tv, jv, atol=tol, rtol=tol)


def test_ragged_start_and_return_hidden_match_jax():
    """Per-row start (the serving decode) and the pre-final-LN states."""
    jcfg, cfg, jp, tp = _jax_model("w8a8", seed=3)
    ids = np.random.default_rng(1).integers(0, 300, (2, 6))
    jc = jkvc.init_cache(2, 2, 32, 4, 32, dtype=jnp.int8)
    tc = tkvc.init_cache(2, 2, 32, 4, 32, dtype=torch.int8, device="cpu")
    _, jc = jopt.forward(jp, jcfg, jnp.asarray(ids), jc, jnp.int32(0))
    opt.forward(tp, cfg, torch.from_numpy(ids), tc, 0)
    starts = np.array([6, 4], np.int32)  # row 1 rewinds two positions
    jl, _ = jopt.forward(jp, jcfg, jnp.asarray([[7], [9]]), jc,
                         jnp.asarray(starts))
    tl, _ = opt.forward(tp, cfg, torch.tensor([[7], [9]]), tc,
                        torch.from_numpy(starts))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-3,
                               rtol=1e-3)
    jh, _ = jopt.forward(jp, jcfg, jnp.asarray(ids), jkvc.init_cache(
        2, 2, 32, 4, 32, dtype=jnp.int8), jnp.int32(0), return_hidden=True)
    th, hc = opt.forward(tp, cfg, torch.from_numpy(ids), tkvc.init_cache(
        2, 2, 32, 4, 32, dtype=torch.int8, device="cpu"), 0,
        return_hidden=True)
    assert th.shape == (2, 6, 128) and hc.length == 6
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-3,
                               rtol=1e-4)
    with pytest.raises(NotImplementedError):
        opt.forward(tp, cfg, torch.from_numpy(ids), tc, 0, tp_axis="model")


@pytest.mark.parametrize("scheme", ["fp", "w8a8"])
def test_init_random_params_equals_jax(scheme):
    """fp and W8A8 leaves come from numpy in the JAX package's order: the
    same values bit for bit (W8A8 weights kept N-major)."""
    jcfg, cfg = JModelConfig(**TINY), ModelConfig(**TINY)
    jflat = _flat(jopt.init_random_params(jcfg, quantized=scheme == "w8a8",
                                          seed=4))
    tp = opt.init_random_params(cfg, quantized=scheme == "w8a8", seed=4,
                                device="cpu")
    tflat = _port_flat(tp)
    assert sorted(tflat) == sorted(jflat)
    for key, t in tflat.items():
        np.testing.assert_array_equal(_as_np(t), _as_np(jflat[key]),
                                      err_msg=key)
    if scheme == "w8a8":
        assert tp.layers.fc1.weight.stride()[1:] == (1, 128)  # N-major


@pytest.mark.parametrize("scheme", ["w4a16", "w4a8"])
def test_int4_init_has_the_jax_structure(scheme):
    jcfg, cfg = JModelConfig(**TINY4), ModelConfig(**TINY4)
    jq = JQuantConfig(scheme=scheme, group_size=64)
    jflat = _flat(jopt.init_random_params(jcfg, seed=0, qcfg=jq))
    tp = opt.init_random_params(cfg, seed=0, device="cpu",
                                qcfg=QuantConfig(scheme=scheme, group_size=64))
    tflat = _port_flat(tp)
    assert sorted(tflat) == sorted(jflat)
    for key, t in tflat.items():
        assert tuple(t.shape) == jflat[key].shape, key
    out, _ = opt.forward(tp, cfg, torch.tensor([[1, 2, 3]]), tkvc.init_cache(
        2, 1, 32, 4, 64, device="cpu"), 0)
    assert out.shape == (1, 300) and torch.isfinite(out).all()


def test_fast_w8a8_params_have_the_bench_structure():
    """``fast=True``: the JAX package's scripts/bench_opt_w8a8.py layout
    (stacked W8A8 containers, per-layer alphas, tied bf16 head)."""
    cfg = ModelConfig(**TINY)
    p = opt.init_random_params(cfg, quantized=True, fast=True, seed=0,
                               device="cpu")
    assert p.layers.q_proj.weight.shape == (2, 128, 128)
    assert p.layers.fc2.weight.shape == (2, 256, 128)
    assert p.layers.fc1.weight.dtype == torch.int8
    assert p.layers.out_proj.alpha.tolist() == pytest.approx([0.004] * 2)
    assert float(p.layers.q_proj.bias.abs().max()) <= 8.0
    assert p.lm_head.weight.shape == (128, 300)
    out, _ = opt.forward(p, cfg, torch.tensor([[1, 2, 3]]), tkvc.init_cache(
        2, 1, 32, 4, 32, dtype=torch.int8, device="cpu"), 0)
    assert torch.isfinite(out).all()
    with pytest.raises(ValueError):
        opt.init_random_params(cfg, fast=True, device="cpu")


# ---- int8_decode's plain version ------------------------------------------

def _int8_inputs(seed=3, lengths=(37, 512, 0)):
    rng = np.random.default_rng(seed)
    L, B, H, S, D = 2, len(lengths), 4, 512, 128
    ck = rng.integers(-127, 128, (L, B, H, S, D)).astype(np.int8)
    cv = rng.integers(-127, 128, (L, B, H, S, D)).astype(np.int8)
    q = rng.integers(-127, 128, (B, H, D)).astype(np.int8)
    return q, ck, cv, np.asarray(lengths, np.int32)


def test_int8_decode_plain_matches_jax_kernel():
    """Against the TPU kernel in interpret mode, ragged lengths and a row
    of length 0 (zeros on both sides), at the JAX test's tolerance."""
    from tinychatengine_tpu.ops.attention import int8_decode as j_int8_decode
    q, ck, cv, lengths = _int8_inputs()
    qk_alpha, pv_alpha = 1.7e-4, 2.3e-3
    for li in range(2):
        want = np.asarray(j_int8_decode(
            jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.int32(li),
            jnp.asarray(lengths), qk_alpha, pv_alpha, interpret=True))
        got = att.int8_decode(torch.from_numpy(q), torch.from_numpy(ck),
                              torch.from_numpy(cv), li,
                              torch.from_numpy(lengths), qk_alpha, pv_alpha)
        assert got.dtype == torch.float32 and got.shape == (3, 4, 128)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=5e-3)
        assert not got[2].any()


def _int8_split_model(q, ck, cv, li, lengths, qk_alpha, pv_alpha):
    """``int8_decode``'s split on the CPU (``csrc/int8_decode.cu``): chunks
    of INT8_SPLIT keys from position 0, each with its (m_c, l_c) over its
    valid keys ((-1e30, 0) when it has none); the row's m = max m_c and l =
    sum l_c exp(m_c - m), merged in ascending chunk order; the probabilities
    requantized x127 against (m, l); each chunk's int32 PV partial, summed,
    times pv_alpha. Returns f32 [B, H, D]."""
    split = att.INT8_SPLIT
    k, v = ck[li].float(), cv[li].float()  # [B, H, S, D], exact codes
    s = torch.einsum("bhd,bhtd->bht", q.float(), k) * torch.tensor(
        qk_alpha, dtype=torch.float32)
    valid = torch.arange(k.shape[2])[None, None] < torch.as_tensor(
        lengths).reshape(-1, 1, 1)
    s = torch.where(valid, s, torch.tensor(-1e30))
    stats = []
    for c0 in range(0, k.shape[2], split):
        sc, ok = s[..., c0:c0 + split], valid[..., c0:c0 + split]
        m_c = sc.amax(-1)
        l_c = torch.where(ok, torch.exp(sc - m_c[..., None]), 0.0).sum(-1)
        stats.append((m_c, l_c))
    m = torch.stack([m_c for m_c, _ in stats]).amax(0)
    l = torch.zeros_like(m)
    for m_c, l_c in stats:
        l = l + l_c * torch.exp(m_c - m)
    p = torch.exp(s - m[..., None]) / torch.clamp(l, min=1e-30)[..., None]
    p_s8 = torch.where(valid, torch.clamp(torch.round(p * 127.0), -128, 127),
                       0.0).to(torch.int64)
    total = torch.zeros(q.shape, dtype=torch.int64)
    for c0 in range(0, k.shape[2], split):  # exact int partials
        total += torch.einsum("bht,bhtd->bhd", p_s8[..., c0:c0 + split],
                              cv[li][:, :, c0:c0 + split].to(torch.int64))
    return total.to(torch.float32) * torch.tensor(pv_alpha,
                                                  dtype=torch.float32)


def test_int8_decode_split_matches_jax_kernel():
    """The CUDA kernel's split (``_int8_split_model``) against the TPU
    kernel in interpret mode, at lengths on, just before and just after the
    64-key chunk edges, a row of S_max keys and a row of length 0 (zeros on
    both sides): held to ``chip_smoke.int8_err``'s two limits (each element
    within 256 units of pv_alpha, at most 1 % of (row, head) pairs
    differing at all). The merged l rounds in another order than the TPU
    kernel's running sum, which can move one p * 127 across a .5 boundary."""
    import chip_smoke
    from tinychatengine_tpu.ops.attention import int8_decode as j_int8_decode
    split = att.INT8_SPLIT
    lengths = (0, 1, split - 1, split, split + 1, 2 * split - 1, 2 * split,
               2 * split + 1, 320, 512)
    q, ck, cv, ln = _int8_inputs(seed=4, lengths=lengths)
    qk_alpha, pv_alpha = 3e-5, 1e-3
    for li in range(2):
        want = np.asarray(j_int8_decode(
            jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.int32(li),
            jnp.asarray(ln), qk_alpha, pv_alpha, interpret=True))
        got = _int8_split_model(torch.from_numpy(q), torch.from_numpy(ck),
                                torch.from_numpy(cv), li,
                                torch.from_numpy(ln), qk_alpha, pv_alpha)
        assert not got[0].any() and not want[0].any()
        assert chip_smoke.int8_err(got, torch.from_numpy(want),
                                   pv_alpha)[2] <= 1.0
        assert int(got.abs().max()) > 0


def test_int8_decode_plain_matches_the_dense_w8a8_branch():
    """At one query position the plain decode is the model's dense int8
    dataflow restricted to each row's valid length: the int8 requant of
    both outputs is identical."""
    q, ck, cv, lengths = _int8_inputs(seed=5, lengths=(1, 200, 512))
    qk_alpha, pv_alpha = 3e-5, 1e-3
    tq, tk, tv = (torch.from_numpy(a) for a in (q, ck, cv))
    ln = torch.from_numpy(lengths)
    dec = att.int8_decode_plain(tq, tk, tv, 1, ln, qk_alpha, pv_alpha)
    dec_s8 = torch.clamp(torch.round(dec), -128, 127).to(torch.int8)
    dense = opt._s8_attention(tq[:, None], tk[1], tv[1],
                              torch.tensor(qk_alpha), torch.tensor(pv_alpha),
                              (ln.long() - 1)[:, None], ln)
    assert torch.equal(dense.reshape(3, 4, 128), dec_s8)
    assert int(dec_s8.abs().max()) > 0


# ---- exact int8 products --------------------------------------------------

def test_s8_matmul_exact_at_k16384():
    """K = 16384: |sum| reaches 2^28, beyond fp32's exact integers, and
    int8 @ int8 in torch returns int8 and wraps; s8_matmul is exact."""
    rng = np.random.default_rng(0)
    k = 16384
    x = rng.integers(-128, 128, (3, k)).astype(np.int8)
    x[0] = -128
    x[1] = 127
    w = rng.integers(-128, 128, (k, 16)).astype(np.int8)
    w[:, 0] = -128  # row 0 x column 0 sums 128^2 * 16384 = 2^28
    w[:, 1] = 127
    w[0, 1] = 126   # row 1 x column 1: 127^2 * 16384 - 127, odd, > 2^24
    want = x.astype(np.int64) @ w.astype(np.int64)
    got = s8_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0, 0] == 2 ** 28 and want[1, 1] == 127 ** 2 * k - 127
    f32 = torch.from_numpy(x).float() @ torch.from_numpy(w).float()
    assert float(f32[1, 1]) != want[1, 1]  # no f32 holds that integer
    wrapped = torch.from_numpy(x) @ torch.from_numpy(w)
    assert wrapped.dtype == torch.int8
    assert not np.array_equal(wrapped.numpy().astype(np.int64), want)


@pytest.mark.parametrize("out_int8,relu", [(True, False), (True, True),
                                           (False, False)])
def test_w8a8_linear_matches_jax_and_the_oracle(out_int8, relu):
    from tinychatengine_tpu.ops.linear import W8A8Linear as JW8A8
    from tinychatengine_tpu.ops.linear import apply_linear as japply
    rng = np.random.default_rng(7)
    w = rng.integers(-127, 128, (2, 256, 64)).astype(np.int8)
    bias = rng.standard_normal((2, 64)).astype(np.float32) * 8
    alpha = np.asarray([0.002, 0.003], np.float32)
    x = rng.integers(-128, 128, (3, 5, 256)).astype(np.int8)
    want = np.asarray(japply(JW8A8(jnp.asarray(w), jnp.asarray(alpha),
                                   jnp.asarray(bias)), jnp.asarray(x),
                             out_int8=out_int8, relu=relu,
                             layer_idx=jnp.int32(1)))
    lin = W8A8Linear(torch.from_numpy(w), torch.from_numpy(alpha),
                     torch.from_numpy(bias))
    got = apply_linear(lin, torch.from_numpy(x), out_int8=out_int8,
                       relu=relu, layer_idx=1)
    np.testing.assert_array_equal(got.numpy(), want)
    if out_int8 and not relu:
        oracle = ref.w8a8_linear_ref(torch.from_numpy(x),
                                     torch.from_numpy(w[1].T.copy()),
                                     torch.tensor(alpha[1]),
                                     torch.from_numpy(bias[1]))
        np.testing.assert_array_equal(oracle.numpy(), want)


def test_layer_norm_refs_match_jax():
    from tinychatengine_tpu.ops import ref as jref
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 5, 64)) * 3).astype(np.float32)
    w = (rng.standard_normal(64) * 20).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    args = [torch.from_numpy(a) for a in (x, w, b)]
    np.testing.assert_allclose(
        ref.layer_norm_ref(*args).numpy(),
        np.asarray(jref.layer_norm_ref(*map(jnp.asarray, (x, w, b)))),
        rtol=1e-5, atol=1e-5)
    got = ref.layer_norm_q_ref(*args)
    want = np.asarray(jref.layer_norm_q_ref(*map(jnp.asarray, (x, w, b))))
    assert got.dtype == torch.int8
    # round half to even on both sides; an f32 ulp may move a value that
    # sits on a .5 boundary
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1
    assert (got.numpy() != want).mean() < 1e-2


# ---- byteopt_4m: calibration, checkpoints, Engine, perplexity --------------

@pytest.fixture(scope="module")
def byteopt():
    """(port cfg, JAX fp params, port fp params, JAX W8A8 params)."""
    if not (CKPT / "meta.json").exists():
        pytest.skip("trained OPT checkpoint not present")
    from tinychatengine_tpu.core.config import get_model_config as jget
    jcfg, cfg = jget("byteopt_4m"), get_model_config("byteopt_4m")
    jfp, _ = jckpt.load_checkpoint(str(CKPT), jcfg)
    tfp, qcfg = load_checkpoint(str(CKPT), cfg, device="cpu")
    assert qcfg.scheme == "fp"
    jq = jcal.quantize_opt_w8a8(jfp, jcfg, _calib(), smooth_alpha=0.5)
    return cfg, jfp, tfp, jq


def _calib() -> np.ndarray:
    import chip_smoke
    return chip_smoke.byteopt_calib_ids()


def test_byteopt_checkpoint_loads_leaf_by_leaf(byteopt):
    _, jfp, tfp, _ = byteopt
    jflat, tflat = _flat(jfp), _port_flat(tfp)
    assert sorted(tflat) == sorted(jflat)
    for key in jflat:
        assert tflat[key].dtype == torch.bfloat16, key
        np.testing.assert_array_equal(_as_np(tflat[key]), _as_np(jflat[key]),
                                      err_msg=key)


def test_activation_stats_match_jax(byteopt):
    cfg, jfp, tfp, _ = byteopt
    from tinychatengine_tpu.core.config import get_model_config as jget
    want = jcal.collect_activation_stats(jfp, jget("byteopt_4m"), _calib(),
                                         per_channel=True)
    got = tcal.collect_activation_stats(tfp, cfg, _calib(), per_channel=True)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for name in w:
            np.testing.assert_allclose(np.asarray(g[name], np.float32),
                                       np.asarray(w[name], np.float32),
                                       rtol=1e-4, err_msg=name)


def test_quantize_opt_w8a8_matches_jax_given_its_stats(byteopt, monkeypatch):
    """From JAX's activation statistics the port's quantization gives the
    same int8 weights bit for bit and alphas, LN folds and biases within
    1e-6 relative (numpy f32 on both sides)."""
    cfg, jfp, tfp, jq = byteopt
    from tinychatengine_tpu.core.config import get_model_config as jget
    stats = jcal.collect_activation_stats(jfp, jget("byteopt_4m"), _calib(),
                                          per_channel=True)
    monkeypatch.setattr(tcal, "collect_activation_stats",
                        lambda *a, **k: stats)
    tq = tcal.quantize_opt_w8a8(tfp, cfg, _calib(), 0.5, device="cpu")
    jflat, tflat = _flat(jq), _port_flat(tq)
    assert sorted(tflat) == sorted(jflat)
    for key in jflat:
        got, want = _as_np(tflat[key]), _as_np(jflat[key])
        if want.dtype == np.int8:
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                       err_msg=key)
    assert isinstance(tq.layers.fc1, W8A8Linear)


@pytest.mark.parametrize("scheme", ["w8a8", "w4a16", "w4a8"])
def test_checkpoint_written_by_jax_loads(tmp_path, scheme):
    jcfg, cfg, jp, _ = _jax_model(scheme, seed=2)
    jq = JQuantConfig(scheme=scheme, group_size=64)
    jckpt.save_checkpoint(str(tmp_path / "c"), jp, jcfg, jq,
                          extra_meta={"family": "opt"})
    tp, qcfg = load_checkpoint(str(tmp_path / "c"), cfg, device="cpu")
    assert qcfg.scheme == scheme
    if scheme == "w8a8":
        assert tp.layers.q_proj.weight.dtype == torch.int8
        assert isinstance(tp.layers.fc2, W8A8Linear)
    ids = np.random.default_rng(3).integers(0, 300, (1, 8))
    s8 = scheme == "w8a8"
    shape = (2, 1, 32, 4, cfg.head_dim)
    jl, _ = jopt.forward(jp, jcfg, jnp.asarray(ids), jkvc.init_cache(
        *shape, dtype=jnp.int8 if s8 else jnp.bfloat16), jnp.int32(0))
    tl, _ = opt.forward(tp, cfg, torch.from_numpy(ids), tkvc.init_cache(
        *shape, dtype=torch.int8 if s8 else torch.bfloat16, device="cpu"), 0)
    tol = 1e-3 if s8 else 4e-2
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol, rtol=tol)


def _greedy(n):
    return (GenerationConfig(temp=0.0, n_predict=n, repeat_penalty=1.0,
                             repeat_last_n=1),
            JGen(temp=0.0, n_predict=n, repeat_penalty=1.0, repeat_last_n=1))


def test_engine_w8a8_greedy_matches_jax_tiny():
    jcfg, cfg, jp, tp = _jax_model("w8a8", max_sqlen=64)
    g, jg = _greedy(8)
    prompt = np.array([[5, 9, 11, 40, 2]])
    want = JEngine(jp, jcfg, JQuantConfig(scheme="w8a8")).generate(
        prompt, jg).tokens[0]
    eng = Engine(tp, cfg, QuantConfig(scheme="w8a8"), device="cpu")
    assert eng.new_cache().k.dtype == torch.int8
    assert eng.generate(prompt, g).tokens[0] == list(want)
    assert eng.generate_device(prompt, g)[0].tolist() == list(want)


@pytest.fixture(scope="module")
def byteopt_w8a8(byteopt):
    """JAX's calibrated W8A8 byteopt_4m carried across to the port."""
    cfg, _, _, jq = byteopt
    return opt.params_from_numpy(_flat(jq), cfg, QuantConfig(scheme="w8a8"),
                                 device="cpu")


def test_engine_w8a8_greedy_matches_jax_byteopt(byteopt, byteopt_w8a8):
    cfg, _, _, jq = byteopt
    from tinychatengine_tpu.core.config import get_model_config as jget
    g, jg = _greedy(32)
    prompt = np.asarray(ByteTokenizer().encode("def forward(self, x):\n"))
    want = JEngine(jq, jget("byteopt_4m"), JQuantConfig(scheme="w8a8"),
                   max_len=256).generate(prompt[None], jg).tokens[0]
    got = Engine(byteopt_w8a8, cfg, QuantConfig(scheme="w8a8"), max_len=256,
                 device="cpu").generate(prompt[None], g).tokens[0]
    assert got == list(want), ByteTokenizer().decode(got)


def test_serving_w8a8_matches_engine_and_jax():
    """Twin of the JAX package's test_serving_opt_w8a8_matches_engine: the
    port's serving equals its Engine equals JAX's; the slot cache is raw
    int8 and a paged server raises."""
    jcfg, cfg, jp, tp = _jax_model("w8a8", max_sqlen=64)
    g, jg = _greedy(8)
    prompts = [np.array([5, 9, 11]), np.array([7, 3]),
               np.array([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12])]
    jeng = JEngine(jp, jcfg, JQuantConfig(scheme="w8a8"), batch=1,
                   max_len=64)
    want = [list(jeng.generate(p[None], jg).tokens[0]) for p in prompts]
    eng = Engine(tp, cfg, QuantConfig(scheme="w8a8"), device="cpu")
    assert [eng.generate(p[None], g).tokens[0] for p in prompts] == want
    srv = ServingEngine(tp, cfg, QuantConfig(scheme="w8a8"), slots=2, gcfg=g,
                        forward_fn=opt.forward, device="cpu")
    assert srv.cache.k.dtype == torch.int8 and srv.cache.k_scale is None
    assert not srv._batch_admit  # batched admission is llama's only
    reqs = [srv.submit(p, n_predict=8) for p in prompts]
    srv.run()
    assert [r.output_ids for r in reqs] == want
    with pytest.raises(NotImplementedError):
        ServingEngine(tp, cfg, QuantConfig(scheme="w8a8"), slots=2, gcfg=g,
                      paged=True, forward_fn=opt.forward, device="cpu")
    with pytest.raises(ValueError):  # OPT through llama's forward
        ServingEngine(tp, cfg, QuantConfig(scheme="w8a8"), device="cpu")


def test_serving_byteopt_w8a8_matches_engine(byteopt, byteopt_w8a8):
    cfg = byteopt[0]
    g, _ = _greedy(24)
    tok = ByteTokenizer()
    prompts = [np.asarray(tok.encode(t)) for t in
               ("import numpy as np\n", "class Engine:\n    def ",
                "# Copyright 2024\n")]
    eng = Engine(byteopt_w8a8, cfg, QuantConfig(scheme="w8a8"), max_len=256,
                 device="cpu")
    want = [eng.generate(p[None], g).tokens[0] for p in prompts]
    srv = ServingEngine(byteopt_w8a8, cfg, QuantConfig(scheme="w8a8"),
                        slots=2, max_len=256, gcfg=g, forward_fn=opt.forward,
                        device="cpu")
    reqs = [srv.submit(p) for p in prompts]
    srv.run()
    assert [r.output_ids for r in reqs] == want


@pytest.mark.parametrize("scheme", ["fp", "w8a8"])
def test_perplexity_matches_jax(byteopt, byteopt_w8a8, scheme):
    """Same windows and masking as the JAX harness, on 1024 eval tokens
    (opt.forward has no RoPE table)."""
    from tinychatengine_tpu.core.config import get_model_config as jget
    from tinychatengine_tpu.tools.perplexity import perplexity as jppl
    cfg, jfp, tfp, jq = byteopt
    text = (CKPT / "eval_sample.txt").read_text(encoding="utf-8")
    ids = np.asarray(ByteTokenizer().encode(text))[:1024]
    tp, jp = (tfp, jfp) if scheme == "fp" else (byteopt_w8a8, jq)
    got = perplexity(opt.forward, tp, cfg, ids, 512, 256)
    want = jppl(jopt.forward, jp, jget("byteopt_4m"), ids, 512, 256)
    assert got < 3.5
    assert abs(got - want) / want < 2e-3


def test_chip_smoke_opt_phases_rehearse_on_cpu(byteopt):
    """chip_smoke.py's OPT phases on the CPU at byteopt_4m's size (the card
    runs opt_6.7b): control flow, shapes, the 2-layer cut, launch counts
    (none: the CPU takes the plain versions), serving lengths, the byteopt
    budgets and agreements."""
    import chip_smoke
    launches, per_step, metrics = chip_smoke.main_path(
        model="byteopt_4m", dev="cpu", long_len=512)
    assert not any(launches.values()) and not any(per_step.values())
    assert metrics["decode_tok_s"] > 0 and metrics["cut_err"] == 0.0
    serving = chip_smoke.serving_path(model="byteopt_4m", dev="cpu",
                                      n_requests=4, n_predict=6, max_len=512)
    assert list(serving) == ["dense"] and serving["dense"]["tokens"] == 24
    out = chip_smoke.opt_real_weights(dev="cpu")
    assert out["ppl"]["w8a8"] <= out["ppl"]["fp"] * 1.01
    assert min(out["fp card_vs_cpu"]) == min(out["w8a8 card_vs_cpu"]) == 32
    assert min(out["w8a8 serving_vs_engine"]) == 32
