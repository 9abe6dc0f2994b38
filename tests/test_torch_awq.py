"""The port's AWQ (``quant/awq.py``) against the JAX package's on the same
inputs (CPU twins of tests/test_awq.py).

Tolerances, each measured here on the CPU:
- the int4 round trip of the search (``rtn_kn``, the card's quantizer run
  on CPU tensors) equals numpy's bit for bit on weights built on the code
  boundaries, where dividing by d, or one fused multiply-add, moves codes;
- ``search_scale`` on the same x and w: the same alpha, ``s`` bit-equal,
  losses within 1e-12 relative (numpy's products on both sides); the torch
  products (``_losses_torch``, the card's route run on the CPU) within
  1e-6 relative of numpy's (another library's f32 y_ref);
- ``awq_scale_llama`` fed JAX's activations: the scaled tree bit-identical
  to JAX's (RoPE tables within 2e-6, as the converters' are) and the
  requantized packed bytes equal;
- end to end (each package's own calibration forward): activations within
  2e-2 of the largest (the 2-layer forward's tolerance), grid losses
  within 5e-3 relative (1.2e-3 read: the two forwards round bf16
  activations apart), alphas equal wherever JAX's runner-up loss is more
  than 1e-2 relative away (twice that bound), and the folded model
  function-preserving within 3e-2 of max |logit| (tests/test_awq.py's
  bound) with the same argmax wherever the top two logits lie more than
  twice that apart.
"""

import numpy as np
import pytest
import torch

from tinychatengine_tpu.core.config import ModelConfig as JModelConfig
from tinychatengine_tpu.core.config import QuantConfig as JQuantConfig
from tinychatengine_tpu.quant import awq as jawq
from tinychatengine_tpu.quant import numerics as jnum
from tinychatengine_tpu.tools import convert as jcv
from tinychatengine_tpu_torch.core.config import ModelConfig, QuantConfig
from tinychatengine_tpu_torch.generation import kv_cache as kvc
from tinychatengine_tpu_torch.models import llama
from tinychatengine_tpu_torch.quant import awq as tawq
from tinychatengine_tpu_torch.tools import convert as tcv
from chip_smoke import boundary_weight
from test_torch_convert import (_hf_llama_tensors, assert_tree_equal,
                                write_hf)

TINY = dict(name="tiny", family="llama", num_heads=4, num_kv_heads=2,
            num_layers=2, max_sqlen=64, embed_dim=256, hidden_dim=512,
            vocab_size=300, rms_norm_eps=1e-5, rope_theta=10000.0)
LOSS_RTOL = 5e-3
E2E_GRID = 10


def test_rtn_cast_points_are_eager_numpys():
    """``rtn_kn`` equals numpy's ``_rtn`` bit for bit where the form of the
    arithmetic decides codes: eager numpy divides 1 by d truly, multiplies
    by that inverse and adds 8.5 in two roundings (XLA's product by a
    constant's reciprocal does not apply to it). Dividing x by d instead,
    or one fused multiply-add, moves codes on these weights."""
    w = boundary_weight()                   # [OC, IC], groups along IC
    want = jawq._rtn(w.T, 128)              # JAX's, [K, N]
    got = tawq.rtn_kn(torch.from_numpy(w.T.copy()), 128).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tawq._rtn(w.T, 128), want)
    q, s = jnum.quantize_groupwise_int4(w, 128)
    g, d = w.reshape(-1, 1, 128), s[..., None]
    by_div = np.clip(g / d + np.float32(8.5), 0, 15).astype(np.uint8)
    inv = np.float32(1.0) / d
    fused = np.clip((g.astype(np.float64) * inv + 8.5).astype(np.float32),
                    0, 15).astype(np.uint8)
    assert (by_div.reshape(q.shape) != q).sum() > 0
    assert (fused.reshape(q.shape) != q).sum() > 0


def test_chip_smoke_faulted_searches_are_faults():
    """chip_smoke.py's FAULTED_SEARCHES, which AWQ_HOST_RTOL must separate
    from the sound search on the card, each change what they replace: the
    divided and the fused quantizers move codes on the boundary weights
    (as the numpy forms above), the f32 grid moves s."""
    import chip_smoke
    w = torch.from_numpy(boundary_weight().T.copy())
    want = tawq.rtn_kn(w, 128)
    for form in ("div", "fma"):
        attr, make = chip_smoke.FAULTED_SEARCHES[form]
        assert attr == "rtn_kn"
        assert not torch.equal(make(tawq.rtn_kn)(w, 128), want), form
    attr, make = chip_smoke.FAULTED_SEARCHES["s32"]
    s_base = np.linspace(0.01, 30.0, 256).astype(np.float32)
    sound = list(tawq._grid(s_base, 8))
    faulted = list(make(tawq._grid)(s_base, 8))
    assert attr == "_grid" and [a for a, _ in faulted] == [a for a, _ in sound]
    assert not all(np.array_equal(a[1], b[1]) for a, b in zip(sound, faulted))


def _search_inputs(case):
    rng = np.random.default_rng({"random": 0, "salient": 1, "gqa": 2}[case])
    k, n = 256, 128
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    x = rng.standard_normal((512, k)).astype(np.float32)
    s_base = None
    if case == "salient":  # tests/test_awq.py's motif
        x[:, 7] *= 50.0
        w[7, :] *= 0.02
    if case == "gqa":  # a group-constant s_base, as the wo search passes
        mag = np.mean(np.abs(x), axis=0).reshape(2, 2, 64).mean(1)
        s_base = np.repeat(mag[:, None, :], 2, 1).reshape(-1)
    return x, w, s_base


@pytest.mark.parametrize("case", ["random", "salient", "gqa"])
def test_search_scale_matches_jax(case):
    x, w, s_base = _search_inputs(case)
    s, alpha, losses = tawq.search_scale(x, w, 128, s_base=s_base,
                                         device="cpu")
    js, jalpha, jlosses = jawq.search_scale(x, w, 128, s_base=s_base)
    assert alpha == jalpha
    assert s.dtype == np.float64 and np.asarray(js).dtype == np.float64
    np.testing.assert_array_equal(s, js)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-12, atol=0)
    assert min(losses) <= losses[0]
    if case == "salient":
        assert alpha > 0 and min(losses) < 0.9 * losses[0]


def test_search_losses_in_torch_match_numpy():
    """The card's route (``_losses_torch``: torch products, column slices
    of 64) on CPU tensors against numpy's losses: within 1e-6 relative."""
    x, w, _ = _search_inputs("salient")
    s_base = np.maximum(np.mean(np.abs(x), axis=0), np.float32(1e-8))
    grid = list(tawq._grid(s_base, 8))
    host = tawq._losses_host(x, w, 128, grid)
    dev = tawq._losses_torch(torch.from_numpy(x), torch.from_numpy(w), 128,
                             grid, chunk=64)
    np.testing.assert_allclose(dev, host, rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """One HF llama with AWQ's motif, converted to fp by both packages,
    512 calibration ids (one CLI window) and JAX's activations on them."""
    root = tmp_path_factory.mktemp("hf")
    jcfg, cfg = JModelConfig(**TINY), ModelConfig(**TINY)
    write_hf(root, _hf_llama_tensors(cfg, np.random.default_rng(3), False,
                                     motif=True), "safetensors")
    tp = tcv.convert_hf_llama(str(root), cfg, QuantConfig(scheme="fp"),
                              device="cpu")
    jp = jcv.convert_hf_llama(str(root), jcfg, JQuantConfig(scheme="fp"))
    calib = np.random.default_rng(4).integers(0, cfg.vocab_size, (1, 512))
    acts = jawq.collect_calibration_inputs(jp, jcfg, calib)
    return dict(root=root, jcfg=jcfg, cfg=cfg, jp=jp, tp=tp, calib=calib,
                acts=acts)


def _feed_jax_activations(monkeypatch, acts, n_layers):
    """Patch the port's calibration forward to yield JAX's activations."""
    def jax_layers(params, cfg, ids):
        for i in range(n_layers):
            yield {k: torch.from_numpy(acts[k][i]) for k in tawq.SITES}
        yield {"lm_head": torch.from_numpy(acts["lm_head"])}
    monkeypatch.setattr(tawq, "calibration_layers", jax_layers)


def test_awq_given_jax_activations_is_bit_identical(models, monkeypatch):
    """With JAX's activations (the port's calibration patched) the scaled
    tree equals JAX's bit for bit and so do the requantized bytes."""
    m = models
    _feed_jax_activations(monkeypatch, m["acts"], m["cfg"].num_layers)
    got, info = tawq.awq_scale_llama(m["tp"], m["cfg"], m["calib"],
                                     group_size=64, n_grid=8)
    want, jinfo = jawq.awq_scale_llama(m["jp"], m["jcfg"], m["calib"],
                                       group_size=64, n_grid=8)
    assert info["alpha"] == jinfo["alpha"]
    assert_tree_equal(got, want)
    assert_tree_equal(
        tcv.requantize_llama(got, QuantConfig(scheme="w4a8", group_size=64)),
        jcv.requantize_llama(want, JQuantConfig(scheme="w4a8",
                                                group_size=64)))


def test_convert_cli_awq_matches_jax(models, monkeypatch, tmp_path, capsys):
    """``python -m tinychatengine_tpu_torch.tools.convert --awq-calib`` (a
    .npy of ids, one 512-token window) against JAX's ``main`` on the same
    HF directory, the port's calibration fed JAX's activations: the same
    printed alphas and checkpoints equal file for file (with the port's own
    calibration the end-to-end tolerance below applies)."""
    from test_torch_convert import assert_ckpt_equal
    from tinychatengine_tpu.core.config import MODEL_REGISTRY as JREGISTRY
    from tinychatengine_tpu_torch.core.config import MODEL_REGISTRY
    m = models
    monkeypatch.setitem(JREGISTRY, "tiny", m["jcfg"])
    monkeypatch.setitem(MODEL_REGISTRY, "tiny", m["cfg"])
    _feed_jax_activations(monkeypatch, m["acts"], m["cfg"].num_layers)
    np.save(tmp_path / "calib.npy", m["calib"])
    args = ["--model", "tiny", "--src", str(m["root"]), "--scheme", "w4a16",
            "--group-size", "64", "--awq-calib", str(tmp_path / "calib.npy"),
            "--awq-windows", "1"]
    tcv.main(args + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    port_out = capsys.readouterr().out
    jcv.main(args + ["--out", str(tmp_path / "jax")])
    jax_out = capsys.readouterr().out
    alphas = [ln for ln in port_out.splitlines() if ln.startswith("awq")]
    assert alphas and alphas == [ln for ln in jax_out.splitlines()
                                 if ln.startswith("awq")]
    assert_ckpt_equal(tmp_path / "port", tmp_path / "jax")


def _logits(params, cfg, ids):
    cache = kvc.init_cache(cfg.num_layers, 1, cfg.max_sqlen,
                           cfg.num_kv_heads, cfg.head_dim, device="cpu")
    out, _ = llama.forward(params, cfg, torch.as_tensor(ids), cache, 0,
                           full_logits=True)
    return out.numpy()


def test_awq_end_to_end_matches_jax(models):
    """Each package's own calibration forward and search, on a grid of
    E2E_GRID points."""
    jcfg, cfg, jp, tp = (models[k] for k in ("jcfg", "cfg", "jp", "tp"))
    calib, jacts = models["calib"], models["acts"]
    acts = tawq.collect_calibration_inputs(tp, cfg, calib)
    for k in ("qkv", "wo", "gate_up", "down", "lm_head"):
        for a, b in zip(*((x if k != "lm_head" else [x])
                          for x in (acts[k], jacts[k]))):
            assert a.dtype == np.float32 and a.shape == b.shape
            assert np.abs(a - b).max() <= 2e-2 * np.abs(b).max(), k
    scaled, info = tawq.awq_scale_llama(tp, cfg, calib, group_size=64,
                                        n_grid=E2E_GRID)
    jscaled, jinfo = jawq.awq_scale_llama(jp, jcfg, calib, group_size=64,
                                          n_grid=E2E_GRID)
    lyr = jp.layers
    weights = {"qkv": lyr.wqkv, "wo": lyr.wo, "gate_up": lyr.wgate_up,
               "down": lyr.down}
    for site in tawq.SITES + ("lm_head",):
        for i in range(cfg.num_layers if site != "lm_head" else 1):
            x = jacts[site][i] if site != "lm_head" else jacts[site]
            w = np.asarray(weights[site].weight[i] if site != "lm_head"
                           else jp.lm_head.weight, np.float32)
            s_base = None
            if site == "wo":
                ratio = cfg.num_heads // cfg.num_kv_heads
                mag = np.mean(np.abs(x), axis=0).reshape(-1, ratio,
                                                         cfg.head_dim).mean(1)
                s_base = np.repeat(mag[:, None, :], ratio, 1).reshape(-1)
            _, jalpha, jlosses = jawq.search_scale(x, w, 64, n_grid=E2E_GRID,
                                                   s_base=s_base)
            losses = (info["losses"][site][i] if site != "lm_head"
                      else info["losses"][site])
            alpha = (info["alpha"][site][i] if site != "lm_head"
                     else info["alpha"][site])
            assert jalpha == (jinfo["alpha"][site][i] if site != "lm_head"
                              else jinfo["alpha"][site])
            np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL,
                                       err_msg=f"{site} {i}")
            best, runner_up = np.sort(jlosses)[:2]
            if runner_up - best > 2 * LOSS_RTOL * best:
                assert alpha == jalpha, (site, i, alpha, jalpha)
    ids = np.random.default_rng(7).integers(0, cfg.vocab_size, (1, 12))
    a, b = _logits(tp, cfg, ids)[0], _logits(scaled, cfg, ids)[0]
    tol = 3e-2 * np.abs(a).max()
    assert np.abs(a - b).max() <= tol
    top2 = np.sort(a, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol  # no near-tie to flip
    assert clear.any()
    np.testing.assert_array_equal(np.argmax(a, -1)[clear],
                                  np.argmax(b, -1)[clear])
    assert all(len(v) == cfg.num_layers for k, v in info["alpha"].items()
               if k != "lm_head")


def test_awq_then_quantize_generates(models):
    """awq_scale_llama -> requantize_llama(w4a16) -> a finite forward
    (tests/test_awq.py's smoke) on the port."""
    cfg = models["cfg"]
    calib = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 32))
    scaled, _ = tawq.awq_scale_llama(models["tp"], cfg, calib, 64, n_grid=6)
    q = tcv.requantize_llama(scaled, QuantConfig(scheme="w4a16",
                                                 group_size=64))
    assert np.isfinite(_logits(q, cfg, [[5, 9, 11, 42]])).all()


def test_search_scale_defaults_to_the_card(monkeypatch):
    x, w, _ = _search_inputs("random")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tawq.search_scale(x, w, 128)
