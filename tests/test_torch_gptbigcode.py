"""The port's GPTBigCode (StarCoder, multi-query attention) against the JAX
package on the CPU: the forward and its KV cache (fp and W4A16, unfused and
through the fused decode branch), rows at different positions, the fused
shape gate, checkpoints written by JAX, the Engine and ServingEngine (dense
and paged). Inputs are made with numpy from a seed; the JAX parameters reach
the port as numpy (the checkpoint format's tree-path keys) through
``gptbigcode.params_from_numpy``."""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tinychatengine_tpu.core.config import GenerationConfig as JGen
from tinychatengine_tpu.core.config import ModelConfig as JModelConfig
from tinychatengine_tpu.core.config import QuantConfig as JQuantConfig
from tinychatengine_tpu.generation import kv_cache as jkvc
from tinychatengine_tpu.generation.engine import Engine as JEngine
from tinychatengine_tpu.models import gptbigcode as jgpt
from tinychatengine_tpu.ops import int4_matmul as jim
from tinychatengine_tpu.runtime.serving import ServingEngine as JServingEngine
from tinychatengine_tpu.tools import checkpoint as jckpt
from tinychatengine_tpu_torch.core.config import (GenerationConfig,
                                                  ModelConfig, QuantConfig)
from tinychatengine_tpu_torch.generation import kv_cache as tkvc
from tinychatengine_tpu_torch.generation.engine import Engine
from tinychatengine_tpu_torch.models import gptbigcode
from tinychatengine_tpu_torch.ops import int4_matmul as tim
from tinychatengine_tpu_torch.ops.linear import DenseLinear, Int4Linear
from tinychatengine_tpu_torch.runtime.serving import ServingEngine
from tinychatengine_tpu_torch.tools.checkpoint import load_checkpoint

# tests/test_gptbigcode.py's config (fp) and tests/test_fused_decode.py's
# StarCoder config, whose every int4 linear passes the fused gate (W4A16)
TINY = dict(name="tiny_starcoder", family="gptbigcode", num_heads=4,
            num_kv_heads=1, num_layers=2, max_sqlen=32, embed_dim=128,
            hidden_dim=512, vocab_size=300)
FUSABLE = dict(name="tiny_sc_fusable", family="gptbigcode", num_heads=8,
               num_kv_heads=1, num_layers=2, max_sqlen=64, embed_dim=1024,
               hidden_dim=1024, vocab_size=256)
NARROW = dict(TINY, name="tiny_sc_narrow", embed_dim=256)
# tests/test_serving.py's GPTBigCode serving config and prompts
SERVE = dict(TINY, name="tiny_bigcode", max_sqlen=64, hidden_dim=256)
PROMPTS = [np.array([5, 9, 11]), np.array([7, 3]),
           np.array([100, 101, 102, 103, 104, 105]), np.array([42]),
           np.array([1, 2, 3, 4])]


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


def _flat(jparams) -> dict:
    return jckpt._flatten(jparams)[0]


def _bf16(a) -> np.ndarray:
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _models(scheme, seed=0, base=None):
    """(JAX cfg, port cfg, JAX params, the same params in the port). The
    LayerNorm weights and biases are random (init's ones and zeros would
    hide a missing multiply or add in the fused prologue)."""
    d = base or (FUSABLE if scheme != "fp" else TINY)
    jcfg, cfg = JModelConfig(**d), ModelConfig(**d)
    jq = None if scheme == "fp" else JQuantConfig(scheme=scheme)
    jp = jgpt.init_random_params(jcfg, seed=seed, qcfg=jq)
    rng = np.random.default_rng(seed + 100)
    nl, e = d["num_layers"], d["embed_dim"]

    def norm(shape, w):
        a = rng.standard_normal(shape) * (0.3 if w else 0.2) + (1.0 if w
                                                                else 0.0)
        return jnp.asarray(_bf16(a))
    jp = dataclasses.replace(
        jp, layers=dataclasses.replace(
            jp.layers, ln1_w=norm((nl, e), True), ln1_b=norm((nl, e), False),
            ln2_w=norm((nl, e), True), ln2_b=norm((nl, e), False)),
        lnf_w=norm((e,), True), lnf_b=norm((e,), False))
    tp = gptbigcode.params_from_numpy(_flat(jp), cfg,
                                      QuantConfig(scheme=scheme), device="cpu")
    return jcfg, cfg, jp, tp


@pytest.mark.parametrize("scheme", ["fp", "w4a16"])
def test_input_embeds_match_jax_and_the_ids(scheme):
    """``input_embeds`` (position-included, cast to bf16) in place of
    ``wte[ids] + wpe[positions]``: those rows equal the ids' forward bit
    for bit, logits and cache; embeds of other values against JAX's
    forward within 2e-2."""
    jcfg, cfg, jp, tp = _models(scheme, base=NARROW)
    ids = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (1, 9)))
    rows = tp.wte[ids] + tp.wpe[torch.arange(9)]
    want, wc = gptbigcode.forward(tp, cfg, ids, _caches(cfg)[1], 0,
                                  full_logits=True)
    got, gc = gptbigcode.forward(tp, cfg, ids, _caches(cfg)[1], 0,
                                 full_logits=True, input_embeds=rows)
    assert torch.equal(got, want) and torch.equal(gc.k, wc.k)
    emb = np.random.default_rng(8).standard_normal(
        (1, 9, cfg.embed_dim)).astype(np.float32)
    jc, tc = _caches(cfg)
    jl, _ = jgpt.forward(jp, jcfg, jnp.asarray(ids.numpy()), jc,
                         jnp.int32(0), full_logits=True,
                         input_embeds=jnp.asarray(emb))
    tl, _ = gptbigcode.forward(tp, cfg, ids, tc, 0, full_logits=True,
                               input_embeds=torch.from_numpy(emb))
    jl = np.asarray(jl, np.float32)
    np.testing.assert_allclose(tl.numpy(), jl, atol=2e-2, rtol=2e-2)


def _count_fused(monkeypatch):
    calls = []
    real = tim.int4_matmul_fused

    def counted(*a, **kw):
        calls.append(kw.get("layer_idx"))
        return real(*a, **kw)
    monkeypatch.setattr(tim, "int4_matmul_fused", counted)
    return calls


def _caches(cfg, b=1):
    shape = (cfg.num_layers, b, cfg.max_sqlen, 1, cfg.head_dim)
    return jkvc.init_cache(*shape), tkvc.init_cache(*shape, device="cpu")


# fp and unfused W4A16 differ from JAX in attention's summation order and
# the bf16 cache; the fused branch adds the kernel's f32-scale products
@pytest.mark.parametrize("scheme,fused", [("fp", False), ("w4a16", False),
                                          ("w4a16", True)])
def test_forward_prefill_decode_and_cache_match_jax(scheme, fused,
                                                    monkeypatch):
    """A 12-token prompt right-padded to 16 (bucket padding), then three
    greedy decode steps: logits and the K/V cache against JAX's forward
    (fused: JAX's fused branch in interpret mode, 4 fused calls per layer
    and one for the head, per step)."""
    if fused:
        monkeypatch.setattr(jim, "FUSED_DECODE", True)
        monkeypatch.setattr(jim, "FUSED_FORCE", True)
        monkeypatch.setattr(tim, "FUSED_DECODE", True)
    jcfg, cfg, jp, tp = _models(scheme)
    calls = _count_fused(monkeypatch)
    jc, tc = _caches(cfg)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 16))
    jl, jc = jgpt.forward(jp, jcfg, jnp.asarray(ids), jc, jnp.int32(0),
                          true_len=jnp.int32(12))
    tl, tc = gptbigcode.forward(tp, cfg, torch.from_numpy(ids), tc, 0,
                                true_len=12)
    assert tc.length == 12 and tl.shape == (1, cfg.vocab_size)
    assert calls == []  # a prefill never fuses
    np.testing.assert_allclose(tl.numpy(), _f32(jl), atol=2e-2, rtol=2e-2)
    for step in range(3):
        tok = int(np.argmax(_f32(jl)[0]))
        jl, jc = jgpt.forward(jp, jcfg, jnp.asarray([[tok]]), jc,
                              jnp.int32(12 + step))
        tl, tc = gptbigcode.forward(tp, cfg, torch.tensor([[tok]]), tc,
                                    12 + step)
        np.testing.assert_allclose(tl.numpy(), _f32(jl), atol=2e-2,
                                   rtol=2e-2)
    assert calls == ([0, 0, 0, 0, 1, 1, 1, 1, None] * 3 if fused else [])
    assert tc.k.shape[2] == 1  # one KV head
    for got, want in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_allclose(_f32(got)[:, :, :, :15],
                                   _f32(want)[:, :, :, :15], atol=2e-2,
                                   rtol=2e-2)


def test_fused_decode_matches_unfused_and_rows_at_positions(force_fused):
    """B = 2 fused decode at positions 3 and 9 against JAX's fused step and
    against each row's own B = 1 step; and the fused step against the
    port's unfused step (they differ by the fused kernel's f32-scale
    products against the unfused path's bf16 weights)."""
    jcfg, cfg, jp, tp = _models("w4a16", seed=1)
    toks = np.array([[11], [222]])
    starts = np.array([3, 9], np.int32)
    jc, tc = _caches(cfg, 2)
    jl, _ = jgpt.forward(jp, jcfg, jnp.asarray(toks), jc, jnp.asarray(starts))
    tl, _ = gptbigcode.forward(tp, cfg, torch.from_numpy(toks), tc,
                               torch.from_numpy(starts))
    np.testing.assert_allclose(tl.numpy(), _f32(jl), atol=2e-2, rtol=2e-2)
    for r in range(2):
        one, _ = gptbigcode.forward(tp, cfg, torch.from_numpy(toks[r:r + 1]),
                                    _caches(cfg)[1],
                                    torch.from_numpy(starts[r:r + 1]))
        assert torch.allclose(one, tl[r:r + 1], rtol=1e-3, atol=1e-3), r
    tim.FUSED_DECODE = False
    ul, _ = gptbigcode.forward(tp, cfg, torch.from_numpy(toks), _caches(cfg, 2)[1],
                               torch.from_numpy(starts))
    rel = float((tl - ul).abs().max() / ul.abs().max())
    assert 0.0 < rel < 2e-2, rel


def test_fused_paged_decode_matches_jax(force_fused):
    """The paged (serving) decode step through the fused branch: a 6-token
    prefix in page 3 (page size 16), one decode step, against JAX's paged
    step; the logits and the K written at offset 6."""
    from tinychatengine_tpu.runtime import paged as jpaged
    from tinychatengine_tpu_torch.runtime import paged as tpaged
    jcfg, cfg, jp, tp = _models("w4a16", seed=2)
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 6))
    jc, _ = _caches(cfg)
    _, jc = jgpt.forward(jp, jcfg, jnp.asarray(ids), jc, jnp.int32(0))
    jpc = jpaged.init_paged_cache(2, n_pages=8, num_kv_heads=1, page_size=16,
                                  head_dim=cfg.head_dim)
    jpc = jpaged.insert_prefix(jpc, jc.k[:, 0, :, :16], jc.v[:, 0, :, :16],
                               jnp.asarray([3], jnp.int32))
    tpc = tpaged.paged_cache_from_numpy(np.asarray(jpc.k), np.asarray(jpc.v),
                                        device="cpu")
    table = np.array([[3, 5]], np.int32)
    lengths = np.array([6], np.int32)
    jl, jpc = jgpt.forward(jp, jcfg, jnp.asarray([[9]]), jpc,
                           jnp.asarray(lengths), page_table=jnp.asarray(table))
    tl, tpc = gptbigcode.forward(tp, cfg, torch.tensor([[9]]), tpc,
                                 torch.from_numpy(lengths),
                                 page_table=torch.from_numpy(table))
    np.testing.assert_allclose(tl.numpy(), _f32(jl), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(_f32(tpc.k)[:, 3, :, 6], _f32(jpc.k)[:, 3, :, 6],
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("case", ["narrow_embed", "w4a8", "fp"])
def test_fused_gate_falls_back_exactly(force_fused, monkeypatch, case):
    """What the gate refuses takes the unfused path: the logits equal the
    switch-off step bit for bit and no fused call is made. A 256-wide
    embed has K/G = 2 (JAX refuses it too); W4A8 and fp are not W4A16
    linears."""
    base = NARROW if case == "narrow_embed" else FUSABLE
    scheme = case if case in ("w4a8", "fp") else "w4a16"
    cfg = ModelConfig(**base)
    tp = gptbigcode.init_random_params(cfg, seed=3,
                                       qcfg=QuantConfig(scheme=scheme),
                                       device="cpu")
    assert gptbigcode.fused_group_size(tp.layers, 1) == 0
    calls = _count_fused(monkeypatch)

    def step():
        return gptbigcode.forward(tp, cfg, torch.tensor([[5]]),
                                  _caches(cfg)[1], 0)[0]
    on = step()
    tim.FUSED_DECODE = False
    assert torch.equal(on, step()) and calls == []
    if case == "narrow_embed":  # and JAX falls back the same way
        jcfg, cfg, jp, tp = _models("w4a16", seed=3, base=NARROW)
        tim.FUSED_DECODE = True
        jl, _ = jgpt.forward(jp, jcfg, jnp.asarray([[5]]), _caches(cfg)[0],
                             jnp.int32(0))
        np.testing.assert_allclose(step().numpy(), _f32(jl), atol=2e-2,
                                   rtol=2e-2)
        assert calls == []


def test_init_random_params_match_jax():
    """fp: every leaf drawn in the JAX package's numpy order, bit for bit;
    W4A16 (drawn differently, see the docstring) and fast=True: the JAX
    tree's structure, shapes and dtypes."""
    jcfg, cfg = JModelConfig(**TINY), ModelConfig(**TINY)
    want = _flat(jgpt.init_random_params(jcfg, seed=5))
    got = gptbigcode.init_random_params(cfg, seed=5, device="cpu")
    flat = _flat_port(got)
    assert set(flat) == set(want)
    for key, w in want.items():
        np.testing.assert_array_equal(_f32(flat[key]), _f32(w), err_msg=key)
    assert isinstance(got.lm_head, DenseLinear)
    jcfg, cfg = JModelConfig(**FUSABLE), ModelConfig(**FUSABLE)
    want = _flat(jgpt.init_random_params(jcfg, seed=5,
                                         qcfg=JQuantConfig(scheme="w4a16")))
    for fast in (False, True):
        got = gptbigcode.init_random_params(
            cfg, seed=5, qcfg=QuantConfig(scheme="w4a16"), fast=fast,
            device="cpu")
        flat = _flat_port(got)
        assert set(flat) == set(want), fast
        for key, w in want.items():
            assert tuple(flat[key].shape) == w.shape, (key, fast)
            if not fast:  # fast=True keeps qcfg's bf16 scales
                assert _f32(flat[key]).dtype == _f32(w).dtype
        assert isinstance(got.lm_head, Int4Linear) and got.lm_head.bias is None
        assert gptbigcode.fused_group_size(got.layers, 1) == 0  # switch off
        if fast:  # codes centered on the zero point 8: nibbles in 1..15
            for nib in (got.layers.fc_out.packed & 15,
                        got.layers.fc_out.packed >> 4):
                assert int(nib.min()) == 1 and int(nib.max()) == 15
                assert abs(float(nib.float().mean()) - 8.0) < 0.05


def _flat_port(p) -> dict:
    out = {}

    def walk(obj, prefix):
        if isinstance(obj, torch.Tensor):
            out[prefix] = obj
        elif obj is not None:
            for name, val in vars(obj).items():
                walk(val, f"{prefix}/{name}" if prefix else name)
    walk(p, "")
    return out


@pytest.mark.parametrize("scheme", ["fp", "w4a16"])
def test_checkpoint_written_by_jax_loads(tmp_path, scheme):
    jcfg, cfg, jp, _ = _models(scheme, seed=6)
    jq = JQuantConfig(scheme=scheme)
    jckpt.save_checkpoint(str(tmp_path / "c"), jp, jcfg, jq,
                          extra_meta={"family": "gptbigcode"})
    tp, qcfg = load_checkpoint(str(tmp_path / "c"), cfg, device="cpu")
    assert qcfg.scheme == scheme
    assert isinstance(tp, gptbigcode.GPTBigCodeParams)
    ids = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 8))
    jc, tc = _caches(cfg)
    jl, _ = jgpt.forward(jp, jcfg, jnp.asarray(ids), jc, jnp.int32(0))
    tl, _ = gptbigcode.forward(tp, cfg, torch.from_numpy(ids), tc, 0)
    np.testing.assert_allclose(tl.numpy(), _f32(jl), atol=2e-2, rtol=2e-2)


def _greedy(n, penalty=1.0, last_n=1):
    return (GenerationConfig(temp=0.0, n_predict=n, repeat_penalty=penalty,
                             repeat_last_n=last_n),
            JGen(temp=0.0, n_predict=n, repeat_penalty=penalty,
                 repeat_last_n=last_n))


@pytest.mark.parametrize("scheme", ["fp", "w4a16_fused"])
def test_engine_greedy_matches_jax(scheme, monkeypatch):
    """Greedy tokens of the port's Engine (``generate`` and
    ``generate_device``) equal the JAX Engine's, token for token; W4A16
    with fused decode on both sides."""
    if scheme == "w4a16_fused":
        monkeypatch.setattr(jim, "FUSED_DECODE", True)
        monkeypatch.setattr(jim, "FUSED_FORCE", True)
        monkeypatch.setattr(tim, "FUSED_DECODE", True)
    q = scheme.split("_")[0]
    jcfg, cfg, jp, tp = _models(q, seed=7)
    g, jg = _greedy(8)
    prompt = np.array([[5, 9, 11, 40, 2]])
    want = JEngine(jp, jcfg, JQuantConfig(scheme=q)).generate(
        prompt, jg).tokens[0]
    eng = Engine(tp, cfg, QuantConfig(scheme=q), device="cpu")
    assert eng.generate(prompt, g).tokens[0] == list(want)
    assert eng.generate_device(prompt, g)[0].tolist() == list(want)


def test_serving_dense_and_paged_match_jax():
    """Twins of the JAX package's test_serving_gptbigcode_matches_engine
    and test_paged_gptbigcode_matches_dense: the port's ServingEngine,
    dense (no burst) and paged (page growth, bursts of 6), equals JAX's
    dense server token for token; the first three prompts at the engine's
    greedy config equal JAX's Engine. Admissions stay single (batched
    admission is llama's only)."""
    jcfg, cfg, jp, tp = _models("fp", seed=0, base=SERVE)
    g, jg = _greedy(8)
    jeng = JEngine(jp, jcfg, JQuantConfig(scheme="fp"), batch=1,
                   max_len=cfg.max_sqlen, forward_fn=jgpt.forward)
    want = [list(jeng.generate(p[None], jg).tokens[0]) for p in PROMPTS[:3]]
    srv = ServingEngine(tp, cfg, QuantConfig(scheme="fp"), slots=2, gcfg=g,
                        forward_fn=gptbigcode.forward, device="cpu")
    assert not srv._batch_admit
    reqs = [srv.submit(p, n_predict=8) for p in PROMPTS[:3]]
    srv.run()
    assert [r.output_ids for r in reqs] == want

    g, jg = _greedy(18, 1.1, 8)
    jsrv = JServingEngine(jp, jcfg, JQuantConfig(scheme="fp"), slots=2,
                          gcfg=jg, tick_batch=1, forward_fn=jgpt.forward)
    jreqs = [jsrv.submit(p) for p in PROMPTS]
    jsrv.run()
    for paged, tick_batch in ((False, 1), (True, 6)):
        srv = ServingEngine(tp, cfg, QuantConfig(scheme="fp"), slots=2,
                            gcfg=g, tick_batch=tick_batch, paged=paged,
                            page_size=16, forward_fn=gptbigcode.forward,
                            device="cpu")
        reqs = [srv.submit(p) for p in PROMPTS]
        srv.run()
        assert [r.output_ids for r in reqs] == [r.output_ids for r in jreqs]
    with pytest.raises(ValueError):  # GPTBigCode through llama's forward
        ServingEngine(tp, cfg, QuantConfig(scheme="fp"), device="cpu")


def test_fused_serving_dense_and_paged_match_engine(force_fused, monkeypatch):
    """W4A16 with fused decode through ServingEngine: each decode tick runs
    the fused branch over every slot (M = 2 rows), dense and paged, with
    the same greedy tokens as the fused Engine."""
    _, cfg, _, tp = _models("w4a16", seed=8)
    calls = _count_fused(monkeypatch)
    g, _ = _greedy(6)
    eng = Engine(tp, cfg, QuantConfig(scheme="w4a16"), device="cpu")
    want = [eng.generate(p[None], g).tokens[0] for p in PROMPTS[:3]]
    # one decode forward per generated token (the JAX loop's order), each
    # with 4 fused calls per layer and one for the head
    assert len(calls) == 3 * 6 * 9
    for paged in (False, True):
        srv = ServingEngine(tp, cfg, QuantConfig(scheme="w4a16"), slots=2,
                            gcfg=g, tick_batch=4, paged=paged, page_size=16,
                            forward_fn=gptbigcode.forward, device="cpu")
        reqs = [srv.submit(p) for p in PROMPTS[:3]]
        srv.run()
        assert [r.output_ids for r in reqs] == want, paged


def test_chip_smoke_fused_phases_rehearse_on_cpu():
    """chip_smoke.py's StarCoder phases (10 and 11) on the CPU at a fusable
    2-layer width (the card runs starcoder_15.5b): the unfused and fused
    Engine runs, the first-step agreement, the 2-layer cuts, serving dense
    and paged with the fused decode; then phase 6c (bytellama_5m at group
    32, fused against unfused). The CPU runs the plain versions, so no
    launch is counted."""
    import chip_smoke
    cfg = ModelConfig(**dict(FUSABLE, max_sqlen=512))
    out = chip_smoke.fused_ab(cfg, dev="cpu", long_len=256, n_predict=8)
    assert 0.0 < out["first_step"]["rel_diff"] <= chip_smoke.FUSED_STEP_TOL
    for mode in ("unfused", "fused"):
        launches, per_step, metrics = out[mode]
        assert not any(launches.values()) and not any(per_step.values())
        assert metrics["decode_tok_s"] > 0 and metrics["cut_err"] == 0.0
    serving = chip_smoke.serving_path(cfg, dev="cpu", n_requests=4,
                                      n_predict=6, max_len=512, fused=True)
    assert serving["dense"]["tokens"] == serving["paged"]["tokens"] == 24
    assert serving["greedy_dense_eq_paged"] == [2, 2]
    assert not tim.FUSED_DECODE  # each phase restores the switch
    real = chip_smoke.fused_real_weights(dev="cpu")
    assert min(real["agree"]) >= 16
