"""Mellum2-12B-A2.5B's architecture in the port at a tiny size, on the CPU:
the sparse-expert layer (``models/moe.py``, the plain versions of
``ops/int4_moe.py``), per-layer windows and RoPE tables with YaRN
(``models/llama.py``, ``ops/ref.py``), held to the benchmark's plain f32
reference (``perfbench/reference/mellum.py``) on seeded int4 weights
(``perfbench/families/mellum.py``). No JAX: the JAX package has no
expert layer.

The tiny configuration keeps the published shape of a period: 4 query
heads on 2 KV heads of width 32 (not E / Hq = 24), E 96, sliding x 3 then
full, window 8, YaRN factor 4 over 16 original positions, 8 experts of
width 64, top 2. Every K is pack-padded to a superblock (group 32)."""

import json
import math
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import spec
from perfbench.reference.common import FULL, INT8, Seq, strict_f32
from perfbench.weights import Weights
from tinychatengine_tpu_torch.core.config import (GenerationConfig,
                                                  QuantConfig, YarnRope,
                                                  get_model_config)
from tinychatengine_tpu_torch.generation import kv_cache as kvc
from tinychatengine_tpu_torch.generation.engine import Engine
from tinychatengine_tpu_torch.models import llama, moe
from tinychatengine_tpu_torch.ops import int4_moe as mo
from tinychatengine_tpu_torch.ops import ref as oref
from tinychatengine_tpu_torch.ops.int4_matmul import int4_matmul_plain
from tinychatengine_tpu_torch.runtime import paged as pg
from tinychatengine_tpu_torch.runtime.serving import ServingEngine

REPO = Path(__file__).resolve().parent.parent
SEED = 2 ** 31 + 23
PROMPT = np.random.default_rng(5).integers(100, 412, 24)
N_PROMPT = 16  # prefill these, then decode the rest one position at a time

# Port against reference: the largest |logit difference| at a position
# over that position's largest |logit|. The port runs bf16 activations, a
# bf16 residual stream and bf16 KV, the reference f32 throughout (the same
# int4 weights): over these 4 layers their difference read 0.009-0.019 on
# five seeds (0.013 on SEED). The reference with every linear's input, K, V
# and the residual at int8 (the benchmark's ``all_lowered`` control) read
# 0.024-0.064 from the port (0.032 on SEED), and must not pass.
LOGIT_TOL = 0.02
# The expert layer alone, the port's against the reference's on the same
# bf16 rows, by the same measure over its output: the port rounds the
# SiLU(gate) * up product and the output to bf16 (two roundings of 2^-9),
# read 0.007-0.011 over layers and seeds; the reference with its expert
# linears (the router's too) at int8 activations per group of 32 read
# 0.021-0.19, and must not pass. At the logits the tiny model's bf16
# attention and residual noise is as large as int8 experts' (0.002-0.004
# at the median position), so their precision is judged where they act.
EXPERT_TOL = 0.015


def _config() -> dict:
    c = json.loads((REPO / "perfbench" / "configs" /
                    "mellum2_12b_a2.5b-w4a16.json").read_text())
    kinds = ["sliding_attention"] * 3 + ["full_attention"]
    c.update(hidden_size=96, num_attention_heads=4, num_key_value_heads=2,
             head_dim=32, num_hidden_layers=4, layer_types=kinds,
             mlp_layer_types=["sparse"] * 4, sliding_window=8,
             num_experts=8, num_experts_per_tok=2, moe_intermediate_size=64,
             vocab_size=512, max_position_embeddings=128,
             intermediate_size=192)
    c["rope_parameters"] = {
        "full_attention": dict(c["rope_parameters"]["full_attention"],
                               rope_theta=10000, factor=4,
                               original_max_position_embeddings=16,
                               attention_factor=1 + 0.1 * math.log(4)),
        "sliding_attention": {"rope_type": "default", "rope_theta": 10000}}
    c["quant"] = dict(c["quant"], group_size=32)
    # the tiny widths need a larger scale for the layers to matter
    c["assumed"] = dict(c["assumed"], weight_std=0.04, router_std=0.2)
    return c


@pytest.fixture(scope="module")
def tiny():
    """(family module, sizes, port config, quant, weights, port params)."""
    fam = spec.family("mellum")
    m = fam.sizes("tiny_mellum", _config())
    w = Weights(m, SEED, "cpu")
    params = fam.build_params(w, 128)
    return fam, m, fam.port_config(m), fam.port_quant(m, "bf16"), w, params


def _reference(w) -> torch.Tensor:
    """The reference's logits at every position of PROMPT [T, V]."""
    strict_f32()
    n = len(PROMPT)
    seq = Seq(ids=PROMPT.copy(), want=np.arange(n),
              row_bits=np.full(n, FULL, np.int64))
    return spec.reference("mellum").logits(w, [seq], "cpu")[0]


def _port_dense(params, cfg) -> torch.Tensor:
    """The port's logits at every position: a prefill of N_PROMPT, then
    one-token decodes through the dense cache."""
    cache = kvc.init_cache(cfg.num_layers, 1, 64, cfg.num_kv_heads,
                           cfg.head_dim, device="cpu")
    ids = torch.as_tensor(PROMPT[None])
    out, cache = llama.forward(params, cfg, ids[:, :N_PROMPT], cache, 0,
                               full_logits=True)
    rows = [out[0]]
    for p in range(N_PROMPT, len(PROMPT)):
        lg, cache = llama.forward(params, cfg, ids[:, p:p + 1], cache, p)
        rows.append(lg)
    return torch.cat(rows).float()


def _port_paged(params, cfg) -> torch.Tensor:
    """The port's logits at every position, each position a paged decode
    step (page 8, the pages shuffled in the pool)."""
    page, n = 8, len(PROMPT)
    cache = pg.init_paged_cache(cfg.num_layers, 8, cfg.num_kv_heads, page,
                                cfg.head_dim, device="cpu")
    table = torch.tensor([[5, 2, 7, 1]], dtype=torch.int32)
    rows = []
    for p in range(n):
        lg, cache = llama.forward(
            params, cfg, torch.as_tensor(PROMPT[None, p:p + 1]), cache,
            torch.tensor([p], dtype=torch.int32), page_table=table)
        rows.append(lg)
    return torch.cat(rows).float()


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest per-position |difference| over the position's max |logit|."""
    return float(((got - want).abs().amax(-1)
                  / want.abs().amax(-1)).max())


@pytest.mark.parametrize("path", ["dense", "paged"])
def test_port_matches_reference(tiny, path):
    """Prefill then decode through the cache (dense), or every position a
    paged decode, against the reference's full forward, on logits."""
    _, _, cfg, _, w, params = tiny
    got = (_port_dense if path == "dense" else _port_paged)(params, cfg)
    assert _err(got, _reference(w)) <= LOGIT_TOL


def test_lowered_reference_fails(tiny):
    """The same comparison against the reference at int8 (every linear's
    input rows, K and V, the residual) fails."""
    _, _, cfg, _, w, params = tiny
    strict_f32()
    n = len(PROMPT)
    low = spec.reference("mellum").logits(w, [Seq(
        ids=PROMPT.copy(), want=np.arange(n),
        row_bits=np.full(n, INT8, np.int64), head_bits=INT8, kv_bits=INT8,
        res_bits=INT8)], "cpu")[0]
    assert _err(_port_dense(params, cfg), low) > LOGIT_TOL


@pytest.mark.parametrize("li", [0, 3])
def test_expert_layer_matches_reference_and_int8_fails(tiny, li):
    """The port's expert layer against the reference's on the same bf16
    rows (a sliding and a full layer); the reference with its expert
    linears at int8 activations fails the same comparison."""
    _, m, cfg, _, w, params = tiny
    strict_f32()
    ref = spec.reference("mellum")
    h = torch.from_numpy(np.random.default_rng(li).standard_normal(
        (64, m.hidden)).astype(np.float32)).to(torch.bfloat16)
    got = moe.forward(params.layers, cfg, h[None], torch.zeros_like(h)[None],
                      li)[0].float()
    full = torch.full((64,), FULL)
    want = ref.experts(w, li, h.float(), full)
    low = ref.experts(w, li, h.float(), torch.full_like(full, INT8))
    assert _err(got, want) <= EXPERT_TOL
    assert _err(got, low) > EXPERT_TOL


def test_window_binds(tiny):
    """Positions past the window of 8 attend to 8 keys in the sliding
    layers: widening every layer to full attention moves those
    positions' logits past the tolerance and leaves the first 8 as they
    were."""
    import dataclasses
    _, _, cfg, _, _, params = tiny
    full = dataclasses.replace(cfg, layer_windows=(None,) * 4)
    a, b = _port_dense(params, cfg), _port_dense(params, full)
    assert torch.equal(a[:8], b[:8])
    assert _err(a[8:], b[8:]) > LOGIT_TOL


def _hf_yarn_inv_freq(d, theta, factor, orig, fast, slow):
    """Hugging Face's ``_compute_yarn_parameters`` written out in numpy."""
    def corr(rot):
        return (d * math.log(orig / (rot * 2 * math.pi))) \
            / (2 * math.log(theta))
    low = max(math.floor(corr(fast)), 0)
    high = min(math.ceil(corr(slow)), d - 1)
    if low == high:
        high += 0.001
    pos = theta ** (np.arange(0, d, 2, dtype=np.float32) / d)
    ramp = np.clip((np.arange(d // 2, dtype=np.float32) - low)
                   / (high - low), 0, 1)
    extra_share = 1 - ramp
    return (1 / (factor * pos)) * (1 - extra_share) + (1 / pos) * extra_share


@pytest.mark.parametrize("d,theta,factor,orig", [
    (32, 10000.0, 4.0, 16), (128, 500000.0, 16.0, 8192)])
def test_yarn_table_follows_the_equations(d, theta, factor, orig):
    """The port's YaRN table: cos / sin of position x the blended inverse
    frequencies, times the attention factor; the reference's frequencies
    alike; Mellum's own published parameters included."""
    af = 0.1 * math.log(factor) + 1
    yarn = YarnRope(factor, orig, 32.0, 1.0, af)
    want = _hf_yarn_inv_freq(d, theta, factor, orig, 32.0, 1.0)
    got = oref.yarn_inv_freq(d, theta, yarn).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-7)
    cos, sin = oref.make_yarn_cache(d, 40, theta, yarn)
    ang = np.arange(40, dtype=np.float32)[:, None] * want[None]
    ang = np.concatenate([ang, ang], -1)
    # cos / sin of f32 angles up to 40 rad: an ulp of the angle (3.8e-6)
    # times the factor
    np.testing.assert_allclose(cos.numpy(), np.cos(ang) * af, atol=1e-5)
    np.testing.assert_allclose(sin.numpy(), np.sin(ang) * af, atol=1e-5)
    fam = spec.family("mellum")
    m = fam.Mellum(name="t", family="mellum", layers=1, hidden=d, inter=d,
                   heads=1, kv_heads=1, vocab=8, positions=8, eps=1e-6,
                   head_width=d, rope_theta=theta,
                   yarn=(factor, orig, 32.0, 1.0, af))
    ref = spec.reference("mellum")
    np.testing.assert_allclose(ref.inv_freq(m, "yarn", "cpu").numpy(), want,
                               rtol=2e-7)
    # the high frequencies kept, the low ones divided by the factor
    assert got[0] == pytest.approx(1.0)
    assert got[-1] == pytest.approx(want[-1])
    assert got[-1] < 1 / theta ** ((d - 2) / d) / factor * 1.0001


def test_mellum_registry_entry():
    c = get_model_config("mellum2_12b_a2.5b")
    assert (c.head_dim, c.embed_dim, c.num_heads, c.num_experts,
            c.experts_per_tok, c.expert_dim) == (128, 2304, 32, 64, 8, 896)
    assert [c.window(i) for i in range(4)] == [1024, 1024, 1024, None]
    assert [c.rope_kind(i) for i in range(4)] == ["default"] * 3 + ["yarn"]
    assert c.yarn.factor == 16 and c.yarn.original_max_position_embeddings \
        == 8192
    # the defaults leave every other model as it was
    l3 = get_model_config("llama3_8b")
    assert l3.head_dim == 128 and l3.window(0) is None \
        and l3.rope_kind(5) == "default" and l3.num_experts == 0


def _layer_by_token(lyr, cfg, h, x, li):
    """The expert layer token by token, each chosen expert's int4 matmuls
    on its own (no sort, no grouping)."""
    ne, k = cfg.num_experts, cfg.experts_per_tok
    out = []
    for t in range(h.shape[0]):
        ht = h[t:t + 1]
        logits = ht.float() @ lyr.router[li].float()
        p = torch.softmax(logits, -1)[0]
        wts, ids = torch.topk(p, k)
        wts = wts / wts.sum()
        acc = torch.zeros(h.shape[1])
        for wt, e in zip(wts, ids.tolist()):
            gu = int4_matmul_plain(ht, lyr.experts_gate_up.packed,
                                   lyr.experts_gate_up.scales,
                                   lyr.experts_gate_up.group_size,
                                   layer_idx=li * ne + e)
            f = gu.shape[-1] // 2
            g, u = gu[:, :f].float(), gu[:, f:].float()
            act = (g / (1 + torch.exp(-g)) * u).to(torch.bfloat16)
            dn = int4_matmul_plain(act, lyr.experts_down.packed,
                                   lyr.experts_down.scales,
                                   lyr.experts_down.group_size,
                                   layer_idx=li * ne + e)
            acc = acc + wt * dn[0].float()
        out.append((x[t].float() + acc.to(torch.bfloat16).float())
                   .to(torch.bfloat16))
    return torch.stack(out)


def test_expert_layer_with_an_empty_expert(tiny):
    """The sorted, grouped layer equals the layer computed token by token,
    on rows whose routing leaves experts with no rows (their offsets
    equal, nothing computed), and counts what it read."""
    _, _, cfg, _, _, params = tiny
    lyr = params.layers
    h = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (5, cfg.embed_dim)).astype(np.float32)).to(torch.bfloat16)
    x = (h.float() * 0.1).to(torch.bfloat16)
    logits = h.float() @ lyr.router[1].float()
    ids, _ = mo.route(logits, cfg.experts_per_tok)
    counts = torch.zeros(2, dtype=torch.int64)
    _, _, offsets, _ = mo.plan(ids, cfg.num_experts, 16, counts)
    used = set(ids.flatten().tolist())
    assert len(used) < cfg.num_experts
    for e in set(range(cfg.num_experts)) - used:
        assert offsets[e] == offsets[e + 1]
    assert counts.tolist() == [len(used), 5 * cfg.experts_per_tok]
    before = moe.stats("cpu").clone()
    got = moe.forward(lyr, cfg, h[None], x[None], 1)[0]
    assert torch.equal(got, _layer_by_token(lyr, cfg, h, x, 1))
    assert (moe.stats("cpu") - before)[2:].tolist() == counts.tolist()


def test_serving_tokens_equal_engine_tokens(tiny):
    """Greedy tokens through ServingEngine (dense and paged, beside
    another request) equal ``Engine.generate_device``'s; the expert counts
    ride along with the token fetches."""
    from tinychatengine_tpu_torch.utils import tracing
    _, _, cfg, qcfg, _, params = tiny
    g = GenerationConfig(temp=0.0, repeat_penalty=1.0, n_predict=16)
    want = Engine(params, cfg, qcfg, batch=1, max_len=64, device="cpu"
                  ).generate_device(PROMPT[None, :12], g, n_tokens=16)
    for paged in (False, True):
        t0 = time.perf_counter_ns()
        srv = ServingEngine(params, cfg, qcfg, slots=3, max_len=64, gcfg=g,
                            paged=paged, page_size=8, admission_chunk=8,
                            tick_batch=4, device="cpu")
        r = srv.submit(PROMPT[:12], n_predict=16)
        srv.submit(PROMPT[3:9], n_predict=9)
        srv.run()
        assert r.output_ids == want[0].tolist()
        spans = tracing.snapshot(t0)
        eng = [s for s in spans if s.name == "serve.engine"]
        assert eng[-1].b == cfg.num_layers * cfg.num_experts
        dec = [s for s in spans if s.name == "serve.experts"]
        assert dec and all(0 < s.a <= s.b for s in dec)
        assert any(s.name == "serve.experts.prefill" for s in spans)


def test_parallel_paths_refuse_an_expert_model(tiny):
    """Tensor, sequence and pipeline parallelism raise a clear error for a
    sparse-expert model (its experts are not sharded)."""
    from tinychatengine_tpu_torch.parallel import pp, sp, tp
    _, _, cfg, _, _, params = tiny
    ids = torch.as_tensor(PROMPT[None, :4])
    cache = kvc.init_cache(cfg.num_layers, 1, 64, cfg.num_kv_heads,
                           cfg.head_dim, device="cpu")
    with pytest.raises(ValueError, match="sparse-expert"):
        llama.forward(params, cfg, ids, cache, 0, tp_axis=object())
    with pytest.raises(ValueError, match="tensor-parallel"):
        tp.TPForward.__call__(object.__new__(tp.TPForward), params, cfg,
                              ids, cache, 0)
    with pytest.raises(ValueError, match="pipeline-parallel"):
        pp.PPForward.__call__(object.__new__(pp.PPForward), params, cfg,
                              ids, cache, 0)

    class Mesh:
        shape = {"seq": 2, "model": 1}

    with pytest.raises(ValueError, match="sequence-parallel"):
        sp.make_sp_prefill(Mesh(), device="cpu")(params, cfg, ids, cache)


def test_tick_counts_every_layer(tiny):
    """One decode forward of B rows adds, per layer, the experts given a
    row and B x k pairs to the one-token counters."""
    _, _, cfg, _, _, params = tiny
    cache = kvc.init_cache(cfg.num_layers, 3, 64, cfg.num_kv_heads,
                           cfg.head_dim, device="cpu")
    before = moe.stats("cpu").clone()
    llama.forward(params, cfg, torch.as_tensor(PROMPT[:3, None]), cache,
                  torch.tensor([0, 4, 9], dtype=torch.int32))
    d = (moe.stats("cpu") - before).tolist()
    assert d[1] == cfg.num_layers * 3 * cfg.experts_per_tok and d[2:] == [0, 0]
    assert cfg.num_layers * cfg.experts_per_tok <= d[0] \
        <= cfg.num_layers * min(cfg.num_experts, 3 * cfg.experts_per_tok)


def test_prompt_above_the_largest_bucket_is_served(tiny):
    """A prompt longer than the largest prefill bucket (8192) is admitted
    in chunks and spliced whole into its slot: the server's greedy tokens
    equal a chunked prefill and decode through ``llama.forward``."""
    fam, m, cfg, qcfg, w, _ = tiny
    params = fam.build_params(w, 8320)
    prompt = np.random.default_rng(9).integers(100, 412, 8200)
    g = GenerationConfig(temp=0.0, repeat_penalty=1.0, n_predict=3)
    srv = ServingEngine(params, cfg, qcfg, slots=2, max_len=8320, gcfg=g,
                        admission_chunk=2048, device="cpu")
    r = srv.submit(prompt, n_predict=3)
    srv.run()
    cache = kvc.init_cache(cfg.num_layers, 1, 8320, cfg.num_kv_heads,
                           cfg.head_dim, device="cpu")
    ids = torch.as_tensor(prompt[None])
    for a in range(0, len(prompt), 2048):
        lg, cache = llama.forward(params, cfg, ids[:, a:a + 2048], cache, a)
    want = [int(lg.argmax(-1))]
    for p in range(len(prompt), len(prompt) + 2):
        lg, cache = llama.forward(params, cfg, torch.tensor([[want[-1]]]),
                                  cache, p)
        want.append(int(lg.argmax(-1)))
    assert r.output_ids == want


def test_chip_smoke_mellum_tick_rehearsal():
    """chip_smoke.py's phase 3e served tick (``mellum_tick``) on the CPU at
    a tiny Mellum-shaped width (head_dim 128 != E / Hq, a window and a
    YaRN layer, 8 experts top-2): the counted step ran ticks, and each
    routed every slot's row k pairs in every layer."""
    import chip_smoke
    from tinychatengine_tpu_torch.core.config import ModelConfig
    cfg = ModelConfig(name="tiny_mellum_tick", family="llama", num_heads=2,
                      num_kv_heads=1, num_layers=2, max_sqlen=1024,
                      embed_dim=256, hidden_dim=512, vocab_size=512,
                      head_dim=128, layer_windows=(16, None),
                      layer_rope=("default", "yarn"),
                      yarn=YarnRope(4.0, 64, 32.0, 1.0, 1.14), num_experts=8,
                      experts_per_tok=2, expert_dim=256)
    out = chip_smoke.mellum_tick(cfg, dev="cpu", slots=4, n_predict=24,
                                 max_len=512)
    assert out["ticks"] >= 1
    assert out["expert_pairs"] == 2 * 4 * 2 * out["ticks"]
    assert out["launches"]["int4_moe"] == 0  # the plain versions ran
