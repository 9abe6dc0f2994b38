"""The port's training path (``tools/train_tiny.py``) against the JAX
package's on the CPU.

Tolerances: the learning-rate schedule equals jitted
``optax.warmup_cosine_decay_schedule`` within 1 f32 ulp at every step
(0 read); the clip equals ``optax.clip_by_global_norm(1.0)`` within
2^-22 relative, two f32 ulps (the global norm's sums run in another
order; 1.96e-7 read); ``train`` from JAX's init on JAX's offsets (2
layers, head_dim 64, batch 2, window 32, 10 steps) gives every step's
loss within 5e-4 relative of JAX's ``train`` and every trained tensor
within 0.1 of its own change, ||w_port - w_jax|| <= 0.1 ||w_jax -
w_init|| (readings in ROADMAP.md, "Tolerances found"), except OPT's
k_proj bias, whose true gradient is zero (softmax is shift-invariant
along the keys): Adam turns both sides' rounding noise into steps of
about lr, so it is held to |w_port - w_jax| <= 2 * (the sum of the step
sizes) element by element;
the checkpoint the port saves loads in JAX's ``load_checkpoint`` and
JAX's forward on it agrees with the port's within 2e-2 of max |logit|.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tinychatengine_tpu.core.config import ModelConfig as JModelConfig
from tinychatengine_tpu.core.config import QuantConfig as JQuantConfig
from tinychatengine_tpu.generation import kv_cache as jkvc
from tinychatengine_tpu.tools import checkpoint as jckpt
from tinychatengine_tpu.tools import train_tiny as jtt
from tinychatengine_tpu_torch.core.config import (MODEL_REGISTRY,
                                                  ModelConfig, QuantConfig)
from tinychatengine_tpu_torch.generation import kv_cache as tkvc
from tinychatengine_tpu_torch.models import llama, opt
from tinychatengine_tpu_torch.tools import checkpoint as tckpt
from tinychatengine_tpu_torch.tools import train_tiny as tt

LLAMA = dict(name="train_llama_tiny", family="llama", num_heads=4,
             num_kv_heads=2, num_layers=2, max_sqlen=1024, embed_dim=256,
             hidden_dim=512, vocab_size=258, rms_norm_eps=1e-5)
OPT = dict(name="train_opt_tiny", family="opt", num_heads=4, num_kv_heads=4,
           num_layers=2, max_sqlen=1024, embed_dim=256, hidden_dim=512,
           vocab_size=258)
BATCH, WINDOW, STEPS, SEED = 2, 32, 10, 0
PEAK_LR = 3e-3
LOSS_RTOL = 5e-4
WEIGHT_SHARE = 0.1


def _ulps(a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("steps", [5, 10, 250, 3000])
def test_lr_schedule_equals_optax(steps):
    """Every count from 0 to past the end, against the schedule jitted as
    optax's update runs it (count 0 is the first update's)."""
    sched = optax.warmup_cosine_decay_schedule(
        0.0, PEAK_LR, warmup_steps=min(100, steps // 10), decay_steps=steps,
        end_value=PEAK_LR * 0.01)
    counts = np.arange(steps + 3, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(sched))(jnp.asarray(counts)))
    got = np.asarray([tt.lr_schedule(int(c), steps, PEAK_LR)
                      for c in counts], np.float32)
    assert _ulps(got, want).max() <= 1
    assert got[0] == 0.0 or steps < 10  # warmup: the first update's lr is 0


@pytest.mark.parametrize("scale", [1e-3, 10.0])
def test_clip_equals_optax(scale):
    """Gradients below (nothing changes) and above the threshold."""
    rng = np.random.default_rng(1)
    grads = [(rng.standard_normal(s) * scale).astype(np.float32)
             for s in ((7, 5), (13,), (3, 4, 2))]
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = tt.clip_by_global_norm(got, 1.0)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)),
                               rtol=1e-6)
    for g, w, g0 in zip(got, want, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2.0 ** -22,
                                   atol=0)
        if scale < 1:
            np.testing.assert_array_equal(g.numpy(), g0)


class _NumpySpy:
    """numpy, but ``asarray`` keeps what it returns: JAX's ``train`` reads
    each chunk's per-step losses through it."""

    def __init__(self):
        self.seen = []

    def __getattr__(self, name):
        return getattr(np, name)

    def asarray(self, a, *args, **kw):
        out = np.asarray(a, *args, **kw)
        self.seen.append(out)
        return out


def _corpus() -> bytes:
    return bytes(np.random.default_rng(2).integers(32, 127, 20000,
                                                   dtype=np.uint8))


def _jax_offsets(n: int) -> list:
    """The offsets JAX's ``train`` draws: PRNGKey(seed + 1), then per step
    split and randint(k1, (batch,), 0, n - window - 1)."""
    key = jax.random.PRNGKey(SEED + 1)
    offs = []
    for _ in range(STEPS):
        key, k1 = jax.random.split(key)
        offs.append(np.asarray(jax.random.randint(k1, (BATCH,), 0,
                                                  n - WINDOW - 1)))
    return offs


@pytest.fixture(scope="module", params=["llama", "opt"])
def trained(request):
    """Both packages' ``train`` from JAX's init on JAX's offsets: (family,
    cfg, the init as flat numpy, the port's tree and losses, JAX's tree
    and losses)."""
    fam = request.param
    d = LLAMA if fam == "llama" else OPT
    jcfg, cfg = JModelConfig(**d), ModelConfig(**d)
    corpus = _corpus()
    jinit = jtt._hooks(fam)[0](jcfg, JQuantConfig(scheme="fp"), seed=SEED)
    flat0 = {k: np.asarray(v) for k, v in jckpt._flatten(jinit)[0].items()}
    model = llama if fam == "llama" else opt
    mp = pytest.MonkeyPatch()
    offs = iter(_jax_offsets(len(corpus)))
    mp.setattr(tt, "draw_offsets",
               lambda gen, b, n, w: torch.from_numpy(next(offs).copy()).long())
    real = tt._hooks

    def hooks(family):
        _, forward, protected = real(family)
        return ((lambda c, q, s, dev: model.params_from_numpy(flat0, c, q,
                                                              device=dev)),
                forward, protected)
    mp.setattr(tt, "_hooks", hooks)
    spy = _NumpySpy()
    mp.setattr(jtt, "np", spy)
    try:
        port_losses = []
        port = tt.train(cfg, corpus, steps=STEPS, batch=BATCH, window=WINDOW,
                        seed=SEED, scan_chunk=10, log=lambda m: None,
                        device="cpu", history=port_losses)
        jax_tree = jtt.train(jcfg, corpus, steps=STEPS, batch=BATCH,
                             window=WINDOW, seed=SEED, scan_chunk=10,
                             log=lambda m: None)
    finally:
        mp.undo()
    jax_losses = next(a for a in spy.seen if a.shape == (STEPS,))
    return fam, cfg, flat0, port, port_losses, jax_tree, jax_losses


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a).astype(np.float32)


def test_train_matches_jax_train(trained):
    """Losses step by step and every trained tensor against JAX's
    ``train`` on the same init and batches; the result is the bf16
    inference tree (RoPE tables f32, untouched)."""
    fam, cfg, flat0, port, port_losses, jax_tree, jax_losses = trained
    np.testing.assert_allclose(port_losses, jax_losses, rtol=LOSS_RTOL)
    assert port_losses[-1] < port_losses[0]
    got = tckpt.flatten(port)
    want = jckpt._flatten(jax_tree)[0]
    assert sorted(got) == sorted(want)
    lrs = [tt.lr_schedule(i, STEPS, PEAK_LR) for i in range(STEPS)]
    for k in want:
        g, w, w0 = _f32(got[k]), _f32(want[k]), _f32(flat0[k])
        if k.startswith("rope_"):
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(g, w0)
            continue
        assert got[k].dtype == torch.bfloat16, k
        if fam == "opt" and k == "layers/k_proj/bias":
            assert np.abs(g - w).max() <= 2 * sum(lrs)
            continue
        share = np.linalg.norm(g - w) / np.linalg.norm(w - w0)
        assert share <= WEIGHT_SHARE, (k, share)


def test_trained_checkpoint_loads_in_jax(trained, tmp_path):
    """The port's trained tree saved as a checkpoint loads in JAX's
    ``load_checkpoint``; JAX's forward on it agrees with the port's."""
    fam, cfg, _, port, *_ = trained
    d = LLAMA if fam == "llama" else OPT
    jcfg = JModelConfig(**d)
    tckpt.save_checkpoint(str(tmp_path), port, cfg, QuantConfig(scheme="fp"),
                          extra_meta={"family": fam, "trained_on": "test",
                                      "steps": STEPS})
    jparams, jq = jckpt.load_checkpoint(str(tmp_path), jcfg)
    assert jq.scheme == "fp"
    ids = np.random.default_rng(3).integers(0, 257, (1, 24))
    jmodel = jtt._hooks(fam)[1]
    jl, _ = jmodel(jparams, jcfg, jnp.asarray(ids),
                   jkvc.init_cache(2, 1, 32, cfg.num_kv_heads, cfg.head_dim),
                   jnp.int32(0), full_logits=True)
    tl, _ = tt._hooks(fam)[1](port, cfg, torch.from_numpy(ids),
                              tkvc.init_cache(2, 1, 32, cfg.num_kv_heads,
                                              cfg.head_dim, device="cpu"),
                              0, full_logits=True)
    jl = np.asarray(jl, np.float32)
    assert np.abs(tl.numpy() - jl).max() <= 2e-2 * np.abs(jl).max()


def test_main_smoke_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``main`` with --device cpu --steps 2 --corpus-mb 1 --skip-eval
    writes JAX's files: the checkpoint with ``family``, ``trained_on`` and
    ``steps``, and ``eval_sample.txt``; no ppl.json."""
    monkeypatch.setitem(MODEL_REGISTRY, LLAMA["name"], ModelConfig(**LLAMA))
    out = tmp_path / "ckpt"
    res = tt.main(["--out", str(out), "--model", LLAMA["name"], "--steps",
                   "2", "--batch", "2", "--window", "64", "--corpus-mb", "1",
                   "--skip-eval", "--device", "cpu"])
    meta = json.loads((out / "meta.json").read_text())
    assert meta["family"] == "llama" and meta["steps"] == 2
    assert meta["trained_on"].startswith("local python source (")
    sample = (out / "eval_sample.txt").read_text(encoding="utf-8")
    assert 0 < len(sample.encode()) <= 128 << 10
    assert not (out / "ppl.json").exists() and res["report"] is None
    assert len(res["losses"]) == 2 and "step 2/2" in capsys.readouterr().out
    params, qcfg = tckpt.load_checkpoint(str(out), device="cpu")
    assert qcfg.scheme == "fp" and params.embed.dtype == torch.bfloat16
    assert tt.build_parser().parse_args([]).device == "cuda"


def test_chip_smoke_train_phase_rehearses_on_cpu(monkeypatch):
    """chip_smoke.py's phase 16 (``train_path``) at a tiny width on the
    CPU, its checks as on the card but for those that need the card or the
    full step count (the kernels' launches in the evaluation, the loss
    falling by half, the fp ppl a tenth of the init's, bench_op against
    phase 3's time): both models through ``train_tiny.main`` with the
    evaluation, no launch while training, the first step, the
    ``train_twin`` steps and every scheme's ppl against the CPU, the
    Engine check, OPT's prefill from input_embeds, bench_op and
    device_trace."""
    import chip_smoke
    for d in (LLAMA, OPT):
        monkeypatch.setitem(MODEL_REGISTRY, d["name"], ModelConfig(**d))
    out = chip_smoke.train_path(
        dev="cpu", models=(LLAMA["name"], OPT["name"]),
        steps={"llama": 3, "opt": 3}, corpus_mb=1, eval_tokens=1024,
        batch=2, window=32, n_predict=8, bench_shape=(256, 256))
    for fam in ("llama", "opt"):
        m = out[fam]
        assert len(m["ppl_card_cpu"]) == (4 if fam == "llama" else 3)
        assert m["first_loss_rel"] == 0.0 and m["ppl_rel"] == 0.0
        assert not any(m["train_counts"]["launches"].values())
        assert m["twin"]["loss_rel"] == 0.0 and m["twin"]["share"] == 0.0
    assert out["llama"]["train_counts"]["plain"]["flash_prefill_plain"]
    assert "flash_prefill_plain" not in out["opt"]["train_counts"]["plain"]
    assert out["opt_embeds_equal"] and out["bench_op"]["bench_op_ms"] > 0
    assert out["engine"] == {"fp": [8] * 4, "w4a8": [8] * 4}
    assert out["decode_trace"]["named"] == {"aten::": True}
