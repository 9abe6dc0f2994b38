"""The port's sequence-parallel admission, PP-decode serving and the
golden transcripts through the multi-device paths (twins of
``tests/test_sp_serving.py`` and of ``tests/test_accuracy.py``'s
``test_golden_transcript_through_sp_and_pp``). Greedy tokens are held
token for token: to the committed golden (the JAX single-device
transcript, which JAX's SP / TP / PP paths reproduce in its own tests) or
to the JAX engines' tokens, and ``sp_stats`` to JAX's. A world of 4 ranks
runs the cases once per module (``torch_ranks``)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_ranks
from test_torch_parallel import flat
from tinychatengine_tpu.core.config import GenerationConfig as JGen
from tinychatengine_tpu.core.config import ModelConfig as JModelConfig
from tinychatengine_tpu.core.config import QuantConfig as JQuantConfig
from tinychatengine_tpu.generation.engine import Engine as JEngine
from tinychatengine_tpu.models import llama as jllama
from tinychatengine_tpu.parallel.sp import make_sp_mesh as jmake_sp_mesh
from tinychatengine_tpu.runtime.serving import ServingEngine as JServing
from tinychatengine_tpu_torch.tokenizers.byte_fallback import ByteTokenizer

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "assets" / "bytellama_5m"
GOLDEN = Path(__file__).parent / "golden" / "bytellama_greedy.json"
TINY = dict(name="tiny", family="llama", num_heads=8, num_kv_heads=4,
            num_layers=2, max_sqlen=256, embed_dim=1024, hidden_dim=1024,
            vocab_size=512, rms_norm_eps=1e-5)
N_CHECK = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers (and this module's ranks beside
    them): one intra-op thread keeps torch's CPU ops from oversubscribing
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden():
    if not (CKPT / "meta.json").exists() or not GOLDEN.exists():
        pytest.skip("trained checkpoint / golden transcript not present")
    gold = json.loads(GOLDEN.read_text())
    ids = np.asarray(ByteTokenizer().encode(gold["prompt"]), np.int64)
    return gold, ids


def _prompts(seed):
    """Two long prompts (past the threshold of 32) and two short ones."""
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 512, n).astype(np.int32) for n in (100, 7, 65, 3)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    gold, ids = _golden()
    inp = dict(ckpt=str(CKPT), ids=ids, n_check=N_CHECK)
    data = {"sp_pp": inp, "sp_tp": inp}
    jobs = [("foreign", "foreign_modules"), ("sp_pp", "golden_sp_pp"),
            ("sp_tp", "golden_sp_tp_serving")]
    return torch_ranks.world(tmp_path_factory.mktemp("sps"), data, jobs,
                             4).result()


def test_golden_transcript_through_sp_and_pp(ranks):
    """bytellama_5m's trained weights: the golden greedy transcript through
    (a) the SP ring prefill of a right-padded 4-rank bucket and the
    decode-cache splice and (b) the 4-stage PP forward, on every rank."""
    gold, _ = _golden()
    want = gold["token_ids"][:N_CHECK]
    for r in ranks:
        assert r["foreign"] == []
        assert r["sp_pp"]["sp"] == want, r["sp_pp"]["sp"]
        assert r["sp_pp"]["pp"] == want, r["sp_pp"]["pp"]


def test_sp_admission_with_tp_decode_golden(ranks):
    """SP prefill over (2 seq x 2 model) at admission, Megatron TP decode
    on (1 x 2) ranks 0-1 while ranks 2-3 follow the host program: the
    golden transcript token for token, sp_stats as JAX's."""
    gold, _ = _golden()
    for r in ranks:
        got = r["sp_tp"]
        assert got["finished"]
        assert got["tokens"] == gold["token_ids"][:N_CHECK], got["tokens"]
        # the 32-token head of the 33-token prompt rode the ring
        assert got["sp_stats"] == {"admissions": 1, "tokens": 32}


# ---- the slow tier -----------------------------------------------------------

@pytest.fixture(scope="module")
def slow_ranks(tmp_path_factory):
    cfg = JModelConfig(**TINY)
    data = {
        "fp": dict(cfg=TINY, qcfg=dict(scheme="fp"), n_predict=8,
                   prompts=_prompts(0), flat=flat(jllama.init_random_params(
                       cfg, JQuantConfig(scheme="fp"), seed=0))),
        "int8": dict(cfg=TINY, qcfg=dict(scheme="fp", kv_cache_dtype="int8"),
                     n_predict=6, prompts=_prompts(1),
                     kw=dict(paged=True, page_size=16),
                     flat=flat(jllama.init_random_params(
                         cfg, JQuantConfig(scheme="fp",
                                           kv_cache_dtype="int8"), seed=0)))}
    jobs = [("fp", "sp_admission"), ("int8", "sp_admission")]
    if (CKPT / "meta.json").exists() and GOLDEN.exists():
        gold, ids = _golden()
        data["pp"] = dict(ckpt=str(CKPT), ids=ids, n_check=N_CHECK,
                          other=np.asarray(ByteTokenizer().encode(
                              "def main():"), np.int64))
        jobs.append(("pp", "pp_serving_golden"))
    return torch_ranks.world(tmp_path_factory.mktemp("sps_slow"), data, jobs,
                             4).result()


def _jax_sp_serving(qcfg, prompts, n_predict, **kw):
    cfg = JModelConfig(**TINY)
    g = JGen(temp=0.0, n_predict=n_predict, repeat_penalty=1.0,
             repeat_last_n=1)
    srv = JServing(jllama.init_random_params(cfg, qcfg, seed=0), cfg, qcfg,
                   slots=2, gcfg=g, sp_mesh=jmake_sp_mesh(4),
                   sp_threshold=32, **kw)
    reqs = [srv.submit(p, n_predict=n_predict) for p in prompts]
    srv.run()
    return [r.output_ids for r in reqs], srv.sp_stats


@pytest.mark.slow
def test_sp_admission_matches_plain_greedy(slow_ranks):
    """Long prompts' power-of-two heads through the ring (4 seq ranks),
    plain decode: tokens equal the plain greedy engine's and JAX's SP
    server's, sp_stats JAX's."""
    cfg, q = JModelConfig(**TINY), JQuantConfig(scheme="fp")
    g = JGen(temp=0.0, n_predict=8, repeat_penalty=1.0, repeat_last_n=1)
    eng = JEngine(jllama.init_random_params(cfg, q, seed=0), cfg, q, batch=1,
                  max_len=cfg.max_sqlen)
    want = [list(eng.generate(p[None, :], g).tokens[0]) for p in _prompts(0)]
    jtoks, jstats = _jax_sp_serving(q, _prompts(0), 8)
    assert jtoks == want
    for r in slow_ranks:
        assert all(r["fp"]["finished"])
        assert r["fp"]["tokens"] == want
        assert r["fp"]["sp_stats"] == jstats == {"admissions": 2,
                                                 "tokens": 128}


@pytest.mark.slow
def test_sp_admission_paged_and_quant_int8kv(slow_ranks):
    """SP admission with the paged cache and int8 KV: tokens equal the
    plain dense server's (JAX's) and JAX's SP server's."""
    cfg = JModelConfig(**TINY)
    q = JQuantConfig(scheme="fp", kv_cache_dtype="int8")
    g = JGen(temp=0.0, n_predict=6, repeat_penalty=1.0, repeat_last_n=1)
    plain = JServing(jllama.init_random_params(cfg, q, seed=0), cfg, q,
                     slots=2, gcfg=g)
    want = [plain.submit(p, n_predict=6) for p in _prompts(1)]
    plain.run()
    jtoks, jstats = _jax_sp_serving(q, _prompts(1), 6, paged=True,
                                    page_size=16)
    for r in slow_ranks:
        assert r["int8"]["tokens"] == [w.output_ids for w in want] == jtoks
        assert r["int8"]["sp_stats"]["admissions"] == jstats["admissions"] \
            == 2


@pytest.mark.slow
def test_pp_serving_decode_golden(slow_ranks):
    """ServingEngine decoding through the 2-stage PP forward (2 slots as 2
    microbatches, the admissions as one): the golden transcript, and the
    second request equal to its single-device run."""
    if "pp" not in slow_ranks[0]:
        pytest.skip("trained checkpoint / golden transcript not present")
    from tinychatengine_tpu.core.config import get_model_config
    from tinychatengine_tpu.tools.checkpoint import load_checkpoint
    gold, _ = _golden()
    cfg = get_model_config("bytellama_5m")
    params, qcfg = load_checkpoint(str(CKPT), cfg)
    g = JGen(temp=0.0, n_predict=N_CHECK, repeat_penalty=1.0,
             repeat_last_n=1)
    other = np.asarray(ByteTokenizer().encode("def main():"), np.int32)
    want2 = list(JEngine(params, cfg, qcfg, batch=1, max_len=256)
                 .generate(other[None, :], g).tokens[0])[:8]
    for r in slow_ranks[:2]:
        assert r["pp"]["finished"]
        assert r["pp"]["tokens"] == gold["token_ids"][:N_CHECK]
        assert r["pp"]["tokens2"] == want2


def test_chip_smoke_parallel_phase_rehearses_on_cpu(monkeypatch):
    """chip_smoke.py's phase 17 (b)-(f) (``parallel_path``) at a tiny width
    on the CPU, its checks as on the card but the launch counts: the
    one-process runs, 2 ranks through TP engine and paged serving, the SP
    prefill, splice and decode, the PP forward, then the scaling CLI with
    its own ranks. The collective counts are the Megatron, ring and
    GPipe patterns per step or forward; the planted faults (a wrong wo
    shard, a ring hop to the rank itself) read above the limit that the
    sound runs and the split-K witness keep."""
    import chip_smoke
    from tinychatengine_tpu_torch.core.config import (MODEL_REGISTRY,
                                                      ModelConfig)
    cfg = ModelConfig(name="par_tiny", family="llama", num_heads=8,
                      num_kv_heads=4, num_layers=2, max_sqlen=128,
                      embed_dim=512, hidden_dim=1024, vocab_size=512,
                      rms_norm_eps=1e-5)
    monkeypatch.setitem(MODEL_REGISTRY, cfg.name, cfg)
    sizes = dict(prompt=16, decode=8, requests=4, req_tokens=8, sp_len=32,
                 sp_decode=4, pp_rows=2, pp_micro=2, pp_decode=4,
                 max_len=128)
    out = chip_smoke.parallel_path(
        dev="cpu", model=cfg, sizes=sizes,
        scaling_args=("--model", cfg.name, "--configs", "1x1,1x2",
                      "--n-decode", "4", "--scheme", "w4a8"))
    layers = cfg.num_layers
    per_step = out["tp"]["per_step"]
    assert (per_step["all_reduce"], per_step["all_gather"],
            per_step["collective_permute"]) == (2 * layers, 1, 0)
    tol = chip_smoke.PAR_STEP_TOL
    assert max(out["tp"]["step_gaps"] + out["tp"]["split_rows_gaps"]) <= tol
    assert min(out["tp"]["fault_gaps"]) > tol
    assert out["tp"]["other_prompt_gap"] > tol
    sp = out["sp"]
    assert len(sp["k_layer_gaps"]) == len(sp["v_layer_gaps"]) == layers
    assert max(sp["k_layer_gaps"] + sp["v_layer_gaps"]) <= tol
    assert sp["fault_logit_gap"] > tol
    assert out["sp"]["stats"]["collective_permute"] == 3 * layers
    assert out["sp"]["stats"]["all_reduce"] == 1
    assert out["pp"]["stats"]["collective_permute"] == 2 + 2 - 1
    assert [r["shared"] for r in out["scaling"]] == [
        "1 rank(s) on the CPU", "2 rank(s) on the CPU"]
    assert {"tp_engine", "tp_paged_serving", "sp_prefill", "pp"} \
        == set(out["launches"])
