"""The port's continuous-batching ServingEngine and per-row sampler on the
CPU: the sampler's processed logits and kept sets against JAX
``sample_rows`` for every stage gate, the bytellama_5m goldens through
serving (dense and paged), one mixed load against the JAX ServingEngine,
and the serving invariants of the JAX package's tests/test_serving.py as
CPU twins (a request's tokens do not depend on its slot, its neighbours,
bursts, pages, preemption or cancellation of others)."""

import itertools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinychatengine_tpu.core.config import GenerationConfig as JGen
from tinychatengine_tpu.core.config import ModelConfig as JModelConfig
from tinychatengine_tpu.core.config import QuantConfig as JQuantConfig
from tinychatengine_tpu.generation import sampling as jsmp
from tinychatengine_tpu.models import llama as jllama
from tinychatengine_tpu.runtime.serving import ServingEngine as JServing
from tinychatengine_tpu.tools import checkpoint as jckpt
from tinychatengine_tpu_torch.core.config import (GenerationConfig,
                                                  ModelConfig, QuantConfig,
                                                  get_model_config)
from tinychatengine_tpu_torch.generation import sampling as tsmp
from tinychatengine_tpu_torch.generation.engine import Engine
from tinychatengine_tpu_torch.models import llama
from tinychatengine_tpu_torch.runtime.serving import ServingEngine
from tinychatengine_tpu_torch.tokenizers.byte_fallback import ByteTokenizer
from tinychatengine_tpu_torch.tools.checkpoint import load_checkpoint

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "assets" / "bytellama_5m"
TINY = dict(name="tiny", family="llama", num_heads=4, num_kv_heads=2,
            num_layers=2, max_sqlen=128, embed_dim=128, hidden_dim=256,
            vocab_size=256, rms_norm_eps=1e-5)
PROMPTS = [np.array([5, 9, 11]), np.array([7, 3]),
           np.array([100, 101, 102, 103, 104, 105]), np.array([42]),
           np.array([1, 2, 3, 4])]
GREEDY = dict(temp=0.0, repeat_penalty=1.0, repeat_last_n=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers: one intra-op thread per worker
    keeps torch's many small CPU ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    cfg, qcfg = ModelConfig(**TINY), QuantConfig(scheme="fp")
    return cfg, qcfg, llama.init_random_params(cfg, qcfg, seed=0,
                                               device="cpu")


def _srv(tiny, **kw):
    cfg, qcfg, params = tiny
    return ServingEngine(params, cfg, qcfg, device="cpu", **kw)


def _solo(tiny, prompt, g):
    cfg, qcfg, params = tiny
    eng = Engine(params, cfg, qcfg, batch=1, max_len=cfg.max_sqlen,
                 device="cpu")
    return eng.generate(prompt[None, :], g).tokens[0]


# ---- sample_rows: processed logits and kept sets against JAX --------------

def _row_cfgs(ub, ut, um, kmax, pl):
    """Four rows that use exactly the stages the gates allow."""
    rp, fp = (1.3, 0.3) if pl else (0.8, -0.3)
    rows = [dict(temp=0.0, top_k=20 if kmax else 0, repeat_penalty=rp),
            dict(temp=0.8, top_p=0.9, top_k=40 if kmax else 0,
                 frequency_penalty=fp, presence_penalty=0.2),
            dict(temp=1.2, top_k=7, top_p=0.95),
            dict(temp=0.6, top_k=64, repeat_penalty=rp)]
    if ub:
        rows[2]["logit_bias"] = {3: 5.0, 10: -2.0}
    if ut:
        rows[2].update(tfs_z=0.95, typical_p=0.9)
        rows[1]["typical_p"] = 0.8
    if um:
        rows[3].update(mirostat=2, mirostat_tau=4.0, mirostat_eta=0.2)
        rows[1].update(mirostat=1, mirostat_tau=3.0, mirostat_eta=0.1)
    return rows


def _capture_jax(monkeypatch, seen):
    """Run JAX sample_rows' vmaps as Python loops and record what each
    categorical draw sees (the processed logits of one row); the draw
    itself becomes the argmax."""
    def vmap(fn):
        def looped(*args):
            n = args[0].shape[0]
            return jnp.stack([fn(*(a[i] for a in args)) for i in range(n)])
        return looped

    def categorical(key, logits):
        seen.append(np.asarray(logits))
        return jnp.argmax(logits)
    monkeypatch.setattr(jax, "vmap", vmap)
    monkeypatch.setattr(jax.random, "categorical", categorical)


@pytest.mark.parametrize("ub,ut,um,kmax,pl", [
    g for g in itertools.product((False, True), (False, True), (False, True),
                                 (0, 64), (False, True))])
def test_sample_rows_processed_logits_match_jax(monkeypatch, ub, ut, um,
                                                kmax, pl):
    """Same logits, history, configs and gates on both sides: every draw's
    processed (masked, temperature-scaled) logits keep the same set with
    the same values, and with the draw replaced by an argmax the tokens
    and the carried mirostat mu agree. The random streams themselves
    differ by design (ROADMAP parity rules)."""
    rng = np.random.default_rng(hash((ub, ut, um, kmax, pl)) % 2**32)
    b, v = 4, 160
    logits = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    last = rng.integers(-1, 40, (b, 8))
    mu = np.full((b,), 8.0, np.float32)
    rows = _row_cfgs(ub, ut, um, kmax, pl)
    gates = dict(use_bias=ub, use_tfs_typical=ut, use_mirostat=um,
                 top_k_max=kmax, pen_lower=pl)

    seen_t = []

    def draw(masked, keys):
        seen_t.extend(masked.numpy())
        return torch.argmax(masked, dim=-1).to(torch.int32)
    monkeypatch.setattr(tsmp, "_draw", draw)
    t_tok, t_keys, t_mu = tsmp.sample_rows(
        torch.from_numpy(logits),
        tsmp.row_keys(0, b, device="cpu"),
        tsmp.RowParams.from_configs([GenerationConfig(**r) for r in rows],
                                    device="cpu"),
        torch.from_numpy(last), torch.from_numpy(mu), **gates)

    seen_j = []
    _capture_jax(monkeypatch, seen_j)
    keys = jnp.stack([jax.random.PRNGKey(i) for i in range(b)])
    j_tok, _, j_mu = jsmp.sample_rows(
        jnp.asarray(logits), keys,
        jsmp.RowParams.from_configs([JGen(**r) for r in rows]),
        jnp.asarray(last, jnp.int32), jnp.asarray(mu), **gates)

    assert len(seen_t) == len(seen_j) == b * (3 if um else 1)
    for i, (got, want) in enumerate(zip(seen_t, seen_j)):
        kept = want > -1e29
        np.testing.assert_array_equal(got > -1e29, kept, err_msg=str(i))
        np.testing.assert_allclose(got[kept], want[kept], rtol=1e-5,
                                   atol=1e-5, err_msg=str(i))
    assert t_tok.tolist() == np.asarray(j_tok).tolist()
    np.testing.assert_allclose(t_mu.numpy(), np.asarray(j_mu), rtol=1e-5)
    assert t_keys[:, 1].tolist() == [1] * b  # each row's step advanced


@pytest.mark.parametrize("kmax,pl", [(0, False), (64, False), (64, True)])
def test_sample_rows_greedy_ties_match_jax(kmax, pl):
    """Greedy rows over logits full of exact ties (bf16-like steps), with
    penalties: the same tokens as JAX, whose candidate order breaks ties
    by ascending token id."""
    rng = np.random.default_rng(kmax + pl)
    b, v = 6, 300
    logits = np.round(rng.standard_normal((b, v)) * 4).astype(np.float32)
    last = rng.integers(-1, 300, (b, 8))
    rows = [dict(temp=0.0, top_k=40, repeat_penalty=1.0 + 0.2 * i)
            for i in range(b)]
    gates = dict(use_bias=False, use_tfs_typical=False, use_mirostat=False,
                 top_k_max=kmax, pen_lower=pl)
    got = tsmp.sample_rows(
        torch.from_numpy(logits), tsmp.row_keys(0, b, device="cpu"),
        tsmp.RowParams.from_configs([GenerationConfig(**r) for r in rows],
                                    device="cpu"),
        torch.from_numpy(last), **gates)[0]
    want = jsmp.sample_rows(
        jnp.asarray(logits), jnp.stack([jax.random.PRNGKey(i)
                                        for i in range(b)]),
        jsmp.RowParams.from_configs([JGen(**r) for r in rows]),
        jnp.asarray(last, jnp.int32), **gates)[0]
    assert got.tolist() == np.asarray(want).tolist()


def test_row_streams_depend_on_key_and_step_only():
    """A row's draws are a function of its own (key, step): the same row
    gives the same token wherever it sits in a batch, a different step
    gives a fresh draw, and the draws follow the kept distribution."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((1, 50)).astype(np.float32))
    def params(n):
        return tsmp.RowParams.from_configs(
            [GenerationConfig(temp=1.0, top_k=0, top_p=1.0)] * n,
            device="cpu")
    key = tsmp.row_key(11)
    alone = tsmp.sample_rows(logits, torch.tensor([[key, 5]]), params(1),
                             use_tfs_typical=False, use_mirostat=False)[0]
    batch = tsmp.sample_rows(
        logits.expand(3, 50),
        torch.tensor([[tsmp.row_key(1), 0], [key, 5], [key, 6]]), params(3),
        use_tfs_typical=False, use_mirostat=False)[0]
    assert batch[1] == alone[0]
    draws = [int(tsmp._draw(logits, torch.tensor([[key, s]]))[0])
             for s in range(4000)]
    freq = np.bincount(draws, minlength=50) / 4000
    probs = torch.softmax(logits[0], 0).numpy()
    assert np.abs(freq - probs).max() < 0.03


# ---- ServingEngine against the JAX package ---------------------------------

@pytest.fixture(scope="module")
def trained():
    if not (CKPT / "meta.json").exists():
        pytest.skip("trained checkpoint not present")
    cfg = get_model_config("bytellama_5m")
    params, _ = load_checkpoint(str(CKPT), cfg, device="cpu")
    return cfg, params


@pytest.mark.parametrize("paged", [False, True])
def test_serving_goldens_token_exact(trained, paged):
    """The committed JAX greedy transcripts of bytellama_5m (fp), four
    requests through two slots: queueing, batched admission (dense), pages
    and bursts must all be invisible."""
    cfg, params = trained
    golds = [json.loads((REPO / "tests/golden/bytellama_greedy.json")
                        .read_text())]
    golds += json.loads((REPO / "tests/golden/bytellama_goldens.json")
                        .read_text())
    g = GenerationConfig(n_predict=48, **GREEDY)
    srv = ServingEngine(params, cfg, QuantConfig(scheme="fp"), slots=2,
                        max_len=cfg.max_sqlen, gcfg=g, paged=paged,
                        page_size=16, tick_batch=8, device="cpu")
    tok = ByteTokenizer()
    reqs = [srv.submit(tok.encode(gold["prompt"])) for gold in golds]
    srv.run()
    for r, gold in zip(reqs, golds):
        assert r.output_ids == gold["token_ids"], tok.decode(r.output_ids)
        assert r.finish_reason == "length"
    if paged:
        assert srv.allocator.n_free == srv.page_cache.n_pages - 1


def test_mixed_load_matches_jax_serving():
    """One mixed-config load (greedy with penalties, sampled, a top_k = 1
    row) through the JAX ServingEngine and the port's, dense and paged:
    greedy rows token-exact, sampled rows complete."""
    jcfg = JModelConfig(**TINY)
    jq = JQuantConfig(scheme="fp")
    jp = jllama.init_random_params(jcfg, jq, seed=0)
    cfg, qcfg = ModelConfig(**TINY), QuantConfig(scheme="fp")
    tp = llama.params_from_numpy(jckpt._flatten(jp)[0], cfg, qcfg,
                                 device="cpu")
    engine_g = dict(temp=0.0, n_predict=10, repeat_penalty=1.1,
                    repeat_last_n=8, seed=3)
    per_req = [None, dict(temp=1.1, top_p=0.9, n_predict=10, seed=21),
               dict(temp=1.5, top_k=1, n_predict=10, repeat_penalty=1.0,
                    repeat_last_n=1), None,
               dict(temp=0.7, top_k=40, n_predict=10, seed=5)]
    greedy_rows = [0, 2, 3]

    js = JServing(jp, jcfg, jq, slots=3, gcfg=JGen(**engine_g),
                  tick_batch=4)
    jreqs = [js.submit(p, gcfg=None if c is None else JGen(**c))
             for p, c in zip(PROMPTS, per_req)]
    js.run()
    for paged in (False, True):
        srv = ServingEngine(tp, cfg, qcfg, slots=3,
                            gcfg=GenerationConfig(**engine_g), tick_batch=4,
                            paged=paged, page_size=16, device="cpu")
        reqs = [srv.submit(p, gcfg=None if c is None
                           else GenerationConfig(**c))
                for p, c in zip(PROMPTS, per_req)]
        srv.run()
        for i, (r, jr) in enumerate(zip(reqs, jreqs)):
            assert len(r.output_ids) == len(jr.output_ids) == 10
            assert r.finish_reason == jr.finish_reason == "length"
            if i in greedy_rows:
                assert r.output_ids == jr.output_ids, (paged, i)
            assert all(0 <= t < cfg.vocab_size for t in r.output_ids)


# ---- serving invariants (CPU twins of tests/test_serving.py) ---------------

@pytest.mark.parametrize("paged", [False, True])
def test_batched_greedy_matches_single(tiny, paged):
    """Five requests through two slots (queueing and backfill) give each
    request's solo Engine tokens; paged, every page returns to the pool."""
    g = GenerationConfig(n_predict=12, **GREEDY)
    want = [_solo(tiny, p, g) for p in PROMPTS]
    srv = _srv(tiny, slots=2, gcfg=g, paged=paged, page_size=16)
    reqs = [srv.submit(p, n_predict=12) for p in PROMPTS]
    srv.run()
    for r, w in zip(reqs, want):
        assert r.output_ids == list(w) and r.finish_reason == "length"
    if paged:
        assert srv.allocator.n_free == srv.page_cache.n_pages - 1


def test_paged_matches_dense_with_bursts(tiny):
    g = GenerationConfig(n_predict=18, **GREEDY)
    dense = _srv(tiny, slots=2, gcfg=g, tick_batch=1)
    want = [dense.submit(p) for p in PROMPTS]
    dense.run()
    srv = _srv(tiny, slots=2, gcfg=g, tick_batch=6, paged=True, page_size=16)
    reqs = [srv.submit(p) for p in PROMPTS]
    srv.run()
    assert srv.tick_stats["bursts"] > 0
    for r, w in zip(reqs, want):
        assert r.output_ids == w.output_ids


def test_int8_kv_paged_matches_dense():
    """With the int8 KV cache (plain attention on the CPU; the card's
    kernels take bf16 only) paged serving gives the dense engine's greedy
    tokens, and both give the solo Engine's."""
    cfg = ModelConfig(**TINY)
    qcfg = QuantConfig(scheme="fp", kv_cache_dtype="int8")
    params = llama.init_random_params(cfg, qcfg, seed=0, device="cpu")
    g = GenerationConfig(n_predict=10, **GREEDY)
    want = [_solo((cfg, qcfg, params), p, g) for p in PROMPTS]
    for paged in (False, True):
        srv = ServingEngine(params, cfg, qcfg, slots=2, gcfg=g, paged=paged,
                            page_size=16, device="cpu")
        assert srv._kv().quantized
        reqs = [srv.submit(p) for p in PROMPTS]
        srv.run()
        assert [r.output_ids for r in reqs] == [list(w) for w in want]


@pytest.mark.parametrize("paged", [False, True])
def test_tick_batching_exactness(tiny, paged):
    """A K-tick burst draws what K single ticks draw: greedy with penalties
    and a seeded sampled request give the same tokens at tick_batch 1
    and 8."""
    g = GenerationConfig(temp=0.0, n_predict=21, repeat_penalty=1.1,
                         repeat_last_n=8, seed=4)

    def run(tb):
        srv = _srv(tiny, slots=3, gcfg=g, tick_batch=tb, paged=paged,
                   page_size=16)
        ra = srv.submit(PROMPTS[0])
        rb = srv.submit(PROMPTS[1], gcfg=GenerationConfig(
            temp=1.1, top_p=0.9, n_predict=17, repeat_penalty=1.0,
            repeat_last_n=4, seed=33))
        srv.run()
        return ra.output_ids, rb.output_ids, srv.tick_stats["bursts"]

    a1, b1, bursts1 = run(1)
    a8, b8, bursts8 = run(8)
    assert bursts1 == 0 and bursts8 > 0
    assert (a8, b8) == (a1, b1)
    assert len(a1) == 21 and len(b1) == 17


def test_tick_batching_stop_token_mid_burst(tiny):
    g = GenerationConfig(temp=0.0, n_predict=40, repeat_penalty=1.3,
                         repeat_last_n=8)
    probe = _srv(tiny, slots=1, gcfg=g, tick_batch=1)
    r0 = probe.submit(PROMPTS[0])
    probe.run()
    cut = next(i for i in range(2, 39)
               if r0.output_ids[i] not in r0.output_ids[:i])
    stop_tok = r0.output_ids[cut]
    srv = _srv(tiny, slots=1, gcfg=g, tick_batch=8)
    r = srv.submit(PROMPTS[0], stop_token_ids=(stop_tok,))
    srv.run()
    assert r.finish_reason == "stop"
    assert r.output_ids == r0.output_ids[:cut + 1]  # overshoot discarded


@pytest.mark.parametrize("version", [1, 2])
def test_per_request_mirostat(tiny, version):
    """A mirostat request gives the same tokens alone and beside a greedy
    and a hot neighbour (per-row mu and key), and the same in bursts as in
    single ticks; the greedy neighbour keeps its solo tokens."""
    g = GenerationConfig(temp=0.7, n_predict=10, seed=2, repeat_penalty=1.0,
                         repeat_last_n=1)
    miro = GenerationConfig(temp=0.8, mirostat=version, mirostat_tau=4.0,
                            mirostat_eta=0.3, n_predict=10,
                            repeat_penalty=1.1, repeat_last_n=4, seed=17)
    greedy = GenerationConfig(n_predict=10, **GREEDY)
    solo = _srv(tiny, slots=2, gcfg=g, tick_batch=1)
    rs = solo.submit(PROMPTS[0], gcfg=miro)
    solo.run()
    assert len(rs.output_ids) == 10
    for tb in (1, 8):
        srv = _srv(tiny, slots=3, gcfg=g, tick_batch=tb)
        rm = srv.submit(PROMPTS[0], gcfg=miro)
        rg = srv.submit(PROMPTS[1], gcfg=greedy)
        rh = srv.submit(PROMPTS[2], gcfg=GenerationConfig(
            temp=1.3, top_p=0.9, n_predict=10, repeat_penalty=1.0,
            repeat_last_n=1, seed=5))
        srv.run()
        assert rm.output_ids == rs.output_ids
        assert rg.output_ids == list(_solo(tiny, PROMPTS[1], greedy))
        assert len(rh.output_ids) == 10


def test_per_request_seed_and_logit_bias(tiny):
    """Same per-request seed → same sampled tokens in another engine and
    another slot; a logit_bias row is forced, its neighbour is not."""
    g = GenerationConfig(temp=0.7, n_predict=6, seed=0)
    hot = GenerationConfig(temp=1.2, top_p=0.9, n_predict=6,
                           repeat_penalty=1.3, repeat_last_n=8, seed=11)
    a = _srv(tiny, slots=2, gcfg=g)
    ra = a.submit(PROMPTS[0], gcfg=hot)
    a.run()
    b = _srv(tiny, slots=3, gcfg=g)
    b.submit(PROMPTS[2])
    b.submit(PROMPTS[3])
    rb = b.submit(PROMPTS[0], gcfg=hot)
    b.run()
    assert rb.output_ids == ra.output_ids
    srv = _srv(tiny, slots=2, gcfg=g)
    r = srv.submit(PROMPTS[0], gcfg=GenerationConfig(
        temp=0.7, n_predict=4, repeat_penalty=1.0, repeat_last_n=1,
        logit_bias={123: 1e9}, seed=5))
    r2 = srv.submit(PROMPTS[1], gcfg=GenerationConfig(n_predict=4, **GREEDY))
    srv.run()
    assert r.output_ids == [123] * 4 and r2.output_ids != [123] * 4


def test_batched_admission_exact(tiny):
    """Batched admission (R queue-head prompts in one ragged prefill) gives
    the tokens of the single-admission path, greedy and seeded-sampled."""
    g = GenerationConfig(temp=0.0, n_predict=9, repeat_penalty=1.1,
                         repeat_last_n=8, seed=3)
    sampled = GenerationConfig(temp=1.1, top_k=12, top_p=0.9, n_predict=9,
                               repeat_penalty=1.2, repeat_last_n=8, seed=77)

    def run(batch_admit):
        srv = _srv(tiny, slots=4, gcfg=g, tick_batch=4)
        srv._batch_admit = batch_admit
        reqs = [srv.submit(p, gcfg=sampled if i % 2 else None)
                for i, p in enumerate(PROMPTS)]
        srv.run()
        return srv, reqs

    s1, want = run(False)
    s2, got = run(True)
    assert s1.tick_stats["batch_admits"] == 0
    assert s2.tick_stats["batch_admit_reqs"] >= 4
    for w, r in zip(want, got):
        assert r.output_ids == w.output_ids
        assert r.finish_reason == w.finish_reason


@pytest.mark.parametrize("paged", [False, True])
def test_chunked_admission_interleaves_and_stays_single_tick(tiny, paged):
    """A 64-token prompt admits in four 16-token chunks, one per tick;
    meanwhile the running request emits one token per tick (no bursts), and
    both match their solo runs."""
    g = GenerationConfig(n_predict=24, **GREEDY)
    long_prompt = np.arange(10, 74)
    srv = _srv(tiny, slots=2, gcfg=g, admission_chunk=16, tick_batch=8,
               paged=paged, page_size=16)
    ra = srv.submit(PROMPTS[0])
    srv.step()
    rb = srv.submit(long_prompt, n_predict=8)
    emitted, steps = [], 0
    while srv._pending is not None or not any(
            s.request is rb and not s.admitting for s in srv.slots):
        n0, b0 = len(ra.output_ids), srv.tick_stats["bursts"]
        srv.step()
        if srv._pending is not None:
            assert srv.tick_stats["bursts"] == b0
            emitted.append(len(ra.output_ids) - n0)
        steps += 1
        assert steps < 20, "admission never finished"
    assert emitted == [1, 1, 1]
    srv.run()
    assert ra.output_ids == list(_solo(tiny, PROMPTS[0], g))
    assert rb.output_ids == list(_solo(tiny, long_prompt, GenerationConfig(
        n_predict=8, **GREEDY)))


def test_paged_chunked_admission_reserves_pages(tiny):
    """Pages of a chunked admission are reserved when it starts: a running
    request crossing a page boundary meanwhile cancels and requeues the
    admission instead of failing."""
    g = GenerationConfig(n_predict=24, **GREEDY)
    a_prompt, long_prompt = np.arange(30, 44), np.arange(10, 74)
    srv = _srv(tiny, slots=2, gcfg=g, paged=True, page_size=16, n_pages=6,
               admission_chunk=16, tick_batch=1)
    ra = srv.submit(a_prompt, n_predict=24)
    srv.step()
    rb = srv.submit(long_prompt, n_predict=8)
    srv.run()
    assert ra.output_ids == list(_solo(tiny, a_prompt, g))
    assert rb.output_ids == list(_solo(tiny, long_prompt, GenerationConfig(
        n_predict=8, **GREEDY)))


def test_paged_preemption_and_small_pools(tiny):
    """A pool too small for every sequence preempts (outputs unchanged, all
    pages back); a pool below the dense size still serves the queue; a pool
    that cannot hold one prefill raises."""
    g = GenerationConfig(n_predict=20, **GREEDY)
    ample = _srv(tiny, slots=2, gcfg=g, paged=True, page_size=16)
    want = [ample.submit(p) for p in PROMPTS[:3]]
    ample.run()
    tight = _srv(tiny, slots=2, gcfg=g, paged=True, page_size=16, n_pages=6)
    got = [tight.submit(p) for p in PROMPTS[:3]]
    tight.run()
    for w, r in zip(want, got):
        assert r.output_ids == w.output_ids
    assert tight.allocator.n_free == tight.page_cache.n_pages - 1
    small = _srv(tiny, slots=2, gcfg=g, paged=True, page_size=16, n_pages=10)
    reqs = [small.submit(p, n_predict=6) for p in PROMPTS]
    small.run()
    assert all(r.finished for r in reqs)
    none = _srv(tiny, slots=1, gcfg=g, paged=True, page_size=16, n_pages=2)
    none.submit(np.arange(1, 30))  # needs two pages to prefill
    with pytest.raises(MemoryError):
        none.run()


@pytest.mark.parametrize("paged", [False, True])
def test_cancel_all_lifecycle_stages(tiny, paged):
    """cancel() aborts a request queued, mid-admission and decoding, frees
    its slot (and pages, its table row back on the dead page) and leaves
    the others' tokens as they were."""
    g = GenerationConfig(n_predict=12, **GREEDY)
    want_a = list(_solo(tiny, PROMPTS[0], g))
    srv = _srv(tiny, slots=2, gcfg=g, admission_chunk=16, tick_batch=1,
               paged=paged, page_size=16)
    free0 = srv.allocator.n_free if paged else None
    ra = srv.submit(PROMPTS[0])
    rq = srv.submit(PROMPTS[2])
    assert srv.cancel(rq) is True and rq.finish_reason == "cancelled"
    assert rq.output_ids == [] and rq in srv.done
    assert srv.cancel(rq) is False
    srv.step()
    rb = srv.submit(np.arange(10, 74))
    srv.step()
    assert srv._pending is not None
    assert srv.cancel(rb) is True and srv._pending is None
    while len(ra.output_ids) < 4:
        srv.step()
    assert srv.cancel(ra) is True
    assert ra.output_ids == want_a[:len(ra.output_ids)]
    assert srv.n_active == 0
    if paged:
        assert srv.allocator.n_free == free0
        assert (srv._tables == srv._dead_page).all()
    rc = srv.submit(PROMPTS[0])
    srv.run()
    assert rc.output_ids == want_a and rc.finish_reason == "length"


def test_stop_tokens_streaming_and_timestamps(tiny):
    g = GenerationConfig(n_predict=50, **GREEDY)
    stop = _solo(tiny, PROMPTS[0], g)[3]
    srv = _srv(tiny, slots=2, gcfg=g)
    seen = []
    r1 = srv.submit(PROMPTS[0], stop_token_ids=(stop,),
                    on_token=lambda t, req: seen.append(t))
    r2 = srv.submit(PROMPTS[1])
    srv.run()
    assert r1.finish_reason == "stop" and r1.output_ids[-1] == stop
    assert seen == r1.output_ids and len(r1.output_ids) <= 4
    assert r2.finish_reason == "length" and len(r2.output_ids) == 50
    assert r1.submit_t <= r1.first_token_t <= r1.done_t


def test_engine_global_sampler_and_unported_options(tiny):
    """An engine logit_bias table past RowParams.MAX_BIAS keeps the
    engine-global sampler (no bursts, no per-request configs, speculation
    off); sequence-parallel admission, still not ported, raises instead of
    being ignored, and logprobs and input_embeds are checked at submit."""
    bias = {i: -1e9 for i in range(20, 40)}
    g = GenerationConfig(n_predict=5, logit_bias=bias, **GREEDY)
    srv = _srv(tiny, slots=2, gcfg=g, tick_batch=8)
    reqs = [srv.submit(p) for p in PROMPTS[:3]]
    srv.run()
    assert srv.tick_stats["bursts"] == 0
    for r in reqs:
        assert len(r.output_ids) == 5
        assert not any(20 <= t < 40 for t in r.output_ids)
    with pytest.raises(ValueError):
        srv.submit(PROMPTS[0], gcfg=GenerationConfig())
    with pytest.raises(NotImplementedError):
        _srv(tiny, sp_mesh=object())
    assert not _srv(tiny, gcfg=g, speculative=True).speculative
    with pytest.raises(ValueError):
        srv.submit(PROMPTS[0], logprobs=srv.logprobs_k + 1)
    with pytest.raises(ValueError):
        srv.submit(PROMPTS[0], input_embeds=np.zeros((2, 128)))


# ---- prefix cache (CPU twins of tests/test_serving.py's prefix tests) -------

@pytest.fixture(scope="module")
def twin_params():
    """The tiny model's JAX params and the port's copy, per KV storage."""
    out = {}
    for kv in ("bf16", "int8"):
        jcfg = JModelConfig(**TINY)
        jq = JQuantConfig(scheme="fp", kv_cache_dtype=kv)
        jp = jllama.init_random_params(jcfg, jq, seed=0)
        cfg = ModelConfig(**TINY)
        qcfg = QuantConfig(scheme="fp", kv_cache_dtype=kv)
        out[kv] = ((jp, jcfg, jq), (llama.params_from_numpy(
            jckpt._flatten(jp)[0], cfg, qcfg, device="cpu"), cfg, qcfg))
    return out


def _prefix_twins(twin_params, waves, n_predict, kv="bf16", **kw):
    """Each wave of prompts submitted and run to the end, in turn, through
    the JAX ServingEngine and the port's with the same settings ``kw``.
    Returns {side: (tokens per request, prefix_stats or None)}."""
    (jp, jcfg, jq), (tp, cfg, qcfg) = twin_params[kv]
    out = {}
    for side in ("jax", "port"):
        if side == "jax":
            srv = JServing(jp, jcfg, jq, gcfg=JGen(n_predict=n_predict,
                                                   **GREEDY), **kw)
        else:
            srv = ServingEngine(tp, cfg, qcfg, gcfg=GenerationConfig(
                n_predict=n_predict, **GREEDY), device="cpu", **kw)
        toks = []
        for wave in waves:
            reqs = [srv.submit(p) for p in wave]
            srv.run()
            srv.done.clear()
            toks += [list(r.output_ids) for r in reqs]
        out[side] = (toks, getattr(srv, "prefix_stats", None))
    return out


SHARED_HEADER = np.arange(10, 110)


def test_prefix_cache_exact_across_shared_header(twin_params):
    """Two prompts sharing a 100-token header, one after the other through
    one slot: the second splices the cached prefix and prefills only its
    tail. Tokens and prefix_stats equal the JAX ServingEngine's, and the
    tokens equal the port's without the cache."""
    p1 = np.concatenate([SHARED_HEADER, [5, 9, 11]])
    p2 = np.concatenate([SHARED_HEADER, [7, 3, 2, 8]])
    waves = [[p1], [p2]]
    kw = dict(slots=1, prefix_cache_entries=2, prefix_min=16)
    got = _prefix_twins(twin_params, waves, 10, **kw)
    cold = _prefix_twins(twin_params, waves, 10, slots=1)["port"]
    assert got["port"] == got["jax"]
    assert got["port"][0] == cold[0]
    assert got["port"][1]["hits"] == 1 and got["port"][1]["hit_tokens"] == 100


def test_prefix_cache_partial_and_shorter_prompt(twin_params):
    """A prompt that is a strict prefix of a stored one still hits, capped
    at n - 1 tokens so its last chunk gives the first token's logits."""
    long = np.arange(10, 110)
    waves = [[long], [long[:60].copy()]]
    got = _prefix_twins(twin_params, waves, 8, slots=1,
                        prefix_cache_entries=2, prefix_min=16)
    assert got["port"] == got["jax"]
    assert got["port"][1]["hits"] == 1
    assert got["port"][1]["hit_tokens"] == 59
    cold = _prefix_twins(twin_params, waves, 8, slots=1)["port"]
    assert got["port"][0] == cold[0]


def test_prefix_cache_lru_eviction(twin_params):
    """One entry: a second header evicts the first, which then misses and
    is stored again (three stores, no hit), as in JAX."""
    pa, pb = np.arange(10, 90), np.arange(120, 200)
    got = _prefix_twins(twin_params, [[pa], [pb], [pa]], 4, slots=1,
                        prefix_cache_entries=1, prefix_min=16)
    assert got["port"] == got["jax"]
    assert got["port"][1] == {"hits": 0, "hit_tokens": 0, "stores": 3}


@pytest.mark.parametrize("paged,kv", [(True, "bf16"), (False, "int8"),
                                      (True, "int8")])
def test_prefix_cache_paged_and_int8_kv(twin_params, paged, kv):
    """Prefix reuse composes with the page pool and the int8 KV cache (its
    scales copied with the codes), two slots: tokens and prefix_stats
    equal JAX's, and the tokens equal the port's without the cache."""
    # (with the JAX test's tails [5, 9] / [7, 3, 2] the bf16 greedy tokens
    # of the port and JAX already part at p2's third token with no cache,
    # dense or paged: bf16 rounding in another order, ROADMAP Queue 3)
    p1 = np.concatenate([SHARED_HEADER, [5, 9, 11]])
    p2 = np.concatenate([SHARED_HEADER, [7, 3, 2, 8]])
    waves = [[p1], [p2]]
    got = _prefix_twins(twin_params, waves, 8, kv, slots=2, paged=paged,
                        prefix_cache_entries=2, prefix_min=16)
    cold = _prefix_twins(twin_params, waves, 8, kv, slots=2,
                         paged=paged)["port"]
    assert got["port"] == got["jax"]
    assert got["port"][1]["hits"] == 1
    assert got["port"][0] == cold[0]


def test_prefix_hit_bypasses_batched_admission(tiny):
    """Queue-head prompts that hit the cache take the single path (their
    stored prefix spliced in) instead of one batched fresh prefill, and
    give the tokens of a server without the cache."""
    p0 = np.concatenate([SHARED_HEADER, [1]])
    tails = [np.concatenate([SHARED_HEADER, [t, t + 1]]) for t in (5, 7)]
    g = GenerationConfig(n_predict=6, **GREEDY)

    def run(entries):
        srv = _srv(tiny, slots=4, gcfg=g, prefix_cache_entries=entries,
                   prefix_min=16)
        srv.submit(p0)
        srv.run()
        reqs = [srv.submit(p) for p in tails]
        srv.run()
        return srv, [r.output_ids for r in reqs]
    warm, got = run(2)
    cold, want = run(0)
    assert got == want
    assert warm.prefix_stats["hits"] == 2
    assert warm.tick_stats["batch_admits"] == 0
    assert cold.tick_stats["batch_admits"] == 1


def test_kmax_bucket_matches_jax():
    """The batch top_k bound picks the JAX package's bucket for every k."""
    from tinychatengine_tpu.runtime import serving as jserving
    from tinychatengine_tpu_torch.runtime import serving as tserving
    for k in range(-3, 2100):
        assert tserving._kmax_bucket(k) == jserving._kmax_bucket(k), k
