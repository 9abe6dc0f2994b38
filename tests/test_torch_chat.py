"""The port's chat CLI (chat.py) and speech glue (tools/speech.py) on the
CPU against the JAX package's: ``_gen_config`` for every registry name,
``shift_context``'s kept ids, and a two-turn greedy ``repl`` driven from a
StringIO that prints what JAX's prints, on the same tiny random weights
(JAX's ``init_random_params`` carried across by ``params_from_numpy``);
the CLI's ``--demo`` path; and the two speech cases of tests/test_tools.py
over the port's TINYCHAT_* names."""

import contextlib
import dataclasses
import io
import sys

import numpy as np
import pytest
import torch

from tinychatengine_tpu import chat as jchat
from tinychatengine_tpu.core.config import MODEL_REGISTRY
from tinychatengine_tpu.core.config import GenerationConfig as JGen
from tinychatengine_tpu.core.config import ModelConfig as JModelConfig
from tinychatengine_tpu.core.config import QuantConfig as JQuantConfig
from tinychatengine_tpu.generation.engine import Engine as JEngine
from tinychatengine_tpu.models import llama as jllama
from tinychatengine_tpu.tools import checkpoint as jckpt
from tinychatengine_tpu_torch import chat
from tinychatengine_tpu_torch.core.config import (GenerationConfig,
                                                  ModelConfig, QuantConfig)
from tinychatengine_tpu_torch.generation.engine import Engine
from tinychatengine_tpu_torch.models import llama
from tinychatengine_tpu_torch.tokenizers.byte_fallback import ByteTokenizer
from tinychatengine_tpu_torch.tools import speech

# "bytellama" picks the raw completion template, which fits a small context
TINY = dict(name="bytellama_tiny", family="llama", num_heads=4,
            num_kv_heads=2, num_layers=2, max_sqlen=128, embed_dim=128,
            hidden_dim=256, vocab_size=384, rms_norm_eps=1e-5)
GREEDY = dict(temp=0.0, n_predict=8, repeat_penalty=1.0, repeat_last_n=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    """A JAX Engine and the port's (on the CPU) on the same weights."""
    jcfg, jq = JModelConfig(**TINY), JQuantConfig(scheme="fp")
    jp = jllama.init_random_params(jcfg, jq, seed=0)
    cfg, q = ModelConfig(**TINY), QuantConfig(scheme="fp")
    tp = llama.params_from_numpy(jckpt._flatten(jp)[0], cfg, q, device="cpu")
    return ((JEngine(jp, jcfg, jq, batch=1, max_len=128), jcfg),
            (Engine(tp, cfg, q, batch=1, max_len=128, device="cpu"), cfg))


@pytest.mark.parametrize("name", sorted(MODEL_REGISTRY) + [
    "demo", "demo_llava", "Meta-Llama-3-8B", "tiny"])
def test_gen_config_matches_jax(name):
    assert dataclasses.asdict(chat._gen_config(name)) == \
        dataclasses.asdict(jchat._gen_config(name))


@pytest.mark.parametrize("n_keep", [0, 5, 100])
def test_shift_context_keeps_the_same_ids(engines, n_keep):
    """The kept head and tail equal JAX's, and the fresh cache holds them
    (its next-token logits equal a prefill of the kept ids)."""
    (jeng, _), (eng, _) = engines
    history = list(np.random.default_rng(0).integers(0, 256, 150))
    cache, start, kept = chat.shift_context(eng, history, n_keep)
    _, jstart, jkept = jchat.shift_context(jeng, history, n_keep)
    assert (start, [int(t) for t in kept]) == \
        (jstart, [int(t) for t in jkept])
    assert cache.length == start
    assert chat.shift_context(eng, [], n_keep)[1:] == (0, [])


def _repl_stdout(mod, engine, cfg, gcfg, turns, monkeypatch):
    """``mod.repl`` driven by ``turns`` on stdin: its stdout."""
    monkeypatch.setattr(sys, "stdin", io.StringIO("".join(
        t + "\n" for t in turns)))
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        mod.repl(engine, ByteTokenizer(), cfg, gcfg)
    return out.getvalue()


def test_two_turn_repl_prints_what_jax_prints(engines, monkeypatch):
    """Two greedy turns (the second continues the first's cache): the port
    prints JAX's text, and each turn's tokens are the port Engine's
    ``generate`` on the template-rendered ids at the conversation's
    position."""
    (jeng, jcfg), (eng, cfg) = engines
    turns = ["hello", "world"]
    seen = []
    orig = eng.generate

    def spy(ids, g, **kw):
        res = orig(ids, g, **kw)
        seen.append((np.asarray(ids).tolist(), kw["start"], res.tokens[0]))
        return res
    monkeypatch.setattr(eng, "generate", spy)
    got = _repl_stdout(chat, eng, cfg, GenerationConfig(**GREEDY), turns,
                       monkeypatch)
    want = _repl_stdout(jchat, jeng, jcfg, JGen(**GREEDY), turns,
                        monkeypatch)
    assert got == want
    assert got.count("ASSISTANT: ") == 2

    tok = ByteTokenizer()
    tmpl = chat.template_for(cfg.name)
    fresh = Engine(eng.params, cfg, eng.qcfg, batch=1, max_len=128,
                   device="cpu")
    cache, start = fresh.new_cache(), 0
    for i, (text, (ids, at, toks)) in enumerate(zip(turns, seen)):
        wrap = tmpl.first if i == 0 else tmpl.next
        want_ids = tok.encode(wrap.replace("{image}", "").format(input=text),
                              bos=(i == 0))
        assert ids == [want_ids] and at == start
        res = fresh.generate(np.asarray([want_ids], np.int32),
                             GenerationConfig(**GREEDY),
                             stop_token_ids=[tok.eos_id], cache=cache,
                             start=start)
        assert res.tokens[0] == toks
        cache, start = res.cache, start + len(want_ids) + len(toks)


def test_demo_cli_on_the_cpu(monkeypatch):
    """``main(["--demo", "--device", "cpu", ...])`` runs a turn of the
    tiny random W4A16 model and exits at the end of input."""
    monkeypatch.setattr(sys, "stdin", io.StringIO("hi\n"))
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        chat.main(["--demo", "--device", "cpu", "--n-predict", "4"])
    text = out.getvalue()
    assert "model demo" in text and text.count("ASSISTANT: ") == 1


def test_speech_degrades_without_binaries(monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.delenv("TINYCHAT_STT_CMD", raising=False)
    monkeypatch.delenv("TINYCHAT_TTS_CMD", raising=False)
    assert speech.available() == {"stt": False, "tts": False}
    sp = speech.Speaker()
    sp.feed("hello. ")  # must not raise
    sp.flush()


def test_speech_tts_invokes_command(tmp_path, monkeypatch):
    out = tmp_path / "spoken.txt"
    script = tmp_path / "fake_tts"
    script.write_text(f"#!/bin/sh\ncat >> {out}\n")
    script.chmod(0o755)
    monkeypatch.setenv("TINYCHAT_TTS_CMD", str(script))
    sp = speech.Speaker()
    sp.feed("Hello")
    sp.feed(" world.")   # sentence end → speak
    sp.feed(" And more")
    sp.flush()
    assert out.read_text() == "Hello world.And more"


def test_chip_smoke_http_phase_rehearses_on_cpu():
    """chip_smoke.py's phase 14 (``http_serving``) on the CPU at a tiny
    size (the card runs llama3_8b with 128000 ranks): the synthetic
    tokenizer, the dense and paged servers under the concurrent load with
    every check, the chat.py repl and the serve.py subprocess."""
    import chip_smoke

    cfg = ModelConfig(name="llama3_tiny", family="llama", num_heads=4,
                      num_kv_heads=2, num_layers=2, max_sqlen=1024,
                      embed_dim=256, hidden_dim=512, vocab_size=4352,
                      rms_norm_eps=1e-5)
    q = QuantConfig(scheme="w4a8", group_size=128)
    params = llama.init_random_params(cfg, q, seed=0, device="cpu")
    out = chip_smoke.http_serving(cfg, (params, q), dev="cpu", n_requests=6,
                                  n_predict=8, max_len=1024, n_ranks=4096)
    for mode in ("dense", "paged"):
        m = out[mode]
        assert m["tokens"] == 48 and m["metrics_tokens_eq"]
        assert m["all_eq_in_process"] == [6, 6]
        assert not any(m["launches"].values())  # the CPU runs plain versions
    assert out["dense"]["sse_eq"] and out["dense"]["stop_truncates"]
    assert out["dense"]["logprobs_eq"]
    assert out["dense"]["embedding_err"] <= chip_smoke.EMB_CARD_TOL
    assert out["chat"]["eq_engine"] and out["chat"]["tokens"] == [32, 32]
    assert out["serve_cli"]["eq_engine"]
    assert out["serve_cli"]["exit_code"] == 0
