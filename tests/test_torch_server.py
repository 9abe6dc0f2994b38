"""The port's OpenAI-compatible REST server (runtime/server.py) on the CPU,
held to the JAX package's server on the same requests: CPU twins of the 24
cases of tests/test_server.py. The same tiny random model (JAX's
``init_random_params`` carried across by ``params_from_numpy``) serves on
both sides. Greedy texts and token ids are exact (a parting only at an
exact tie of JAX's logits); logprobs within ``LP_TOL`` of the port's own
teacher-forced forward and within ``LP_JAX_TOL`` of the JAX server's;
embeddings within ``EMB_TOL``; 400 bodies, ``build_gcfg`` and the
``/metrics`` names equal. Every HTTP call has a timeout."""

import base64
import dataclasses
import http.client
import io
import json
import socket
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from tinychatengine_tpu.core.config import GenerationConfig as JGen
from tinychatengine_tpu.core.config import ModelConfig as JModelConfig
from tinychatengine_tpu.core.config import QuantConfig as JQuantConfig
from tinychatengine_tpu.generation.chat_templates import \
    ChatTemplate as JChatTemplate
from tinychatengine_tpu.generation.chat_templates import \
    template_for as jtemplate_for
from tinychatengine_tpu.models import clip as jclip
from tinychatengine_tpu.models import llama as jllama
from tinychatengine_tpu.runtime import server as jserver
from tinychatengine_tpu.runtime.serving import ServingEngine as JServing
from tinychatengine_tpu.serve import build_parser as jbuild_parser
from tinychatengine_tpu.tools import checkpoint as jckpt
from tinychatengine_tpu_torch.core.config import (GenerationConfig,
                                                  ModelConfig, QuantConfig)
from tinychatengine_tpu_torch.generation import vlm
from tinychatengine_tpu_torch.generation.chat_templates import (ChatTemplate,
                                                                template_for)
from tinychatengine_tpu_torch.generation.engine import Engine
from tinychatengine_tpu_torch.models import clip, llama
from tinychatengine_tpu_torch.runtime import server as tserver
from tinychatengine_tpu_torch.runtime.server import (InferenceServer,
                                                     RequestError, build_gcfg,
                                                     render_messages)
from tinychatengine_tpu_torch.runtime.serving import ServingEngine
from tinychatengine_tpu_torch.tokenizers.byte_fallback import ByteTokenizer

# the JAX test's tiny model: vocab 384 >= ByteTokenizer's 258 ids; pad ids
# decode to "" (harmless in text comparisons, visible in the ids)
TINY = dict(name="tiny", family="llama", num_heads=4, num_kv_heads=2,
            num_layers=2, max_sqlen=128, embed_dim=128, hidden_dim=256,
            vocab_size=384, rms_norm_eps=1e-5)
CLIP = dict(name="clip_tiny", family="clip", num_heads=4, num_kv_heads=4,
            num_layers=2, max_sqlen=0, embed_dim=64, hidden_dim=128,
            vocab_size=0, image_size=28, patch_size=14, mmproj_dim=128)
WRAPS = dict(first="S: {input}\nA: ", next="H: {input}\nA: ")
GREEDY = dict(temp=0.0, n_predict=8, repeat_penalty=1.0, repeat_last_n=1)
# logprobs against log-softmax of the port's raw forward: JAX's own test's
# bound (tests/test_torch_serving_spec.py)
LP_TOL = 1e-3
# against the JAX server's: the two forwards round bf16 activations in
# another order (ROADMAP's "Tolerances found": logits within 2e-2 of max
# |logit|); read 4.0e-3 at one token of "ab" and of the "hey" chat
LP_JAX_TOL = 2e-2
# embeddings: mean-pooled bf16 hidden states of the 2-layer forward, unit
# norm (ROADMAP's "Tolerances found": the forward within 2e-2)
EMB_TOL = 2e-2
TIMEOUT = 60.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """(JAX params, cfg, qcfg) and the port's copy of the same weights."""
    jcfg, jq = JModelConfig(**TINY), JQuantConfig(scheme="fp")
    jp = jllama.init_random_params(jcfg, jq, seed=0)
    cfg, q = ModelConfig(**TINY), QuantConfig(scheme="fp")
    tp = llama.params_from_numpy(jckpt._flatten(jp)[0], cfg, q, device="cpu")
    return (jp, jcfg, jq), (tp, cfg, q)


def _start(side, params, clip_ctx=None, name="tiny"):
    """An InferenceServer of ``side`` ("port" on the CPU, or "jax") on the
    JAX test's settings: 2 slots, greedy, the short wraps."""
    p, cfg, q = params
    if side == "port":
        engine = ServingEngine(p, cfg, q, slots=2,
                               gcfg=GenerationConfig(**GREEDY), device="cpu")
        server = InferenceServer(engine, ByteTokenizer(), model_name=name,
                                 template=ChatTemplate(**WRAPS),
                                 request_timeout=TIMEOUT,
                                 **(clip_ctx or {}))
    else:
        engine = JServing(p, cfg, q, slots=2, gcfg=JGen(**GREEDY))
        server = jserver.InferenceServer(
            engine, ByteTokenizer(), model_name=name,
            template=JChatTemplate(**WRAPS), request_timeout=TIMEOUT,
            **(clip_ctx or {}))
    server.start(port=0)
    return server


@pytest.fixture(scope="module")
def served(models):
    """{"port": server, "jax": server} on the same weights."""
    out = {"port": _start("port", models[1]), "jax": _start("jax", models[0])}
    yield out
    for s in out.values():
        s.close()


@pytest.fixture(scope="module")
def served_vlm(models):
    """Both sides with the same tiny CLIP tower (one seed gives both
    packages the same weights)."""
    jccfg, ccfg = JModelConfig(**CLIP), ModelConfig(**CLIP)
    ctx = {"port": dict(clip_params=clip.init_random_params(
               ccfg, seed=0, device="cpu"), clip_cfg=ccfg),
           "jax": dict(clip_params=jclip.init_random_params(jccfg, seed=0),
                       clip_cfg=jccfg)}
    out = {side: _start(side, models[i], ctx[side], name="tiny-vlm")
           for i, side in ((1, "port"), (0, "jax"))}
    yield out, ctx["port"]
    for s in out.values():
        s.close()


def _post(server, path, body, timeout=TIMEOUT):
    conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                      timeout=timeout)
    conn.request("POST", path, body if isinstance(body, str)
                 else json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, json.loads(data)


def _get(server, path):
    conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                      timeout=TIMEOUT)
    conn.request("GET", path)
    resp = conn.getresponse()
    data = resp.read().decode()
    ctype = resp.getheader("Content-Type")
    conn.close()
    return resp.status, (data if ctype.startswith("text/plain")
                         else json.loads(data))


def _sse_events(server, path, body):
    """POST with stream=true; the decoded SSE payloads, which must end
    with [DONE]."""
    conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                      timeout=TIMEOUT)
    conn.request("POST", path, json.dumps({**body, "stream": True}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.getheader("Content-Type") == "text/event-stream"
    raw = resp.read().decode()
    conn.close()
    events, saw_done = [], False
    for line in raw.split("\n\n"):
        line = line.strip()
        if not line:
            continue
        assert line.startswith("data: "), line
        payload = line[len("data: "):]
        if payload == "[DONE]":
            saw_done = True
        else:
            assert not saw_done, "payload after [DONE]"
            events.append(json.loads(payload))
    assert saw_done, "stream did not terminate with [DONE]"
    return events


def _bare(out):
    """A response without its per-call fields (id, created)."""
    if isinstance(out, dict):
        return {k: _bare(v) for k, v in out.items()
                if k not in ("id", "created")}
    if isinstance(out, list):
        return [_bare(v) for v in out]
    return out


def _last_ids(server):
    return [int(t) for t in server.engine.done[-1].output_ids]


def _both(served, path, body):
    """The same request to each side, one after the other: {side: (status,
    body without id/created, the last finished request's ids)}."""
    out = {}
    for side in ("port", "jax"):
        st, body_out = _post(served[side], path, body)
        ids = _last_ids(served[side]) if st == 200 and "choices" in \
            body_out else None
        out[side] = (st, _bare(body_out), ids)
    return out


def _solo(params, prompt_ids, n_predict):
    """The port's Engine alone on the prompt: (text, tokens)."""
    p, cfg, q = params
    eng = Engine(p, cfg, q, batch=1, max_len=cfg.max_sqlen, device="cpu")
    g = GenerationConfig(**{**GREEDY, "n_predict": n_predict})
    toks = eng.generate(np.asarray(prompt_ids, np.int32)[None, :],
                        g).tokens[0]
    return ByteTokenizer().decode(toks), list(toks)


# a greedy parting between the port and JAX is allowed only where JAX's own
# logits hold an exact tie for the top token ("bravo bravo" ties at its
# third token: top-2 margin 0.0 in f32; the port's logits, rounded in
# another order, break it)
TIE_TOL = 1e-6


def _same_greedy(jmodel, prompt_ids, got, want):
    """``got`` (the port's greedy tokens) equals ``want`` (JAX's), or they
    part at a step where JAX's top-2 logit margin is within TIE_TOL."""
    if got == want:
        return
    k = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    jp, jcfg, _ = jmodel
    from tinychatengine_tpu.generation import kv_cache as jkvc
    seq = np.asarray(list(prompt_ids) + want[:k], np.int32)[None]
    cache = jkvc.init_cache(jcfg.num_layers, 1, jcfg.max_sqlen,
                            jcfg.num_kv_heads, jcfg.head_dim)
    logits, _ = jllama.forward(jp, jcfg, seq, cache, 0)
    top = np.sort(np.asarray(logits[0], np.float32))[::-1]
    assert top[0] - top[1] <= TIE_TOL, (k, got, want, top[:2])


def _stop_char(text):
    """A printable non-space character from the middle of ``text``."""
    printable = [ch for ch in text if ch.isprintable() and ch != " "]
    assert len(set(text)) >= 2 and printable, \
        f"random model produced no usable stop char: {text!r}"
    return printable[len(printable) // 2]


def test_health_and_models(served):
    for path in ("/health", "/v1/models"):
        st, got = _get(served["port"], path)
        want = _get(served["jax"], path)
        assert (st, got) == want
    assert got["data"][0]["id"] == "tiny"
    conn = http.client.HTTPConnection("127.0.0.1", served["port"].port,
                                      timeout=TIMEOUT)
    conn.request("GET", "/nope")
    resp = conn.getresponse()
    assert resp.status == 404 and "error" in json.loads(resp.read())
    conn.close()


def test_completion_matches_solo_engine(served, models):
    ids = ByteTokenizer().encode("hello", bos=True)
    want_text, want_toks = _solo(models[1], ids, 8)
    got = _both(served, "/v1/completions", {
        "prompt": "hello", "max_tokens": 8, "ignore_eos": True})
    assert got["port"] == got["jax"]
    st, out, toks = got["port"]
    assert st == 200 and out["object"] == "text_completion"
    c = out["choices"][0]
    assert c["text"] == want_text and toks == want_toks
    assert c["finish_reason"] == "length"
    assert out["usage"] == {"prompt_tokens": len(ids),
                            "completion_tokens": len(want_toks),
                            "total_tokens": len(ids) + len(want_toks)}


def test_completion_pretokenized_prompt(served, models):
    ids = [256, 104, 105]  # bos + "hi"
    want_text, want_toks = _solo(models[1], ids, 6)
    got = _both(served, "/v1/completions", {
        "prompt": ids, "max_tokens": 6, "ignore_eos": True})
    assert got["port"] == got["jax"]
    assert got["port"][1]["choices"][0]["text"] == want_text
    assert got["port"][2] == want_toks


def test_chat_completion_wraps_template(served, models):
    msgs = [{"role": "user", "content": "hi"}]
    text = render_messages(ChatTemplate(**WRAPS), msgs)
    assert text == jserver.render_messages(JChatTemplate(**WRAPS), msgs)
    want_text, want_toks = _solo(models[1],
                                 ByteTokenizer().encode(text, bos=True), 8)
    got = _both(served, "/v1/chat/completions", {
        "messages": msgs, "max_tokens": 8, "ignore_eos": True})
    assert got["port"] == got["jax"]
    st, out, toks = got["port"]
    assert st == 200 and out["object"] == "chat.completion"
    msg = out["choices"][0]["message"]
    assert msg == {"role": "assistant", "content": want_text}
    assert toks == want_toks


def test_streaming_sse_matches_nonstream(served):
    body = {"prompt": "stream me", "max_tokens": 8, "ignore_eos": True}
    _, want = _post(served["port"], "/v1/completions", body)
    events = _sse_events(served["port"], "/v1/completions", body)
    assert _bare(events) == _bare(_sse_events(served["jax"],
                                              "/v1/completions", body))
    assert all(e["object"] == "text_completion.chunk" for e in events)
    text = "".join(e["choices"][0]["text"] for e in events)
    assert text == want["choices"][0]["text"]
    assert events[-1]["choices"][0]["finish_reason"] == "length"
    assert all(e["choices"][0]["finish_reason"] is None for e in events[:-1])


def test_streaming_chat_deltas(served):
    body = {"messages": [{"role": "user", "content": "hi"}],
            "max_tokens": 6, "ignore_eos": True}
    _, want = _post(served["port"], "/v1/chat/completions", body)
    events = _sse_events(served["port"], "/v1/chat/completions", body)
    assert _bare(events) == _bare(_sse_events(served["jax"],
                                              "/v1/chat/completions", body))
    assert events[0]["choices"][0]["delta"] == {"role": "assistant"}
    text = "".join(e["choices"][0]["delta"].get("content", "")
                   for e in events[1:])
    assert text == want["choices"][0]["message"]["content"]


def _wait_idle(server, seconds=30.0):
    deadline = time.monotonic() + seconds
    e = server.engine
    while time.monotonic() < deadline and (
            e.n_active or e.queue or e._pending is not None):
        time.sleep(0.05)
    return e.n_active == 0


def test_stop_string_truncates_and_frees_slot(served, models):
    ids = ByteTokenizer().encode("stop test", bos=True)
    full, _ = _solo(models[1], ids, 16)
    stop = _stop_char(full)
    got = _both(served, "/v1/completions", {
        "prompt": "stop test", "max_tokens": 16, "ignore_eos": True,
        "stop": stop})
    assert got["port"][:2] == got["jax"][:2]
    st, out, _ = got["port"]
    c = out["choices"][0]
    assert st == 200 and c["finish_reason"] == "stop"
    assert c["text"] == full[:full.index(stop)]
    # the cancel must actually free the engine slot (no zombie decode)
    assert _wait_idle(served["port"])


def test_concurrent_clients_match_solo(served, models):
    """Four clients at once on the port (two slots: admissions, bursts and
    a queue interleave); each text and token list equals the port's solo
    Engine and the JAX server's answer to the same request alone."""
    prompts = ["alpha", "bravo bravo", "c", "delta prompt four"]
    results = [None] * len(prompts)

    def worker(i):
        results[i] = _post(served["port"], "/v1/completions", {
            "prompt": prompts[i], "max_tokens": 8, "ignore_eos": True})

    ts = [threading.Thread(target=worker, args=(i,))
          for i in range(len(prompts))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in ts)
    by_prompt = {tuple(r.prompt_ids): [int(t) for t in r.output_ids]
                 for r in served["port"].engine.done[-len(prompts):]}
    for i, p in enumerate(prompts):
        ids = ByteTokenizer().encode(p, bos=True)
        want_text, want_toks = _solo(models[1], ids, 8)
        st, out = results[i]
        assert st == 200 and out["choices"][0]["text"] == want_text, i
        assert by_prompt[tuple(ids)] == want_toks
        _post(served["jax"], "/v1/completions", {
            "prompt": p, "max_tokens": 8, "ignore_eos": True})
        _same_greedy(models[0], ids, want_toks, _last_ids(served["jax"]))


def test_24_clients_connecting_at_once_are_all_answered(served):
    """24 clients connect at once (scripts/bench_serving.py main_http's
    burst): the accept backlog of 128 takes them all (socketserver's
    default of 5 reset the overflow), and each gets its 200."""
    server = served["port"]
    assert server._httpd.request_queue_size == 128
    assert server._httpd.request_queue_size == \
        served["jax"]._httpd.request_queue_size
    results, barrier = [None] * 24, threading.Barrier(24)

    def client(i):
        barrier.wait(timeout=TIMEOUT)
        results[i] = _post(server, "/v1/completions", {
            "prompt": [256, 100 + i], "max_tokens": 2, "ignore_eos": True})
    ts = [threading.Thread(target=client, args=(i,)) for i in range(24)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in ts)
    assert all(r is not None and r[0] == 200 for r in results), results
    assert sum(r[1]["usage"]["completion_tokens"] for r in results) == 48


def test_per_request_sampling_params(served):
    """Seeded sampling through the HTTP layer is reproducible and distinct
    seeds diverge (the port draws from torch generators, so sampled texts
    are not JAX's; the per-request config is, field for field)."""
    body = {"prompt": "sample", "max_tokens": 8, "ignore_eos": True,
            "temperature": 1.0, "top_k": 0, "top_p": 1.0, "seed": 7}
    assert dataclasses.asdict(build_gcfg(served["port"], body)) == \
        dataclasses.asdict(jserver.build_gcfg(served["jax"], body))
    _, a = _post(served["port"], "/v1/completions", body)
    _, b = _post(served["port"], "/v1/completions", body)
    assert a["choices"][0]["text"] == b["choices"][0]["text"]
    _, c = _post(served["port"], "/v1/completions", {**body, "seed": 8})
    assert c["choices"][0]["text"] != a["choices"][0]["text"]


BAD = [
    ("/v1/completions", {"prompt": []}),                    # empty prompt
    ("/v1/completions", {"prompt": "x", "n": 0}),           # bad n
    ("/v1/completions", {"prompt": "x", "max_tokens": 0}),  # bad budget
    ("/v1/completions", {"prompt": "x", "stop": 5}),        # bad stop
    ("/v1/completions", {"prompt": "x", "temperature": "hot"}),
    ("/v1/completions", {"prompt": "x" * 4096}),            # too long
    ("/v1/completions", {"prompt": {"a": 1}}),              # bad type
    ("/v1/chat/completions", {"messages": []}),
    ("/v1/chat/completions", {"messages": [{"role": "tool",
                                            "content": "x"}]}),
    ("/v1/chat/completions", {"messages": [{"role": "system",
                                            "content": "only sys"}]}),
    ("/v1/completions", "{not json"),
]


def test_bad_requests_are_400s(served):
    for path, body in BAD:
        got = _post(served["port"], path, body)
        assert got[0] == 400 and "error" in got[1], (path, body, got)
        assert got == _post(served["jax"], path, body), (path, body)


GCFG_BODIES = [
    {"prompt": "x", "max_tokens": 4},
    {"temperature": 0.5},
    {"temperature": 0.8, "top_p": 0.9, "top_k": 12, "seed": 3,
     "frequency_penalty": 0.5, "presence_penalty": -0.5,
     "repetition_penalty": 1.2, "repeat_last_n": 16},
    {"mirostat": 2, "mirostat_tau": 4.0, "mirostat_eta": 0.2},
    {"logit_bias": {"5": -100, "7": 2.5}},
]


def test_build_gcfg_returns_none_for_defaults(served):
    srv, jsrv = served["port"], served["jax"]
    assert build_gcfg(srv, GCFG_BODIES[0]) is None
    assert jserver.build_gcfg(jsrv, GCFG_BODIES[0]) is None
    for body in GCFG_BODIES[1:]:
        assert dataclasses.asdict(build_gcfg(srv, body)) == \
            dataclasses.asdict(jserver.build_gcfg(jsrv, body)), body
    assert build_gcfg(srv, {"temperature": 0.5}).temp == 0.5
    for body in ({"temperature": -3.0}, {"logit_bias": {"x": "y"}},
                 {"best_of": 3}):
        with pytest.raises(RequestError) as mine:
            build_gcfg(srv, body)
        with pytest.raises(jserver.RequestError) as theirs:
            jserver.build_gcfg(jsrv, body)
        assert str(mine.value) == str(theirs.value)


def test_render_messages_multiturn():
    msgs = [{"role": "system", "content": "SYS"},
            {"role": "user", "content": "u1"},
            {"role": "assistant", "content": "a1"},
            {"role": "user", "content": [{"type": "text", "text": "u2"}]}]
    tpl = template_for("tiny")
    text = render_messages(tpl, msgs)
    assert text == jserver.render_messages(jtemplate_for("tiny"), msgs)
    assert text.startswith("SYS\n\n")
    assert tpl.first.replace("{image}", "").replace("{input}", "u1") in text
    assert "a1\n" in text
    assert tpl.next.replace("{image}", "").replace("{input}", "u2") in text
    with pytest.raises(RequestError):
        render_messages(tpl, [{"role": "assistant", "content": "no user"}])


def test_client_disconnect_mid_stream_cancels(served):
    """Closing the socket mid-SSE propagates BrokenPipe → engine cancel:
    the slot frees without decoding to max_tokens."""
    server = served["port"]
    body = json.dumps({"prompt": "disconnect me", "max_tokens": 96,
                       "ignore_eos": True, "stream": True})
    s = socket.create_connection(("127.0.0.1", server.port), timeout=TIMEOUT)
    s.sendall((f"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
               f"Content-Type: application/json\r\n"
               f"Content-Length: {len(body)}\r\n\r\n{body}").encode())
    buf = b""
    while b"text_completion.chunk" not in buf:
        chunk = s.recv(4096)
        assert chunk, "server closed early"
        buf += chunk
    s.close()
    assert _wait_idle(server, TIMEOUT), "slot not freed after disconnect"
    req = server.engine.done[-1]
    assert req.finish_reason == "cancelled"
    assert len(req.output_ids) < 96, "request ran to completion anyway"


def _metric_lines(text):
    samples = {}
    for line in text.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        name, val = line.rsplit(" ", 1)
        samples[name] = float(val)  # every sample must parse
    return samples


def test_metrics_endpoint(served):
    """The Prometheus exposition: the JAX server's names, HELP and TYPE
    lines; counters advance with completed requests."""
    server = served["port"]
    before = dict(server.stats["requests_total"])
    body = {"prompt": "metrics", "max_tokens": 4, "ignore_eos": True}
    for side in ("port", "jax"):
        _post(served[side], "/v1/completions", body)
    st, text = _get(server, "/metrics")
    _, jtext = _get(served["jax"], "/metrics")
    assert st == 200
    comments = [ln for ln in text.splitlines() if ln.startswith("#")]
    assert comments == [ln for ln in jtext.splitlines() if ln.startswith("#")]
    metrics = _metric_lines(text)
    base = {n.split("{")[0] for n in metrics}
    assert base == {n.split("{")[0] for n in _metric_lines(jtext)}
    assert metrics["tce_slots"] == 2
    assert metrics["tce_generation_tokens_total"] >= 4
    assert metrics['tce_requests_total{reason="length"}'] >= \
        before.get("length", 0) + 1
    assert metrics["tce_ttft_seconds_count"] >= 1
    assert metrics["tce_ttft_seconds_sum"] > 0
    assert metrics["tce_generation_tokens_total"] == \
        server.stats["tokens_generated_total"]


def _oracle(model, prompt_ids, tokens):
    """log-softmax of the port's eager forward, teacher-forced over the
    prompt and the emitted tokens: [len(tokens), V]."""
    from tinychatengine_tpu_torch.generation import kv_cache as kvc
    tp, cfg, _ = model
    cache = kvc.init_cache(cfg.num_layers, 1, cfg.max_sqlen,
                           cfg.num_kv_heads, cfg.head_dim, device="cpu")
    ids = torch.as_tensor(list(prompt_ids) + list(tokens[:-1]))[None]
    with torch.inference_mode():
        logits, _ = llama.forward(tp, cfg, ids, cache, 0, full_logits=True)
    return torch.log_softmax(logits[0, len(prompt_ids) - 1:].float(),
                             -1).numpy()


def _held_logprobs(lps, tokens, oracle, jlps):
    """Each served logprob within LP_TOL of the port's forward and within
    LP_JAX_TOL of the JAX server's."""
    assert len(lps) == len(tokens) == len(jlps)
    np.testing.assert_allclose(
        lps, [oracle[t, tok] for t, tok in enumerate(tokens)], atol=LP_TOL)
    np.testing.assert_allclose(lps, jlps, atol=LP_JAX_TOL)


def _close_logprobs(got, want, oracle, tokens):
    """Completions logprobs: JAX's tokens, offsets and top-k keys, the
    logprobs held by ``_held_logprobs``."""
    assert got["tokens"] == want["tokens"]
    assert got["text_offset"] == want["text_offset"]
    n = len(got["token_logprobs"])
    _held_logprobs(got["token_logprobs"], tokens[:n], oracle,
                   want["token_logprobs"])
    for a, b in zip(got["top_logprobs"] or [], want["top_logprobs"] or []):
        assert list(a) == list(b)
        np.testing.assert_allclose(list(a.values()), list(b.values()),
                                   atol=LP_JAX_TOL)


def test_completions_logprobs(served, models):
    body = {"prompt": "ab", "max_tokens": 4, "ignore_eos": True,
            "logprobs": 2}
    got = _both(served, "/v1/completions", body)
    assert got["port"][2] == got["jax"][2]
    lp = got["port"][1]["choices"][0]["logprobs"]
    prompt = ByteTokenizer().encode("ab", bos=True)
    _close_logprobs(lp, got["jax"][1]["choices"][0]["logprobs"],
                    _oracle(models[1], prompt, got["port"][2]),
                    got["port"][2])
    assert len(lp["tokens"]) == len(lp["token_logprobs"]) == \
        len(lp["top_logprobs"]) == len(lp["text_offset"]) == 4
    assert lp["text_offset"][0] == 0
    assert all(isinstance(v, float) and v <= 1e-6
               for v in lp["token_logprobs"])
    for chosen_lp, top in zip(lp["token_logprobs"], lp["top_logprobs"]):
        assert 1 <= len(top) <= 2
        assert abs(max(top.values()) - chosen_lp) < 1e-5  # greedy == argmax


def test_chat_logprobs_and_stream_rejection(served, models):
    msgs = [{"role": "user", "content": "hey"}]
    got = _both(served, "/v1/chat/completions", {
        "messages": msgs, "max_tokens": 3, "ignore_eos": True,
        "logprobs": True, "top_logprobs": 2})
    assert got["port"][2] == got["jax"][2]
    content = got["port"][1]["choices"][0]["logprobs"]["content"]
    jcontent = got["jax"][1]["choices"][0]["logprobs"]["content"]
    assert len(content) == 3
    prompt = ByteTokenizer().encode(
        render_messages(ChatTemplate(**WRAPS), msgs), bos=True)
    _held_logprobs([e["logprob"] for e in content], got["port"][2],
                   _oracle(models[1], prompt, got["port"][2]),
                   [e["logprob"] for e in jcontent])
    for entry, jentry in zip(content, jcontent):
        assert set(entry) == {"token", "logprob", "bytes", "top_logprobs"}
        assert entry["token"] == jentry["token"]
        assert entry["bytes"] == jentry["bytes"]
        assert [t["token"] for t in entry["top_logprobs"]] == \
            [t["token"] for t in jentry["top_logprobs"]]
        assert len(entry["top_logprobs"]) == 2
        assert entry["logprob"] <= 1e-6
    for body in ({"prompt": "x", "max_tokens": 2, "stream": True,
                  "logprobs": 1},
                 {"prompt": "x", "max_tokens": 2, "logprobs": 99}):
        st, out = _post(served["port"], "/v1/completions", body)
        assert st == 400
        assert (st, out) == _post(served["jax"], "/v1/completions", body)
    assert "stream" in _post(served["port"], "/v1/completions",
                             {"prompt": "x", "max_tokens": 2, "stream": True,
                              "logprobs": 1})[1]["error"]["message"]


def test_embeddings_endpoint(served):
    """Mean-pooled normalized embeddings within EMB_TOL of the JAX
    server's: unit norm, deterministic, distinct inputs differ, usage
    counted, an empty input refused."""
    body = {"input": ["hello world", "completely different"]}
    st, out = _post(served["port"], "/v1/embeddings", body)
    _, jout = _post(served["jax"], "/v1/embeddings", body)
    assert st == 200
    assert [d["index"] for d in out["data"]] == [0, 1]
    assert out["usage"] == jout["usage"] and out["usage"]["prompt_tokens"] > 0
    e0, e1 = (np.asarray(d["embedding"], np.float32) for d in out["data"])
    for got, want in zip((e0, e1), jout["data"]):
        assert float(np.abs(got - np.asarray(want["embedding"])).max()) \
            <= EMB_TOL
        assert abs(float(np.linalg.norm(got)) - 1.0) < 1e-3
    assert float(np.abs(e0 - e1).max()) > 1e-4
    st2, out2 = _post(served["port"], "/v1/embeddings",
                      {"input": "hello world"})
    assert st2 == 200
    e0b = np.asarray(out2["data"][0]["embedding"], np.float32)
    assert float(np.abs(e0 - e0b).max()) < 1e-5
    assert _post(served["port"], "/v1/embeddings", {"input": []}) == \
        _post(served["jax"], "/v1/embeddings", {"input": []})


def test_device_work_runs_on_the_scheduler_thread(served):
    """Embeddings and image encodes are scheduler commands: the function
    runs on the scheduler thread between steps, and its exception is
    raised on the caller's."""
    server = served["port"]
    assert server.run_on_scheduler(
        lambda: threading.current_thread().name) == "tce-scheduler"
    with pytest.raises(ZeroDivisionError):
        server.run_on_scheduler(lambda: 1 / 0)
    seen = []
    orig = tserver._embed_step

    def spy(e, ids):
        seen.append(threading.current_thread().name)
        return orig(e, ids)
    tserver._embed_step = spy
    try:
        st, _ = _post(server, "/v1/embeddings", {"input": ["a", "b"]})
    finally:
        tserver._embed_step = orig
    assert st == 200 and seen == ["tce-scheduler"] * 2


def test_logprobs_align_with_stop_truncated_text(served, models):
    ids = ByteTokenizer().encode("stop lp", bos=True)
    full, _ = _solo(models[1], ids, 16)
    stop = _stop_char(full)
    got = _both(served, "/v1/completions", {
        "prompt": "stop lp", "max_tokens": 16, "ignore_eos": True,
        "stop": stop, "logprobs": 1})
    st, out, _ = got["port"]
    assert st == 200, out
    c = out["choices"][0]
    jc = got["jax"][1]["choices"][0]
    assert c["text"] == jc["text"] and c["finish_reason"] == "stop"
    lp = c["logprobs"]
    toks = got["port"][2]
    _close_logprobs(lp, jc["logprobs"], _oracle(models[1], ids, toks), toks)
    assert "".join(lp["tokens"]) == c["text"]
    assert len(lp["tokens"]) == len(lp["token_logprobs"]) \
        == len(lp["text_offset"])
    for off, piece in zip(lp["text_offset"], lp["tokens"]):
        assert c["text"][off:off + len(piece)] == piece


def test_n_choices(served):
    got = _both(served, "/v1/completions", {
        "prompt": "multi", "max_tokens": 6, "ignore_eos": True, "n": 2})
    assert got["port"][:2] == got["jax"][:2]
    out = got["port"][1]
    assert [c["index"] for c in out["choices"]] == [0, 1]
    assert out["choices"][0]["text"] == out["choices"][1]["text"]  # greedy
    assert out["usage"]["completion_tokens"] == 12

    st, out = _post(served["port"], "/v1/completions", {
        "prompt": "multi", "max_tokens": 8, "ignore_eos": True, "n": 3,
        "temperature": 1.2, "seed": 7, "top_k": 0,
        "repetition_penalty": 1.0, "repeat_last_n": 1})
    assert st == 200, out
    texts = [c["text"] for c in out["choices"]]
    assert len(texts) == 3
    assert len(set(texts)) >= 2, f"seeded choices all identical: {texts!r}"
    for body in ({"prompt": "x", "max_tokens": 2, "n": 2, "stream": True},
                 {"prompt": "x", "max_tokens": 2, "n": 0},
                 {"prompt": "x", "max_tokens": 2, "best_of": 3}):
        st, out = _post(served["port"], "/v1/completions", body)
        assert st == 400
        assert (st, out) == _post(served["jax"], "/v1/completions", body)


# ---- vision (image_url content parts) -----------------------------------------

def _png_data_url(seed=0, size=30):
    rng = np.random.default_rng(seed)
    img = Image.fromarray(
        rng.integers(0, 256, (size, size, 3), dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return ("data:image/png;base64,"
            + base64.b64encode(buf.getvalue()).decode())


def _image_chat(url, text="what is this?", max_tokens=8):
    return {"messages": [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": url}},
        {"type": "text", "text": text}]}],
        "max_tokens": max_tokens, "ignore_eos": True}


def test_chat_image_url_matches_engine_vlm(served_vlm, models):
    """An image_url chat request returns the JAX server's text and ids,
    and what the port's library VLM path (encode + splice + solo Engine)
    gives for the same image; another image gives other text."""
    servers, ctx = served_vlm
    url = _png_data_url(seed=3)
    got = _both(servers, "/v1/chat/completions", _image_chat(url))
    assert got["port"] == got["jax"]
    st, out, toks = got["port"]
    assert st == 200, out

    tp, cfg, q = models[1]
    img = tserver._decode_image_data_url(url)
    emb_img = vlm.encode_image(ctx["clip_params"], ctx["clip_cfg"], img)
    prompt_text = WRAPS["first"].replace(
        "{input}", vlm.IMAGE_MARKER + "what is this?")
    ids, emb = vlm.build_multimodal_inputs_multi(
        ByteTokenizer(), tp.embed, prompt_text, [emb_img])
    assert out["usage"]["prompt_tokens"] == len(ids)
    eng = Engine(tp, cfg, q, batch=1, max_len=cfg.max_sqlen, device="cpu")
    want = eng.generate(ids[None], GenerationConfig(**GREEDY),
                        input_embeds=torch.from_numpy(emb)[None]).tokens[0]
    assert toks == want
    assert out["choices"][0]["message"]["content"] == \
        ByteTokenizer().decode(want)

    st2, out2 = _post(servers["port"], "/v1/chat/completions",
                      _image_chat(_png_data_url(9)))
    assert st2 == 200
    assert out2["choices"][0]["message"]["content"] != \
        out["choices"][0]["message"]["content"]


def test_chat_image_streaming_and_two_images(served_vlm):
    servers, _ = served_vlm
    body = {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "compare "},
        {"type": "image_url", "image_url": {"url": _png_data_url(1)}},
        {"type": "text", "text": " and "},
        {"type": "image_url", "image_url": {"url": _png_data_url(2)}},
    ]}], "max_tokens": 6, "ignore_eos": True}
    events = _sse_events(servers["port"], "/v1/chat/completions", body)
    assert events[-1]["choices"][0]["finish_reason"] == "length"
    assert _bare(events) == _bare(_sse_events(servers["jax"],
                                              "/v1/chat/completions", body))


def test_chat_image_validation(served_vlm, served):
    servers, _ = served_vlm
    cases = [(servers, {"messages": [{"role": "user", "content": [
                 {"type": "image_url",
                  "image_url": {"url": "https://x.test/a.png"}},
                 {"type": "text", "text": "hi"}]}], "max_tokens": 4},
              "data:"),
             (servers, {"messages": [{"role": "user", "content": [
                 {"type": "image_url",
                  "image_url": {"url": "data:image/png;base64,!!!"}}]}],
                 "max_tokens": 4}, "decode"),
             # a server built without a vision encoder refuses image parts
             (served, _image_chat(_png_data_url(), "hi", 4), "not enabled")]
    for pair, body, needle in cases:
        st, out = _post(pair["port"], "/v1/chat/completions", body)
        assert st == 400 and needle in out["error"]["message"]
        assert (st, out) == _post(pair["jax"], "/v1/chat/completions", body)


def test_image_caps_reject_oversize():
    """Decompression-bomb guards: oversized base64 payloads and pixel
    dimensions are refused before the full decode, with the JAX server's
    messages; a normal image decodes to JAX's pixels."""
    big = "data:image/png;base64," + "A" * (tserver.MAX_IMAGE_B64_BYTES + 8)
    with pytest.raises(RequestError, match="payload too large"):
        tserver._decode_image_data_url(big)
    assert tserver.MAX_IMAGE_B64_BYTES == jserver.MAX_IMAGE_B64_BYTES
    assert tserver.MAX_IMAGE_DIM == jserver.MAX_IMAGE_DIM

    old = tserver.MAX_IMAGE_DIM
    tserver.MAX_IMAGE_DIM = 64
    try:
        buf = io.BytesIO()
        Image.new("RGB", (128, 16)).save(buf, format="PNG")
        url = ("data:image/png;base64,"
               + base64.b64encode(buf.getvalue()).decode())
        with pytest.raises(RequestError, match="image too large"):
            tserver._decode_image_data_url(url)
    finally:
        tserver.MAX_IMAGE_DIM = old

    url = _png_data_url(seed=1, size=20)
    arr = tserver._decode_image_data_url(url)
    assert arr.shape == (20, 20, 3)
    np.testing.assert_array_equal(arr, jserver._decode_image_data_url(url))


def test_serve_cli_tick_batch_plumbing():
    """The serve CLI's flags are the JAX CLI's, less --compilation-cache
    (XLA's cache) and plus --device; --tick-batch reaches the engine."""
    from tinychatengine_tpu_torch.serve import build_demo_serving, build_parser

    def options(parser):
        return {a.dest: a.default for a in parser._actions
                if a.dest != "help"}
    mine, theirs = options(build_parser()), options(jbuild_parser())
    assert mine.pop("device") == "cuda"
    theirs.pop("compilation_cache")
    assert mine == theirs
    args = build_parser().parse_args(["--demo"])
    assert args.tick_batch == 16  # serve default (engine ctor default is 8)
    args = build_parser().parse_args(["--demo", "--tick-batch", "64"])
    assert args.tick_batch == 64
    engine, tok = build_demo_serving(slots=2, tick_batch=4, device="cpu")
    assert engine.tick_batch == 4 and engine.device.type == "cpu"
