"""OpenAI-compatible HTTP serving front-end, stdlib-only (counterpart of the
JAX package's ``runtime/server.py``).

The reference's only user surface is an interactive terminal REPL
(llm/application/chat.cc:125-222) — no network API, no concurrent clients,
no streaming protocol. This module is the REST server above the
continuous-batching ServingEngine (runtime/serving.py), speaking the OpenAI
wire shapes so existing clients work unchanged:

  GET  /health               liveness + engine counters
  GET  /v1/models            model listing
  GET  /metrics              Prometheus exposition
  POST /v1/completions       text completion (+ SSE streaming, logprobs)
  POST /v1/chat/completions  chat-template wrap (+ SSE streaming, logprobs,
                             and — when the server is built with a vision
                             encoder — OpenAI image_url content parts:
                             data: URLs are decoded on the handler thread,
                             CLIP-encoded on the scheduler thread and
                             spliced as prompt embeddings)
  POST /v1/embeddings        mean-pooled L2-normalized decoder embeddings

Threading model: HTTP is thread-per-connection (ThreadingHTTPServer), but
the ServingEngine is single-threaded by design (device tensors + host slot
bookkeeping). Handler threads therefore NEVER touch the engine or the
device: they enqueue submit/cancel/call commands into an intake queue and
block on a per-request event queue; ONE scheduler thread owns the engine —
it drains intakes, ticks ``engine.step()`` (continuous batching:
admissions interleave with decode), and fans tokens out through
``Request.on_token``. The JAX server runs embeddings and image encodes on
the handler threads (JAX dispatch is thread-safe); here they are ``call``
commands that the scheduler thread runs between steps (``run_on_scheduler``):
it captures and replays CUDA graphs (generation/cuda_graph.py), and device
work from another thread during a capture could fail it. Host-side
stop-STRING matching runs on the handler thread over the incrementally
detokenized text (tokenizers/streaming.StreamDecoder) with prefix
hold-back, and a match enqueues a cancel (ServingEngine.cancel) so the slot
frees immediately instead of decoding to n_predict. Stop TOKENS ride into
the engine and cut generation on-device-loop as usual.
"""

from __future__ import annotations

import base64
import dataclasses
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

import torch

from tinychatengine_tpu_torch.core.config import GenerationConfig
from tinychatengine_tpu_torch.generation.chat_templates import (ChatTemplate,
                                                                template_for)
from tinychatengine_tpu_torch.runtime.serving import ServingEngine
from tinychatengine_tpu_torch.tokenizers.streaming import StreamDecoder


class RequestError(ValueError):
    """400-class client error."""


@dataclasses.dataclass
class _Job:
    """One in-flight HTTP generation, shared between its handler thread and
    the scheduler thread. ``events`` carries ("tok", id) / ("done", reason) /
    ("err", message); everything else is written once at submit time."""

    ids: np.ndarray
    n_predict: int
    stop_ids: tuple
    rcfg: GenerationConfig | None
    logprobs: int | None = None     # None=off, 0=chosen only, k=top-k
    input_embeds: np.ndarray | None = None  # [n, E] multimodal prompt
    events: queue.Queue = dataclasses.field(default_factory=queue.Queue)
    req: object = None              # serving.Request, set by the scheduler


@dataclasses.dataclass
class _Call:
    """Device work a handler thread hands to the scheduler thread: ``fn()``
    runs there between engine steps; ``events`` carries ("ok", result) or
    ("exc", exception)."""

    fn: object
    events: queue.Queue = dataclasses.field(default_factory=queue.Queue)


class InferenceServer:
    """OpenAI-shaped REST API over one continuous-batching ServingEngine."""

    def __init__(self, engine: ServingEngine, tokenizer,
                 model_name: str | None = None,
                 template: ChatTemplate | None = None,
                 request_timeout: float = 600.0,
                 clip_params=None, clip_cfg=None):
        """clip_params/clip_cfg: an optional vision encoder (models/clip.py)
        turning the server into a VLM endpoint — chat messages may then
        carry OpenAI ``image_url`` content parts (data: URLs only in this
        zero-egress build); images are decoded on the handler thread,
        CLIP-encoded and spliced on the scheduler thread, and the request
        is admitted with the prompt embeddings
        (vlm.build_multimodal_inputs_multi)."""
        self.engine = engine
        self.tok = tokenizer
        self.clip_params = clip_params
        self.clip_cfg = clip_cfg
        self.model_name = model_name or engine.cfg.name
        self.template = template or template_for(self.model_name)
        self.request_timeout = float(request_timeout)
        self._intake: queue.Queue = queue.Queue()
        self._jobs: dict[int, _Job] = {}        # id(Request) -> _Job
        self._done_idx = 0                      # consumed prefix of engine.done
        self._closing = threading.Event()
        self._threads: list[threading.Thread] = []
        self._httpd: ThreadingHTTPServer | None = None
        self.port: int | None = None
        self._counter = 0
        self._counter_lock = threading.Lock()
        # serving metrics, written only by the scheduler thread (handler
        # threads read plain ints/dicts — GIL-atomic enough for counters)
        self.stats = {
            "requests_total": {},        # finish_reason -> count
            "tokens_generated_total": 0,
            "prompt_tokens_total": 0,
            "ttft_seconds_sum": 0.0,
            "ttft_seconds_count": 0,
        }

    # -- lifecycle -----------------------------------------------------------
    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Bind + serve; returns the bound port (port=0 picks a free one)."""
        handler = _make_handler(self)

        class _Server(ThreadingHTTPServer):
            # socketserver's default accept backlog is 5: a burst of
            # concurrent clients (the 24-client bench connects all at once)
            # overflows the accept queue and the kernel RSTs the overflow —
            # clients see ConnectionResetError before a single byte of HTTP.
            request_queue_size = 128

        self._httpd = _Server((host, port), handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        t_sched = threading.Thread(target=self._scheduler_loop,
                                   name="tce-scheduler", daemon=True)
        t_http = threading.Thread(target=self._httpd.serve_forever,
                                  name="tce-http", daemon=True)
        self._threads = [t_sched, t_http]
        t_sched.start()
        t_http.start()
        return self.port

    def close(self):
        self._closing.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        for t in self._threads:
            t.join(timeout=10)

    # -- scheduler thread (sole owner of the engine) ---------------------------
    def _busy(self) -> bool:
        e = self.engine
        return bool(e.queue) or e._pending is not None or e.n_active > 0

    def _scheduler_loop(self):
        while not self._closing.is_set():
            # drain intakes; block briefly only when the engine is idle
            try:
                cmd = self._intake.get(timeout=0.0 if self._busy() else 0.05)
            except queue.Empty:
                cmd = None
            while cmd is not None:
                self._apply(*cmd)
                try:
                    cmd = self._intake.get_nowait()
                except queue.Empty:
                    cmd = None
            if not self._busy():
                self._drain_done()  # a cancel can finish requests with no step
                continue
            try:
                self.engine.step()
            except Exception as exc:  # deliver instead of killing the thread
                for job in list(self._jobs.values()):
                    job.events.put(("err", f"{type(exc).__name__}: {exc}"))
                    if job.req is not None:
                        self.engine.cancel(job.req, reason="error")
                self._jobs.clear()
            self._drain_done()

    def _apply(self, kind: str, job):
        if kind == "call":
            try:
                with torch.inference_mode():
                    job.events.put(("ok", job.fn()))
            except Exception as exc:  # re-raised on the handler thread
                job.events.put(("exc", exc))
        elif kind == "submit":
            try:
                job.req = self.engine.submit(
                    job.ids, n_predict=job.n_predict,
                    stop_token_ids=job.stop_ids,
                    on_token=lambda t, _r, _j=job: _j.events.put(("tok", t)),
                    gcfg=job.rcfg, logprobs=job.logprobs,
                    input_embeds=job.input_embeds)
            except Exception as exc:
                job.events.put(("err", f"{type(exc).__name__}: {exc}"))
                return
            self._jobs[id(job.req)] = job
        elif kind == "cancel" and job.req is not None:
            self.engine.cancel(job.req)  # completion delivered by _drain_done

    def _drain_done(self):
        done = self.engine.done
        while self._done_idx < len(done):
            req = done[self._done_idx]
            self._done_idx += 1
            reason = req.finish_reason or "stop"
            self.stats["requests_total"][reason] = \
                self.stats["requests_total"].get(reason, 0) + 1
            self.stats["tokens_generated_total"] += len(req.output_ids)
            self.stats["prompt_tokens_total"] += len(req.prompt_ids)
            if req.first_token_t and req.submit_t:
                self.stats["ttft_seconds_sum"] += \
                    req.first_token_t - req.submit_t
                self.stats["ttft_seconds_count"] += 1
            job = self._jobs.pop(id(req), None)
            if job is not None:
                job.events.put(("done", req.finish_reason))

    # -- handler-thread API ----------------------------------------------------
    def submit(self, ids, n_predict: int, stop_ids, rcfg,
               logprobs: int | None = None, input_embeds=None) -> _Job:
        job = _Job(ids=np.asarray(ids, np.int32).reshape(-1),
                   n_predict=n_predict, stop_ids=tuple(stop_ids), rcfg=rcfg,
                   logprobs=logprobs, input_embeds=input_embeds)
        self._intake.put(("submit", job))
        return job

    def cancel(self, job: _Job):
        self._intake.put(("cancel", job))

    def run_on_scheduler(self, fn):
        """Run ``fn()`` on the scheduler thread, between engine steps, and
        return its result (or raise its exception) here: device work of a
        handler thread (embeddings, image encodes) never overlaps a step or
        a graph capture. TimeoutError after ``request_timeout``."""
        call = _Call(fn)
        self._intake.put(("call", call))
        try:
            kind, val = call.events.get(timeout=self.request_timeout)
        except queue.Empty:
            raise TimeoutError("scheduler call timed out") from None
        if kind == "exc":
            raise val
        return val

    def next_id(self, prefix: str) -> str:
        with self._counter_lock:
            self._counter += 1
            return f"{prefix}-{int(time.time())}-{self._counter}"


# -- OpenAI body mapping -------------------------------------------------------

def _embed_texts(srv, id_rows: list) -> list:
    """Mean-pooled, L2-normalized last-layer hidden states (the standard
    decoder-as-embedder recipe; llama.cpp's /embedding analog — no reference
    counterpart). One bucketed batch-1 forward per input, on the scheduler
    thread (``run_on_scheduler``)."""
    return srv.run_on_scheduler(lambda: [_embed_step(srv.engine, ids).tolist()
                                         for ids in id_rows])


def _embed_step(e: ServingEngine, ids) -> torch.Tensor:
    """One input's embedding, [E] f32 on the host: the family forward with
    ``return_hidden`` over the prompt right-padded to the Engine's bucket,
    on a fresh bf16 cache, with a device ``true_len``; the padded rows
    masked out, the mean and the norm in f32 (true divisions, as jitted
    JAX keeps them: both divisors are tensors)."""
    from tinychatengine_tpu_torch.generation import kv_cache as kvc
    from tinychatengine_tpu_torch.generation.engine import _bucket

    bucket = min(_bucket(len(ids)), e.max_len)
    row = torch.zeros((1, bucket), dtype=torch.int32)
    row[0, :len(ids)] = torch.as_tensor(ids, dtype=torch.int32)
    cache = kvc.init_cache(e.cfg.num_layers, 1, bucket, e.cfg.num_kv_heads,
                           e.cfg.head_dim, device=e.device)
    true_len = torch.tensor(len(ids), dtype=torch.int32, device=e.device)
    hidden, _ = e._forward(e.params, e.cfg, row.to(e.device), cache, 0,
                           true_len=true_len, return_hidden=True)
    mask = (torch.arange(bucket, device=e.device)[None, :, None]
            < true_len).float()
    pooled = (hidden.float() * mask).sum(dim=1) \
        / torch.clamp(true_len.float(), min=1.0)
    norm = torch.sqrt(torch.sum(pooled * pooled, dim=-1, keepdim=True))
    return (pooled / torch.clamp(norm, min=1e-9))[0].cpu()


def _parse_logprobs(srv, body: dict, chat: bool):
    """OpenAI logprobs params → engine request value (None=off, 0=chosen
    token only, k=also top-k alternatives). Completions: ``logprobs: int``;
    chat: ``logprobs: true`` + ``top_logprobs: int``."""
    try:
        if chat:
            if not body.get("logprobs"):
                return None
            k = int(body.get("top_logprobs", 0) or 0)
        else:
            if body.get("logprobs") is None:
                return None
            k = int(body["logprobs"])
    except (TypeError, ValueError) as exc:
        raise RequestError(f"logprobs/top_logprobs must be an integer: {exc}")
    cap = srv.engine.logprobs_k
    if not 0 <= k <= cap:
        raise RequestError(
            f"logprobs/top_logprobs must be in [0, {cap}]; got {k}")
    return k


def _format_logprobs(tok, req, n: int, k: int, chat: bool,
                     text: str) -> dict:
    """Engine per-token records → the OpenAI response shapes. ``n`` trims to
    the tokens counted into the response; tokens whose text was SUPPRESSED
    (engine stop tokens, a stop-string match cut) are then dropped by
    aligning decoded pieces against the returned ``text`` — tokens and
    text_offset always describe exactly the text the client got.
    Logprobs are of the RAW model distribution (serving._token_logprobs)."""
    ids = req.output_ids[:n]
    lps = req.output_logprobs[:n]
    tops = req.output_top_logprobs[:n]
    pieces = [tok.decode([t]) for t in ids]
    # drop the suppressed tail by LENGTH (robust to tokenizers whose
    # singleton decode differs cosmetically from the streamed decode): a
    # stop cut always truncates at the end, so trim trailing tokens until
    # the pieces fit inside the returned text — offsets never point past it
    total = sum(len(s) for s in pieces)
    keep = len(pieces)
    while keep and total > len(text):
        keep -= 1
        total -= len(pieces[keep])
    ids, lps, tops, pieces = (x[:keep] for x in (ids, lps, tops, pieces))
    if chat:
        content = []
        for s, lp, top in zip(pieces, lps, tops):
            content.append({
                "token": s, "logprob": lp,
                "bytes": list(s.encode("utf-8")),
                "top_logprobs": [
                    {"token": (ts := tok.decode([i])), "logprob": l,
                     "bytes": list(ts.encode("utf-8"))}
                    for i, l in top],
            })
        return {"content": content}
    offs, off = [], 0
    for s in pieces:
        offs.append(off)
        off += len(s)
    def top_dict(top):
        d = {}
        for i, l in top:  # descending; on a decode collision keep the best
            d.setdefault(tok.decode([i]), l)
        return d

    return {
        "tokens": pieces,
        "token_logprobs": lps,
        "top_logprobs": [top_dict(t) for t in tops] if k else None,
        "text_offset": offs,
    }

def _as_float(body, key, lo=None, hi=None):
    v = body[key]
    try:
        v = float(v)
    except (TypeError, ValueError):
        raise RequestError(f"'{key}' must be a number")
    if lo is not None and v < lo or hi is not None and v > hi:
        raise RequestError(f"'{key}' out of range")
    return v


def build_gcfg(server: InferenceServer, body: dict) -> GenerationConfig | None:
    """Map OpenAI sampling params onto GenerationConfig (reference
    opt_params, llm/include/Generate.h:48-72). Unknown fields are ignored
    like OpenAI does; unsupported *semantics* (best_of sampling-and-rank)
    are 400s; n>1 is handled by _completion (one engine request per
    choice). Returns None when the request customizes nothing, so defaults
    ride the engine-global sampler (works even on engines whose oversized
    logit_bias disables the per-row path, serving.py submit())."""
    if int(body.get("best_of", 1) or 1) not in (1, int(body.get("n", 1) or 1)):
        raise RequestError("best_of must equal n (no sample-and-rank)")
    known = ("temperature", "top_p", "top_k", "seed", "frequency_penalty",
             "presence_penalty", "repetition_penalty", "repeat_last_n",
             "mirostat", "logit_bias")
    if not any(body.get(k) is not None for k in known):
        return None
    g = dataclasses.replace(server.engine.gcfg)
    if "temperature" in body:
        g.temp = _as_float(body, "temperature", 0.0, 100.0)
    if "top_p" in body:
        g.top_p = _as_float(body, "top_p", 0.0, 1.0)
    if "top_k" in body:                       # extension (llama.cpp-style)
        g.top_k = int(body["top_k"])
    if "seed" in body and body["seed"] is not None:
        g.seed = int(body["seed"])
    if "frequency_penalty" in body:
        g.frequency_penalty = _as_float(body, "frequency_penalty", -2.0, 2.0)
    if "presence_penalty" in body:
        g.presence_penalty = _as_float(body, "presence_penalty", -2.0, 2.0)
    if "repetition_penalty" in body:          # extension
        g.repeat_penalty = _as_float(body, "repetition_penalty", 0.0, 100.0)
    if "repeat_last_n" in body:               # extension
        g.repeat_last_n = int(body["repeat_last_n"])
    if "mirostat" in body:                    # extension (v1/v2)
        g.mirostat = int(body["mirostat"])
        if "mirostat_tau" in body:
            g.mirostat_tau = _as_float(body, "mirostat_tau")
        if "mirostat_eta" in body:
            g.mirostat_eta = _as_float(body, "mirostat_eta")
    if body.get("logit_bias"):
        try:
            g.logit_bias = {int(k): float(v)
                            for k, v in body["logit_bias"].items()}
        except (TypeError, ValueError, AttributeError):
            raise RequestError("'logit_bias' must map token ids to floats")
    return g


def _stop_strings(body: dict) -> list[str]:
    stop = body.get("stop")
    if stop is None:
        return []
    if isinstance(stop, str):
        return [stop]
    if isinstance(stop, list) and all(isinstance(s, str) for s in stop):
        return stop[:4]
    raise RequestError("'stop' must be a string or list of strings")


MAX_IMAGE_B64_BYTES = 24 * 1024 * 1024   # payload cap before base64 decode
MAX_IMAGE_DIM = 8192                      # per-side cap before convert()
# (ADVICE r4: an unbounded highly-compressed image could allocate hundreds
# of MB per handler thread inside im.convert; CLIP resizes to ~336 px, so
# giant inputs buy the client nothing)


def _decode_image_data_url(url: str) -> np.ndarray:
    """data:image/...;base64,... → uint8 [H, W, 3]. Only data: URLs: this
    build has no network egress, and inline images are what local OpenAI
    vision clients send anyway. Payload size and pixel dimensions are
    bounded BEFORE the full decode so a decompression-bomb image cannot
    exhaust host memory across concurrent handler threads."""
    if not isinstance(url, str) or not url.startswith("data:"):
        raise RequestError(
            "only data: image URLs are supported (no network egress)")
    try:
        _, b64 = url.split(",", 1)
        if len(b64) > MAX_IMAGE_B64_BYTES:
            raise RequestError(
                f"image payload too large (> {MAX_IMAGE_B64_BYTES} bytes "
                "base64)")
        raw = base64.b64decode(b64, validate=True)
        from PIL import Image
        Image.MAX_IMAGE_PIXELS = MAX_IMAGE_DIM * MAX_IMAGE_DIM  # PIL's own
        # bomb ceiling, set explicitly (decode raises DecompressionBombError)
        with Image.open(io.BytesIO(raw)) as im:
            w, h = im.size  # header-only: no pixel data decoded yet
            if w > MAX_IMAGE_DIM or h > MAX_IMAGE_DIM:
                raise RequestError(
                    f"image too large ({w}x{h}; max {MAX_IMAGE_DIM} per "
                    "side)")
            # a copy: torch.from_numpy warns on a read-only array
            return np.array(im.convert("RGB"), np.uint8)
    except RequestError:
        raise
    except Exception as exc:
        raise RequestError(f"could not decode image: {exc}")


def _encode_images(srv: InferenceServer, prompt_text: str, images: list):
    """CLIP-encode the decoded images and splice them into the prompt at
    its markers: (ids [S] int32, embeds [S, E] f32), numpy both. Device
    work: runs on the scheduler thread."""
    from tinychatengine_tpu_torch.generation import vlm
    emb_list = [vlm.encode_image(srv.clip_params, srv.clip_cfg, img)
                for img in images]
    return vlm.build_multimodal_inputs_multi(
        srv.tok, srv.engine.params.embed, prompt_text, emb_list)


def render_messages(template: ChatTemplate, messages,
                    images: list | None = None) -> str:
    """Fold an OpenAI ``messages`` array through the family chat template
    (first/next wraps mirror the reference REPL's prompt building,
    llm/application/chat.cc:437-441). A client system message is emitted as
    a plain prefix ahead of the template's own preamble; assistant turns are
    inserted verbatim between the user wraps.

    images: when a list is passed, ``image_url`` content parts are decoded
    (data: URLs) and appended to it, and a vlm.IMAGE_MARKER is left in the
    rendered text at each image's position (the caller splices CLIP embeds
    there); when None, an image part is a client error."""
    from tinychatengine_tpu_torch.generation.vlm import IMAGE_MARKER

    parts, first = [], True
    for m in messages:
        if not isinstance(m, dict) or "role" not in m:
            raise RequestError("each message needs a 'role'")
        content = m.get("content") or ""
        if isinstance(content, list):  # OpenAI content-part arrays
            buf = []
            for p in content:
                if not isinstance(p, dict):
                    continue
                if p.get("type") == "text":
                    buf.append(p.get("text", ""))
                elif p.get("type") == "image_url":
                    if images is None:
                        raise RequestError(
                            "image input is not enabled on this server")
                    u = p.get("image_url")
                    u = u.get("url") if isinstance(u, dict) else u
                    images.append(_decode_image_data_url(u))
                    buf.append(IMAGE_MARKER)
            content = "".join(buf)
        if not isinstance(content, str):
            raise RequestError("message 'content' must be text")
        role = m["role"]
        if role == "system":
            parts.append(content + "\n\n")
        elif role == "user":
            wrap = template.first if first else template.next
            first = False
            parts.append(wrap.replace("{image}", "").replace("{input}", content))
        elif role == "assistant":
            parts.append(content + "\n")
        else:
            raise RequestError(f"unsupported role '{role}'")
    if first:
        raise RequestError("'messages' must contain at least one user message")
    return "".join(parts)


def _holdback(buf: str, stops: list[str]) -> int:
    """Chars of ``buf`` safe to emit now: hold back the longest tail that is
    a proper prefix of any stop string (so a stop split across tokens is
    never streamed out)."""
    hold = 0
    for s in stops:
        for k in range(min(len(s) - 1, len(buf)), 0, -1):
            if buf.endswith(s[:k]):
                hold = max(hold, k)
                break
    return len(buf) - hold


class _Collector:
    """Handler-side assembly of one generation: incremental detok, stop-token
    suppression, stop-string scan + cancel, usage counting."""

    def __init__(self, server: InferenceServer, job: _Job, stops: list[str],
                 stop_id_set: frozenset):
        self.server = server
        self.job = job
        self.stops = stops
        self.stop_ids = stop_id_set
        self.sdec = StreamDecoder(server.tok)
        self.buf = ""            # decoded, not yet emitted
        self.emitted = 0         # completion tokens counted
        self.finish_reason = None
        self.error = None

    def pump(self):
        """Yield text deltas as they become safe; sets finish_reason at the
        end. Raises TimeoutError if the engine stalls."""
        deadline = time.monotonic() + self.server.request_timeout
        while True:
            try:
                kind, val = self.job.events.get(
                    timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                self.server.cancel(self.job)
                raise TimeoutError("generation timed out")
            if kind == "err":
                self.error = val
                self.finish_reason = "error"
                return
            if kind == "done":
                tail = self.buf + self.sdec.flush()
                self.buf = ""
                cut, reason = self._scan(tail)
                if cut is not None:
                    yield cut
                self.finish_reason = reason or (
                    "stop" if val in ("stop", "cancelled") else val or "stop")
                return
            self.emitted += 1
            if int(val) in self.stop_ids:
                continue  # never decode the stop token into output text
            self.buf += self.sdec.feed(int(val))
            cut, reason = self._scan(None)
            if reason:  # stop string hit: emit the head, cancel the rest
                if cut:
                    yield cut
                self.finish_reason = reason
                self.server.cancel(self.job)
                self._drain_to_done()
                return
            safe = _holdback(self.buf, self.stops)
            if safe > 0:
                out, self.buf = self.buf[:safe], self.buf[safe:]
                yield out

    def _scan(self, final_tail):
        """final_tail=None: scan self.buf for a stop match (returns head
        before the match). Otherwise scan the flushed tail the same way."""
        text = self.buf if final_tail is None else final_tail
        idx = min((i for i in (text.find(s) for s in self.stops) if i >= 0),
                  default=-1)
        if idx >= 0:
            head = text[:idx]
            if final_tail is None:
                self.buf = ""
            return head, "stop"
        if final_tail is not None:
            return text, None
        return None, None

    def _drain_to_done(self):
        """After a cancel, consume events until the completion arrives so the
        scheduler-side job map is cleaned up deterministically."""
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            try:
                kind, _ = self.job.events.get(timeout=0.5)
            except queue.Empty:
                continue
            if kind in ("done", "err"):
                return


def _render_metrics(server: InferenceServer) -> str:
    """Prometheus text exposition (counters from the scheduler thread,
    gauges read live off the engine). The reference's observability is a
    per-turn profiler printout (llm/include/profiler.h:38-47); a network
    server needs scrapeable metrics instead."""
    e = server.engine
    s = server.stats
    lines = [
        "# HELP tce_requests_total Finished requests by finish reason.",
        "# TYPE tce_requests_total counter",
        *(f'tce_requests_total{{reason="{r}"}} {n}'
          # snapshot: the scheduler thread may insert a new finish_reason
          # key mid-iteration (dict(...) copies atomically under the GIL)
          for r, n in sorted(dict(s["requests_total"]).items())),
        "# HELP tce_generation_tokens_total Tokens generated.",
        "# TYPE tce_generation_tokens_total counter",
        f"tce_generation_tokens_total {s['tokens_generated_total']}",
        "# HELP tce_prompt_tokens_total Prompt tokens processed.",
        "# TYPE tce_prompt_tokens_total counter",
        f"tce_prompt_tokens_total {s['prompt_tokens_total']}",
        "# HELP tce_ttft_seconds Time to first token.",
        "# TYPE tce_ttft_seconds summary",
        f"tce_ttft_seconds_sum {s['ttft_seconds_sum']:.6f}",
        f"tce_ttft_seconds_count {s['ttft_seconds_count']}",
        "# HELP tce_active_slots Slots currently decoding.",
        "# TYPE tce_active_slots gauge",
        f"tce_active_slots {e.n_active}",
        "# HELP tce_slots Total continuous-batching slots.",
        "# TYPE tce_slots gauge",
        f"tce_slots {e.n_slots}",
        "# HELP tce_queued_requests Requests waiting for a slot.",
        "# TYPE tce_queued_requests gauge",
        f"tce_queued_requests {len(e.queue)}",
    ]
    if getattr(e, "_pfx_entries", 0):
        lines += [
            "# HELP tce_prefix_cache_hits_total KV prefix-cache hits.",
            "# TYPE tce_prefix_cache_hits_total counter",
            f"tce_prefix_cache_hits_total {e.prefix_stats['hits']}",
            "# HELP tce_prefix_cache_hit_tokens_total Prompt tokens served "
            "from the KV prefix cache.",
            "# TYPE tce_prefix_cache_hit_tokens_total counter",
            f"tce_prefix_cache_hit_tokens_total {e.prefix_stats['hit_tokens']}",
        ]
    if getattr(e, "speculative", False):
        lines += [
            "# HELP tce_speculative_tokens_total Tokens accepted from "
            "speculative (prompt-lookup) verification ticks.",
            "# TYPE tce_speculative_tokens_total counter",
            f"tce_speculative_tokens_total {e._spec_stats['tokens']}",
        ]
    return "\n".join(lines) + "\n"


# -- HTTP plumbing ---------------------------------------------------------------

def _make_handler(server: InferenceServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        srv = server

        # quiet by default (BaseHTTPRequestHandler logs every request)
        def log_message(self, fmt, *args):
            pass

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, message: str, etype="invalid_request_error"):
            self._json(code, {"error": {"message": message, "type": etype}})

        def _embeddings(self, body: dict):
            srv = self.srv
            tok = srv.tok
            raw = body.get("input")
            if isinstance(raw, str):
                items = [raw]
            elif isinstance(raw, list) and raw and all(
                    isinstance(t, int) for t in raw):
                items = [list(raw)]          # one pre-tokenized input
            elif isinstance(raw, list) and raw and all(
                    isinstance(t, str) for t in raw):
                items = list(raw)
            else:
                raise RequestError("'input' must be a string, a list of "
                                   "strings, or a list of token ids")
            id_rows, total = [], 0
            for it in items:
                ids = it if isinstance(it, list) else tok.encode(it, bos=True)
                if not ids:
                    raise RequestError("empty input")
                if len(ids) > srv.engine.max_len:
                    raise RequestError(
                        f"input of {len(ids)} tokens exceeds context "
                        f"{srv.engine.max_len}")
                id_rows.append(ids)
                total += len(ids)
            try:
                embs = _embed_texts(srv, id_rows)
            except TypeError as exc:  # family forward without return_hidden
                if "return_hidden" not in str(exc):
                    raise  # a genuine bug, not a capability gap — surface it
                self._error(
                    501, f"embeddings unsupported for this model: {exc}",
                    etype="server_error")
                return
            self._json(200, {
                "object": "list", "model": srv.model_name,
                "data": [{"object": "embedding", "index": i, "embedding": e}
                         for i, e in enumerate(embs)],
                "usage": {"prompt_tokens": total, "total_tokens": total}})

        def do_GET(self):
            if self.path == "/health":
                e = self.srv.engine
                self._json(200, {
                    "status": "ok", "model": self.srv.model_name,
                    "slots": e.n_slots, "active": e.n_active,
                    "queued": len(e.queue)})
            elif self.path == "/v1/models":
                self._json(200, {"object": "list", "data": [{
                    "id": self.srv.model_name, "object": "model",
                    "owned_by": "tinychatengine-tpu"}]})
            elif self.path == "/metrics":
                body = _render_metrics(self.srv).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._error(404, f"unknown path {self.path}")

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(body, dict):
                    raise RequestError("body must be a JSON object")
                if self.path == "/v1/completions":
                    self._completion(body, chat=False)
                elif self.path == "/v1/chat/completions":
                    self._completion(body, chat=True)
                elif self.path == "/v1/embeddings":
                    self._embeddings(body)
                else:
                    self._error(404, f"unknown path {self.path}")
            except RequestError as exc:
                self._error(400, str(exc))
            except json.JSONDecodeError:
                self._error(400, "invalid JSON body")
            except (BrokenPipeError, ConnectionResetError):
                pass  # client went away; cancellation handled in _completion
            except TimeoutError as exc:
                self._error(504, str(exc), etype="timeout")
            except Exception as exc:  # pragma: no cover - last-resort 500
                try:
                    self._error(500, f"{type(exc).__name__}: {exc}",
                                etype="server_error")
                except Exception:
                    pass

        # -- the one generation endpoint (completions + chat variants) --------
        def _completion(self, body: dict, chat: bool):
            srv = self.srv
            tok = srv.tok
            input_embeds = None
            if chat:
                messages = body.get("messages")
                if not isinstance(messages, list) or not messages:
                    raise RequestError("'messages' must be a non-empty list")
                images: list = []
                prompt_text = render_messages(srv.template, messages,
                                              images=images)
                if images:
                    if srv.clip_params is None:
                        raise RequestError(
                            "image input is not enabled on this server "
                            "(no vision encoder configured)")
                    try:
                        ids, input_embeds = srv.run_on_scheduler(
                            lambda: _encode_images(srv, prompt_text, images))
                    except ValueError as exc:  # stray literal marker etc.
                        raise RequestError(str(exc))
                    ids = ids.tolist()
                else:
                    ids = tok.encode(prompt_text, bos=True)
            else:
                prompt = body.get("prompt", "")
                if isinstance(prompt, list) and all(
                        isinstance(t, int) for t in prompt):
                    ids = list(prompt)           # pre-tokenized prompt
                elif isinstance(prompt, str):
                    ids = tok.encode(prompt, bos=True)
                else:
                    raise RequestError(
                        "'prompt' must be a string or list of token ids")
            if not ids:
                raise RequestError("empty prompt")
            max_len = srv.engine.max_len
            if len(ids) >= max_len - 2:
                raise RequestError(
                    f"prompt of {len(ids)} tokens exceeds context {max_len}")

            gcfg = build_gcfg(srv, body)
            n_predict = int(body.get("max_tokens",
                                     body.get("max_completion_tokens",
                                              srv.engine.gcfg.n_predict)))
            if n_predict < 1:
                raise RequestError("'max_tokens' must be >= 1")
            stops = _stop_strings(body)
            stop_ids = {int(t) for t in body.get("stop_token_ids", ())}
            eos = getattr(tok, "eos_id", None)
            if eos is not None and not body.get("ignore_eos"):
                stop_ids.add(int(eos))
            for name in srv.template.stop_token_names:
                tid = getattr(tok, "special", {}).get(name) \
                    if hasattr(tok, "special") else None
                if tid is not None:
                    stop_ids.add(int(tid))

            lp_req = _parse_logprobs(srv, body, chat)
            if lp_req is not None and body.get("stream"):
                raise RequestError(
                    "logprobs with stream=true is not supported")
            try:
                raw_n = body.get("n")
                n_choices = 1 if raw_n is None else int(raw_n)
            except (TypeError, ValueError):
                raise RequestError("'n' must be an integer")
            if not 1 <= n_choices <= max(8, srv.engine.n_slots):
                raise RequestError(
                    f"'n' must be in [1, {max(8, srv.engine.n_slots)}]")
            if n_choices > 1 and body.get("stream"):
                raise RequestError("n > 1 with stream=true is not supported")

            def rcfg_for(i):
                # choice 0 keeps the user's exact seed (reproducibility);
                # later choices offset it. Without an explicit seed, each
                # engine request already gets a unique request_id-derived key
                if i == 0 or gcfg is None or gcfg.seed < 0:
                    return gcfg
                return dataclasses.replace(gcfg, seed=gcfg.seed + i)

            jobs = [srv.submit(ids, n_predict, sorted(stop_ids), rcfg_for(i),
                               logprobs=lp_req, input_embeds=input_embeds)
                    for i in range(n_choices)]
            colls = [_Collector(srv, j, stops, frozenset(stop_ids))
                     for j in jobs]
            oid = srv.next_id("chatcmpl" if chat else "cmpl")
            created = int(time.time())
            obj = ("chat.completion" if chat else "text_completion")

            if body.get("stream"):
                self._stream(colls[0], jobs[0], oid, created, obj, chat)
                return
            choices, completion_tokens = [], 0
            for i, (job, coll) in enumerate(zip(jobs, colls)):
                text = "".join(coll.pump())
                if coll.error is not None:
                    self._error(500, coll.error, etype="server_error")
                    return
                choice = {"index": i, "finish_reason": coll.finish_reason}
                if chat:
                    choice["message"] = {"role": "assistant", "content": text}
                else:
                    choice["text"] = text
                if lp_req is not None and job.req is not None:
                    choice["logprobs"] = _format_logprobs(
                        tok, job.req, coll.emitted, lp_req, chat, text)
                choices.append(choice)
                completion_tokens += coll.emitted
            self._json(200, {
                "id": oid, "object": obj, "created": created,
                "model": srv.model_name, "choices": choices,
                "usage": {"prompt_tokens": len(ids),
                          "completion_tokens": completion_tokens,
                          "total_tokens": len(ids) + completion_tokens}})

        def _stream(self, coll: _Collector, job: _Job, oid: str,
                    created: int, obj: str, chat: bool):
            srv = self.srv
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()

            def chunk(**choice):
                payload = {"id": oid, "object": obj + ".chunk", "created":
                           created, "model": srv.model_name,
                           "choices": [{"index": 0, "finish_reason": None,
                                        **choice}]}
                self.wfile.write(b"data: " + json.dumps(payload).encode()
                                 + b"\n\n")
                self.wfile.flush()

            try:
                if chat:
                    chunk(delta={"role": "assistant"})
                try:
                    for piece in coll.pump():
                        if chat:
                            chunk(delta={"content": piece})
                        else:
                            chunk(text=piece)
                except TimeoutError as exc:  # headers already sent: SSE error
                    coll.error = str(exc)
                if coll.error is not None:
                    self.wfile.write(
                        b"data: " + json.dumps({"error": {
                            "message": coll.error,
                            "type": "server_error"}}).encode() + b"\n\n")
                else:
                    final = {"delta": {}} if chat else {"text": ""}
                    payload = {"id": oid, "object": obj + ".chunk",
                               "created": created, "model": srv.model_name,
                               "choices": [{"index": 0,
                                            "finish_reason":
                                                coll.finish_reason, **final}]}
                    self.wfile.write(b"data: " + json.dumps(payload).encode()
                                     + b"\n\n")
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                srv.cancel(job)  # client disconnected mid-stream
            finally:
                self.close_connection = True

    return Handler
