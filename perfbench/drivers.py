"""The two ways a mix drives the port (``kind`` of ``traffic/<mix>.json``).

``open_loop``: ``ServingEngine`` under a Poisson schedule. Requests are
submitted at their due times between ``step()`` calls; each ``step()`` is
one call, classed by what ``tick_stats`` says it ran. The work of a call is
worked out from what the server exposes (its queue, its slots' requests
and their emitted tokens): the pending admission's next chunk, the first
chunk of each request that left the queue (the first
``batch_admit_reqs`` of them as batched admissions, FIFO), and one decode
row per token emitted after a request's first, at its KV length.

``closed_loop``: ``Engine.generate_device`` at batch 1, one call after
another over the mix's fixed set of calls in the seed's order.

Set-up (``setup``) makes the weights from the seed on the device, builds
or finds the port's kernels, and runs every captured graph the traffic can
reach once, so nothing is captured inside the window.

A traced run records its slice after the window has closed, so that no
call of the window runs under the profiler: open loop, ``profile_s``
seconds of the traffic that goes on while the window's requests drain;
closed loop, the set's median call.

A ``variant`` runs the program otherwise than the configuration states
(``{"scheme": "w4a8"}``, ``{"kv_cache_dtype": "int8"}``): the port's own
lower-precision paths, read as controls by ``control.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time

import numpy as np
import torch

from perfbench import program, traffic, work
from perfbench.record import Call, Record, Req
from perfbench.trace import CALL, WARM_S, Profile
from perfbench.weights import Weights, subseed
from perfbench.work import bucket


def ctx_cap(needed: int, max_len: int) -> int:
    """The port's decode bound for ``needed`` positions (a frozen copy:
    the graphs warmed are keyed on it)."""
    cap = 512
    while cap < needed:
        cap *= 2
    return min(cap, max_len)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Driver:
    """Shared set-up: sizes, weights, the port's parameters."""

    def __init__(self, model, mix: dict, seed: int, device, peaks: dict,
                 variant: dict = None):
        self.variant = dict(variant or {})
        if "scheme" in self.variant:
            model = dataclasses.replace(model, scheme=self.variant["scheme"])
        self.m, self.mix, self.seed = model, mix, int(seed)
        self.dev = torch.device(device)
        self.peaks = peaks
        self.server = mix["server"]
        self.captures_before = 0
        self.profile = None
        self.mismatch = 0  # steps whose inferred chunks disagree with tick_stats

    def _weights(self) -> None:
        program.build_kernels(self.dev)
        self.w = Weights(self.m, self.seed, self.dev)
        self.params = program.build_params(self.w, self.server["max_len"])
        self.mcfg = program.model_config(self.m)
        self.qcfg = program.quant_config(
            self.m, self.variant.get("kv_cache_dtype", "bf16"))

    def reseed(self, seed: int) -> None:
        """New weights from ``seed`` in the same buffers (the captured
        graphs keep reading them)."""
        self.seed = int(seed)
        self.w = Weights(self.m, self.seed, self.dev)
        program.fill(self.params, self.w)
        _sync(self.dev)

    def _gcfg(self, s: int, n_out: int, seed: int):
        return program.generation_config(
            {**self.mix["sampling"][s], "n_predict": int(n_out)}, seed)

    def greedy(self, s: int) -> bool:
        return self.mix["sampling"][s].get("temp", 0.8) <= 0

    def free(self) -> None:
        """Drop the program's state and its memory."""
        for name in ("srv", "eng", "params", "w"):
            if hasattr(self, name):
                setattr(self, name, None)
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _ids(self, rng, n: int) -> np.ndarray:
        return rng.integers(traffic.ID_MARGIN, self.m.vocab - traffic.ID_MARGIN,
                            n, dtype=np.int64)


class OpenLoop(Driver):
    """Open-loop serving through ``ServingEngine.submit`` / ``step``."""

    def setup(self) -> None:
        from tinychatengine_tpu_torch.runtime.serving import ServingEngine
        self._weights()
        s = self.server
        self.srv = ServingEngine(
            self.params, self.mcfg, self.qcfg, slots=s["slots"],
            max_len=s["max_len"],
            gcfg=program.generation_config(self.mix["engine_sampling"], 0),
            forward_fn=program.forward_fn(self.m), paged=s["paged"],
            page_size=s.get("page_size", 128),
            admission_chunk=s["admission_chunk"], tick_batch=s["tick_batch"],
            device=self.dev)
        self._warm_up()

    def _warm_up(self) -> None:
        """One short request per decode graph the traffic can reach (each
        ``ctx_cap`` bucket of the dense cache, with each sampling config
        of the mix) and one batched admission of each width a burst of
        arrivals can make."""
        srv, s, mix = self.srv, self.server, self.mix
        rng = np.random.default_rng([self.seed & 0xFFFFFFFF, 9])
        longest = min(mix["prompt"]["max"] + mix["output"]["max"],
                      s["max_len"])
        caps = [None] if s["paged"] else sorted(
            {ctx_cap(n, s["max_len"]) for n in (512, longest)} |
            {c for c in (1024, 2048, 4096, 8192)
             if c <= ctx_cap(longest, s["max_len"])})
        for cap in caps:
            p = 32 if cap in (None, 512) else cap // 2 + 1
            for k in range(len(mix["sampling"])):
                srv.submit(self._ids(rng, p), n_predict=4,
                           gcfg=self._gcfg(k, 4, k))
                srv.run()
        for r in (16, 8, 4, 2):
            if r <= s["slots"] and not s["paged"]:
                for _ in range(r):
                    srv.submit(self._ids(rng, mix["prompt"]["min"]),
                               n_predict=2, gcfg=self._gcfg(0, 2, 0))
                srv.run()
        srv.done.clear()
        _sync(self.dev)

    def captures(self) -> int:
        g = self.srv.graphs
        return 0 if g is None else g.captures

    def run(self, seconds: float, trace: bool, profile_s: float = 0.0,
            rate: float = None) -> Record:
        """Pre-roll, the window of ``seconds``, then the drain of the
        window's requests (the tail's arrivals keep coming meanwhile). A
        traced run starts the profiler once the window has closed, lets
        it warm up for ``WARM_S``, records ``profile_s`` seconds and stops
        it; while the profiler starts and stops (seconds of host time) the
        schedule's clock stands still, so the traffic resumes as it was."""
        srv, mix = self.srv, self.mix
        items = traffic.open_loop(mix, self.seed, seconds, self.m.vocab, rate)
        counter = [0]

        def on_token(_tok, _req):
            counter[0] += 1

        rec = Record()
        self._prefilled: dict = {}
        self._adm: dict = {}
        subs = {}
        self.profile = Profile(self.dev) if trace else None
        t_start = time.perf_counter()
        shift = 0.0   # the schedule's clock stood still this long
        open_at = t_start + mix["preroll_s"]
        rec.deadline = open_at + seconds + mix["drain_limit_s"]
        nxt, opened, closed, tok0 = 0, False, False, 0
        phase, t_phase = "off", 0.0   # off | warm | rec | done
        while True:
            now = time.perf_counter()
            while nxt < len(items) and \
                    t_start + shift + items[nxt].due <= now:
                it = items[nxt]
                req = srv.submit(it.prompt, n_predict=it.n_out,
                                 on_token=on_token,
                                 gcfg=self._gcfg(it.sampling, it.n_out,
                                                 subseed(self.seed, "req",
                                                         it.index) >> 33))
                subs[it.index] = (it, req, time.perf_counter(),
                                  t_start + shift + it.due)
                nxt += 1
            if not opened and now >= open_at:
                opened, rec.t_open, tok0 = True, now, counter[0]
                rec.notes["queue_open"] = len(srv.queue)
                self.captures_before = self.captures()
            if opened and not closed and now >= rec.t_open + seconds:
                closed, rec.t_close = True, now
                rec.tokens = counter[0] - tok0
                rec.notes["queue_close"] = len(srv.queue)
                rec.notes["captures_in_window"] = \
                    self.captures() - self.captures_before
                if trace:
                    _sync(self.dev)
                    self.profile.prepare()
                    stall = time.perf_counter() - now
                    shift += stall
                    rec.deadline += stall
                    rec.notes["profiler_start_s"] = stall
                    phase, t_phase = "warm", time.perf_counter()
            if phase == "warm" and now >= t_phase + WARM_S:
                self.profile.record()
                phase, t_phase = "rec", now
            elif phase == "rec" and now >= t_phase + profile_s:
                _sync(self.dev)
                t_stop = time.perf_counter()
                rec.profiled_s = t_stop - t_phase
                self.profile.stop()
                stall = time.perf_counter() - t_stop
                shift += stall
                rec.deadline += stall
                rec.notes["profiler_stop_s"] = stall
                phase = "done"
            if closed and phase in ("off", "done") and (
                    now > rec.deadline or all(
                        req.finished for it, req, _, _ in subs.values()
                        if it.segment == "win")):
                break
            if not (srv.queue or any(sl.request is not None
                                     for sl in srv.slots)):
                wake = t_start + shift + items[nxt].due \
                    if nxt < len(items) else rec.deadline
                time.sleep(max(0.0, min(wake - now, 0.05)))
                continue
            call = self._step(traced=phase == "rec")
            if opened and not closed:
                rec.calls.append(call)
            elif phase == "rec":
                rec.traced_calls.append(call)
        rec.notes["drain_s"] = time.perf_counter() - rec.t_close
        rec.requests = []
        for it, req, sub, due in subs.values():
            if it.segment != "win":
                continue
            rec.requests.append(Req(
                n_prompt=len(it.prompt), n_out=it.n_out, due=due, submit=sub,
                first=req.first_token_t if req.output_ids else 0.0,
                done=req.done_t if req.finished else 0.0,
                emitted=len(req.output_ids)))
        late = [sub - due for _, _, sub, due in subs.values()]
        rec.notes["late_s"] = dict(p50=float(np.median(late)),
                                   p99=traffic.percentile(late, 99),
                                   max=float(max(late)), n=len(late))
        self._subs = subs
        return rec

    def _step(self, traced: bool) -> Call:
        """One ``step()`` and the work it did."""
        srv, m, s = self.srv, self.m, self.server
        chunk = s["admission_chunk"]
        pend = [sl.request for sl in srv.slots
                if sl.request is not None and sl.admitting]
        live = [sl.request for sl in srv.slots
                if sl.request is not None and not sl.admitting]
        queued = list(srv.queue)
        before = {id(r): len(r.output_ids) for r in live}
        ts0 = dict(srv.tick_stats)
        ctx = (torch.profiler.record_function(CALL) if traced
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx:
            srv.step()
        t1 = time.perf_counter()
        ts = {k: srv.tick_stats[k] - ts0[k] for k in ts0}
        still = {id(r) for r in srv.queue}
        left = [r for r in queued if id(r) not in still]

        bound = work.Bound()
        singles = []
        for r in pend:
            done = self._prefilled[id(r)]
            take = min(chunk, len(r.prompt_ids) - done)
            singles.append((r, done, take))
            self._prefilled[id(r)] = done + take
        batched = left[:ts["batch_admit_reqs"]]
        for r in left[ts["batch_admit_reqs"]:]:
            take = min(chunk, len(r.prompt_ids))
            singles.append((r, 0, take))
            self._prefilled[id(r)] = take
        # each request's admission as the comparison needs it: its chunks,
        # the rows of the call that ran each, and the slot it took
        slot_of = {id(sl.request): i for i, sl in enumerate(srv.slots)
                   if sl.request is not None} if left else {}
        for r, start, take in singles:
            rows = bucket(take)
            bound += work.prefill_call(
                m, [(start, take)],
                int(start + take == len(r.prompt_ids)), self.peaks, rows)
            self._adm.setdefault(id(r), dict(
                chunks=[], batched=False,
                slot=slot_of.get(id(r))))["chunks"].append((start, take, rows))
        for group in _batches(batched, ts["batch_admits"]):
            n = [len(r.prompt_ids) for r in group]
            rows = len(group) * bucket(max(n))
            bound += work.prefill_call(
                m, [(0, x) for x in n], len(group), self.peaks, rows)
            for r, x in zip(group, n):
                self._adm[id(r)] = dict(chunks=[(0, x, rows)], batched=True,
                                        slot=slot_of.get(id(r)))
        if len(singles) != ts["admit_chunks"]:
            self.mismatch += 1

        ticks = ts["burst_ticks"] + ts["single_ticks"]
        rows = []
        emitted = 0
        for r in live + pend + left:
            e0, e1 = before.get(id(r), 0), len(r.output_ids)
            emitted += e1 - e0
            rows.append([len(r.prompt_ids) + j for j in range(max(e0, 1), e1)])
        for t in range(ticks):
            kv = [x[t] for x in rows if t < len(x)]
            bound += work.decode_call(m, kv, self.peaks, s["slots"])
        return Call(t0, t1, admit=ts["admit_chunks"] + ts["batch_admits"] > 0,
                    ticks=ticks, tokens=emitted, bound=bound)

    def finish(self) -> None:
        """Cancel what is still queued or running (the tail's arrivals)."""
        for _, req, _, _ in self._subs.values():
            if not req.finished:
                self.srv.cancel(req)
        self.srv.done.clear()

    def sample(self, check: dict) -> list:
        """The requests the comparison reads: finished greedy requests of
        the window (``_pick``)."""
        done = []
        for it, req, _, _ in self._subs.values():
            if it.segment == "win" and req.finished \
                    and len(req.output_ids) == it.n_out \
                    and self.greedy(it.sampling):
                adm = self._adm.get(id(req), dict(chunks=[], batched=False,
                                                  slot=None))
                done.append((it, req.output_ids, adm))
        return _pick(done, check, self.seed, self.mix)


def _batches(reqs: list, n_calls: int) -> list:
    """Split one step's batched admissions into its ``n_calls`` calls:
    the scheduler admits power-of-two batches, largest first, so the
    sizes are the set bits of their count (evenly where that disagrees)."""
    if not reqs:
        return []
    n = len(reqs)
    sizes = [1 << b for b in range(n.bit_length() - 1, -1, -1) if n >> b & 1]
    if n_calls <= 1:
        sizes = [n]
    elif len(sizes) != n_calls:
        sizes = [-(-n // n_calls)] * n_calls
    out, i = [], 0
    for size in sizes:
        out.append(reqs[i:i + size])
        i += size
    return [g for g in out if g]


def _pick(done: list, check: dict, seed: int, mix: dict) -> list:
    """A sample of ``done`` ((item, served tokens, admission) of each
    finished greedy request) drawn from the seed, until ``check["tokens"]``
    positions are compared. Each request is compared over its first
    ``check["per_request"]`` served tokens; the longest request also over
    its last ones, deep in its context. The draw favours requests by the
    tokens they bring (the reference's cost is a request's prompt).
    Requests admitted in a batch and alone are taken in turn while both
    remain, and a request in a slot the sample already holds only once no
    other is left."""
    if not done:
        return []
    per = int(check["per_request"])
    done = sorted(done, key=lambda x: x[0].index)
    longest = max(range(len(done)), key=lambda i: done[i][0].n_out)
    rest = np.array([i for i in range(len(done)) if i != longest], np.int64)
    brings = np.array([min(per, done[i][0].n_out) for i in rest], np.float64)
    perm = [int(i) for i in np.random.default_rng(
        [seed & 0xFFFFFFFF, 3]).choice(rest, size=len(rest), replace=False,
                                       p=brings / brings.sum())] \
        if len(rest) else []
    kinds = [[i for i in perm if done[i][2]["batched"] == b]
             for b in (True, False)]
    order, slots, later = [longest], {done[longest][2]["slot"]}, []
    while any(kinds):
        for queue in kinds:
            while queue:
                i = queue.pop(0)
                slot = done[i][2]["slot"]
                if slot is not None and slot in slots:
                    later.append(i)
                    continue
                slots.add(slot)
                order.append(i)
                break
    out, total = [], 0
    for i in order + later:
        it, served, adm = done[i]
        served = np.asarray(served, np.int64)
        want = np.arange(min(per, len(served)))
        if i == longest:
            want = np.union1d(want, np.arange(max(0, len(served) - per),
                                              len(served)))
        chunks = adm["chunks"] or [(0, len(it.prompt), bucket(len(it.prompt)))]
        out.append(dict(prompt=np.asarray(it.prompt, np.int64),
                        served=served, want=want, admission=chunks,
                        batched=adm["batched"], slot=adm["slot"],
                        sampling=mix["sampling"][it.sampling]))
        total += len(want)
        if total >= check["tokens"]:
            break
    return out


class ClosedLoop(Driver):
    """One stream through ``Engine.generate_device``, call after call."""

    def setup(self, trace: bool = False) -> None:
        from tinychatengine_tpu_torch.generation.engine import Engine
        self._weights()
        self.eng = Engine(self.params, self.mcfg, self.qcfg, batch=1,
                          max_len=self.server["max_len"], device=self.dev,
                          forward_fn=program.forward_fn(self.m))
        self.items = traffic.closed_loop(self.mix, self.seed, self.m.vocab)
        self._warm_up(trace)

    def _pair_item(self):
        """The set's call of median length (``step_ms``'s pair)."""
        its = sorted(self.items, key=lambda it: (it.n_out, it.index))
        return its[len(its) // 2]

    def _warm_up(self, trace: bool) -> None:
        """Every prompt bucket of the set (one token each) and every decode
        bound it reaches (a short call per ``ctx_cap``); a traced run's
        also those of ``step_ms``'s pair (its one-token call)."""
        ml = self.server["max_len"]
        g = self._gcfg(0, 1, 0)
        need = {ctx_cap(len(it.prompt) + it.n_out, ml) for it in self.items}
        if trace:
            it = self._pair_item()
            need.add(ctx_cap(len(it.prompt) + 1, ml))
        seen = set()
        by_bucket = {}
        for it in self.items:
            by_bucket.setdefault(bucket(len(it.prompt)), it)
        for it in by_bucket.values():
            self.eng.generate_device(it.prompt[None], g, n_tokens=1).cpu()
            seen.add(ctx_cap(len(it.prompt) + 1, ml))
        short = min(self.items, key=lambda it: len(it.prompt))
        p = len(short.prompt)
        for cap in sorted(need - seen):
            n = 1 if cap <= 512 else max(1, cap // 2 + 1 - p)
            self.eng.generate_device(short.prompt[None], g, n_tokens=n).cpu()
        _sync(self.dev)

    def captures(self) -> int:
        g = self.eng.graphs
        return 0 if g is None else g.captures

    def _call(self, it, traced: bool):
        ctx = (torch.profiler.record_function(CALL) if traced
               else contextlib.nullcontext())
        g = self._gcfg(it.sampling, it.n_out, 0)
        t0 = time.perf_counter()
        with ctx:
            toks = self.eng.generate_device(it.prompt[None], g,
                                            n_tokens=it.n_out).cpu()
        return t0, time.perf_counter(), toks.numpy()[0]

    def run(self, seconds: float, trace: bool, profile_s: float = 0.0
            ) -> Record:
        """Calls until ``seconds`` have passed. A traced run then records
        the set's median call (``_pair_item``) whole, after the window:
        the profiler started, warmed up by a one-token call on the same
        prompt, then recording; ``profile_s`` is not used."""
        rec = Record()
        self.profile = Profile(self.dev) if trace else None
        self.captures_before = self.captures()
        rec.t_open = time.perf_counter()
        self.outputs, done = [], []
        i = 0
        while time.perf_counter() < rec.t_open + seconds:
            it = self.items[i % len(self.items)]
            i += 1
            t0, t1, toks = self._call(it, False)
            done.append((it, t0, t1, len(toks)))
            self.outputs.append((it, toks))
        rec.notes["captures_in_window"] = self.captures() - self.captures_before
        traced = []
        if trace:
            it = self._pair_item()
            self.profile.prepare()
            self._call(dataclasses.replace(it, n_out=1), False)
            self.profile.record()
            t0, t1, toks = self._call(it, True)
            rec.profiled_s = t1 - t0
            self.profile.stop()
            traced.append((it, t0, t1, len(toks)))
            self.outputs.append((it, toks))
        for calls, runs in ((rec.calls, done), (rec.traced_calls, traced)):
            for it, t0, t1, n_toks in runs:
                n = len(it.prompt)
                b = work.prefill_call(self.m, [(0, n)], 1, self.peaks,
                                      bucket(n))
                for j in range(it.n_out):
                    b += work.decode_call(self.m, [n + 1 + j], self.peaks, 1)
                calls.append(Call(t0, t1, ticks=it.n_out, tokens=n_toks,
                                  bound=b))
        for it, t0, t1, n_toks in done:
            rec.requests.append(Req(n_prompt=len(it.prompt), n_out=it.n_out,
                                    due=t0, submit=t0, first=0.0, done=t1,
                                    emitted=n_toks))
        rec.t_close = rec.calls[-1].t1
        rec.tokens = sum(c.tokens for c in rec.calls)
        rec.deadline = rec.t_close
        return rec

    def pair_step_ms(self, pairs: int = 3) -> float:
        """(t(n) - t(1)) / (n - 1) on the set's median call, each the
        median of ``pairs`` timings (host clock ending in the fetch)."""
        it = self._pair_item()
        g_n = self._gcfg(it.sampling, it.n_out, 0)
        g_1 = self._gcfg(it.sampling, 1, 0)

        def timed(g, n):
            t0 = time.perf_counter()
            self.eng.generate_device(it.prompt[None], g, n_tokens=n).cpu()
            return time.perf_counter() - t0

        tn = [timed(g_n, it.n_out) for _ in range(pairs)]
        t1 = [timed(g_1, 1) for _ in range(pairs)]
        return (float(np.median(tn)) - float(np.median(t1))) * 1e3 \
            / (it.n_out - 1)

    def finish(self) -> None:
        pass

    def sample(self, check: dict) -> list:
        done = [(it, toks) for it, toks in self.outputs
                if len(toks) == it.n_out and self.greedy(it.sampling)]
        seen, uniq = set(), []
        for it, toks in done:  # a call repeats in a long window: once each
            if it.index not in seen:
                seen.add(it.index)
                uniq.append((it, toks, dict(chunks=[], batched=False,
                                            slot=None)))
        return _pick(uniq, check, self.seed, self.mix)


KINDS = {"open_loop": OpenLoop, "closed_loop": ClosedLoop}
