"""Scaling benchmark across TP x DP, SP and PP meshes of ranks (counterpart
of the JAX package's ``tools/scaling.py``).

For each mesh split it runs the port's parallel path: the device-loop
generation through the tensor-parallel forward (``--mode tp``), the
sequence-parallel ring prefill (``sp``) or the pipeline-parallel decode
(``pp``), and prints one JSON line per mesh with the same fields as the
JAX harness, plus how many ranks shared how many cards.

    python -m tinychatengine_tpu_torch.tools.scaling --model llama3_8b \\
        [--configs 1x1,1x2] [--mode tp|sp|pp] [--num-layers 4]

A mesh of one rank runs in this process; a larger one launches its ranks
(``parallel.distributed.launch``), each on card ``rank % cards`` (or the
CPU with ``--device cpu``). Ranks that share a card time-share it: such a
figure measures the parallel path's overheads, not scaling.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def run_config(params_fn, cfg, qcfg, n_data: int, n_model: int,
               prompt_len: int = 32, n_decode: int = 32, trials: int = 3,
               device=None) -> dict:
    """Decode tokens/s of ``Engine.generate_device`` through the
    tensor-parallel forward over an (n_data, n_model) mesh (run by every
    rank of the world) or, at 1 x 1, the plain forward."""
    from tinychatengine_tpu_torch.core.config import GenerationConfig
    from tinychatengine_tpu_torch.generation.engine import Engine
    from tinychatengine_tpu_torch.models import llama
    from tinychatengine_tpu_torch.parallel.sharding import (make_mesh,
                                                            shard_params)
    from tinychatengine_tpu_torch.parallel.tp import make_tp_forward

    params = params_fn(n_model)
    fwd = llama.forward
    if n_data * n_model > 1:
        mesh = make_mesh(n_data=n_data, n_model=n_model)
        params = shard_params(params, mesh)
        fwd = make_tp_forward(mesh, device=device)
    eng = Engine(params, cfg, qcfg, batch=n_data, max_len=cfg.max_sqlen,
                 forward_fn=fwd, device=device)
    g = GenerationConfig(temp=0.0, n_predict=n_decode, repeat_penalty=1.0,
                         repeat_last_n=1)
    rng = np.random.default_rng(0)  # every rank draws the same prompts

    def run(n):
        ids = rng.integers(10, cfg.vocab_size - 10, (n_data, prompt_len))
        return eng.generate_device(ids, g, n_tokens=n).cpu()

    run(1)
    run(n_decode)  # warm both lengths (the graphs of a 1 x 1 run)
    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        run(1)
        t_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        run(n_decode)
        t_l = time.perf_counter() - t0
        times.append((t_l - t_s) / (n_decode - 1))
    per_tok = float(np.median(times))
    return {"mesh": f"{n_data}x{n_model}",
            "tokens_per_s": round(n_data / per_tok, 2),
            "ms_per_token": round(per_tok * 1e3, 3)}


def run_sp_config(params_fn, cfg, qcfg, n_seq: int, n_model: int,
                  prompt_len: int = 512, trials: int = 3,
                  device=None) -> dict:
    """Latency of one sequence-parallel prefill over an (n_seq, n_model)
    mesh; 1 x 1 runs the plain prefill. The cache is made outside the
    timed region; each prefill overwrites it (start 0)."""
    from tinychatengine_tpu_torch.generation import kv_cache as kvc
    from tinychatengine_tpu_torch.models import llama
    from tinychatengine_tpu_torch.parallel.sharding import shard_params
    from tinychatengine_tpu_torch.parallel.sp import (make_sp_mesh,
                                                      make_sp_prefill,
                                                      shard_sp_cache)

    params = params_fn(n_model)
    cache = kvc.init_cache(cfg.num_layers, 1, prompt_len, cfg.num_kv_heads,
                           cfg.head_dim, device=device)
    sharded = n_seq * n_model > 1
    if sharded:
        mesh = make_sp_mesh(n_seq, n_model)
        params = shard_params(params, mesh)
        cache = shard_sp_cache(cache, mesh)
        fwd = make_sp_prefill(mesh, device=device)
    rng = np.random.default_rng(0)

    @torch.inference_mode()
    def run():
        ids = torch.as_tensor(rng.integers(10, cfg.vocab_size - 10,
                                           (1, prompt_len)), device=device)
        cache.length = 0
        if sharded:
            logits, _ = fwd(params, cfg, ids, cache)
        else:
            logits, _ = llama.forward(params, cfg, ids, cache, 0)
        return logits.cpu()  # the fetch waits for the prefill

    run()
    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    ms = float(np.median(times)) * 1e3
    return {"mesh": f"{n_seq}seq x {n_model}model",
            "prefill_ms": round(ms, 2), "prompt_len": prompt_len,
            "prefill_tokens_per_s": round(prompt_len / (ms / 1e3), 1)}


def run_pp_config(params_fn, cfg, qcfg, n_pipe: int, n_micro: int,
                  batch: int = 8, prompt_len: int = 32, n_decode: int = 16,
                  trials: int = 3, device=None) -> dict:
    """Decode tokens/s through the pipeline-parallel forward over n_pipe
    stages (GPipe, n_micro microbatches); 1 stage is the plain forward."""
    from tinychatengine_tpu_torch.generation import kv_cache as kvc
    from tinychatengine_tpu_torch.models import llama
    from tinychatengine_tpu_torch.parallel.pp import (make_pp_forward,
                                                      make_pp_mesh, shard_pp)

    params = params_fn(1)
    cache = kvc.init_cache(cfg.num_layers, batch, cfg.max_sqlen,
                           cfg.num_kv_heads, cfg.head_dim, device=device)
    fwd = llama.forward
    if n_pipe > 1:
        mesh = make_pp_mesh(n_pipe)
        params, cache = shard_pp(params, cache, mesh)
        fwd = make_pp_forward(mesh, n_micro, device=device)
    rng = np.random.default_rng(0)
    with torch.inference_mode():
        ids = torch.as_tensor(rng.integers(10, cfg.vocab_size - 10,
                                           (batch, prompt_len)),
                              device=device)
        logits, cache = fwd(params, cfg, ids, cache, 0)
        times = []
        for t in range(trials + 1):  # the first pass warms the decode step
            tok = torch.argmax(logits, -1)
            _sync(tok.device)
            t0 = time.perf_counter()
            for i in range(n_decode):
                logits, cache = fwd(params, cfg, tok[:, None], cache,
                                    prompt_len + i)
                tok = torch.argmax(logits, -1)
            tok.cpu()  # the fetch waits for the steps
            if t > 0:
                times.append((time.perf_counter() - t0) / n_decode)
    per_tok = float(np.median(times))
    return {"mesh": f"{n_pipe}pipe (M={n_micro})", "batch": batch,
            "tokens_per_s": round(batch / per_tok, 2),
            "ms_per_token": round(per_tok * 1e3, 3)}


def _params_fn(cfg, qcfg, device):
    from tinychatengine_tpu_torch.models import llama

    def params_fn(n_model):
        return llama.init_random_params(cfg, qcfg, seed=0, fast=True,
                                        tp_degree=n_model, device=device)
    return params_fn


def _rank_device(rank: int, device: str) -> str:
    """The device of a launched rank (``launch`` sets card r % cards)."""
    if device != "cuda":
        return device
    return f"cuda:{rank % torch.cuda.device_count()}"


def run_mode(mode: str, cfg, qcfg, a: int, b: int, device: str,
             prompt_len: int, n_micro: int, n_decode: int) -> dict:
    """One mesh of ``mode`` on this rank (every rank of the world)."""
    params_fn = _params_fn(cfg, qcfg, device)
    if mode == "pp":
        return run_pp_config(params_fn, cfg, qcfg, a, n_micro,
                             n_decode=n_decode, device=device)
    if mode == "sp":
        return run_sp_config(params_fn, cfg, qcfg, a, b,
                             prompt_len=prompt_len, device=device)
    return run_config(params_fn, cfg, qcfg, a, b, n_decode=n_decode,
                      device=device)


def _config_rank(rank: int, world: int, mode, cfg, qcfg, a, b, device,
                 prompt_len, n_micro, n_decode) -> dict:
    return run_mode(mode, cfg, qcfg, a, b, _rank_device(rank, device),
                    prompt_len, n_micro, n_decode)


def main(argv=None) -> list:
    from tinychatengine_tpu_torch.core.config import (QuantConfig,
                                                      get_model_config)
    from tinychatengine_tpu_torch.core.device import resolve_device
    from tinychatengine_tpu_torch.parallel.distributed import launch

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="llama3_8b")
    ap.add_argument("--scheme", default="w4a16")
    ap.add_argument("--mode", default="tp", choices=("tp", "sp", "pp"),
                    help="tp: TPxDP decode scaling; sp: sequence-parallel "
                         "prefill latency; pp: pipeline decode throughput")
    ap.add_argument("--configs", default=None,
                    help="comma list like 1x1,1x2,2x2 (default: powers of 2 "
                         "up to the cards)")
    ap.add_argument("--prompt-len", type=int, default=512,
                    help="sp mode: prefill length")
    ap.add_argument("--n-micro", type=int, default=0,
                    help="pp mode: microbatches (default = stage count)")
    ap.add_argument("--n-decode", type=int, default=32)
    ap.add_argument("--num-layers", type=int, default=0,
                    help="cut the model to this many layers (0: all); "
                         "widths are never cut")
    ap.add_argument("--device", default="cuda",
                    help="cuda (rank r on card r %% cards) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device).type
    cards = torch.cuda.device_count() if dev == "cuda" else 0
    cfg = get_model_config(args.model)
    if args.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    qcfg = QuantConfig(scheme=args.scheme)
    n_dev = max(cards, 1)
    if args.configs:
        configs = [tuple(int(x) for x in c.split("x"))
                   for c in args.configs.split(",")]
    else:
        configs = [(1, 1)]
        m = 2
        while m <= n_dev:
            configs.append((1, m))
            if n_dev // m > 1:
                configs.append((n_dev // m, m))
            m *= 2

    out, base = [], None

    def report(r):
        print(json.dumps(r), flush=True)
        out.append(r)

    for a, b in configs:
        n = a * b
        n_micro = args.n_micro or max(a, 2)
        if args.mode == "pp":  # first axis: stages; the second is ignored
            n = a
            if cfg.num_layers % a:
                report({"mesh": f"{a}pipe", "skipped":
                        f"{a} stages do not divide {cfg.num_layers} layers"})
                continue
            if 8 % n_micro:  # run_pp_config's batch of 8
                report({"mesh": f"{a}pipe", "skipped":
                        f"{n_micro} microbatches do not divide the batch "
                        f"of 8"})
                continue
        elif b > 1 and cfg.num_kv_heads % b:
            report({"mesh": f"{a}x{b}", "skipped":
                    f"TP {b} does not divide {cfg.num_kv_heads} KV heads"})
            continue
        elif args.mode == "sp" and args.prompt_len % a:
            report({"mesh": f"{a}seq", "skipped":
                    f"prompt {args.prompt_len} not divisible by {a} seq "
                    f"shards"})
            continue
        job = (args.mode, cfg, qcfg, a, b, dev, args.prompt_len, n_micro,
               args.n_decode)
        r = (run_mode(*job) if n == 1
             else launch(_config_rank, n, args=job, device=dev)[0])
        r["ranks"] = n
        r["cards"] = min(n, cards)
        r["shared"] = (f"{n} rank(s) on {r['cards']} card(s)" if cards
                       else f"{n} rank(s) on the CPU")
        if args.mode == "pp":
            base = base or r["tokens_per_s"]
            r["vs_single_device"] = round(r["tokens_per_s"] / base, 3)
        elif args.mode == "sp":
            base = base or r["prefill_ms"]
            r["speedup_vs_single"] = round(base / r["prefill_ms"], 3)
        else:
            base = base or r["tokens_per_s"]
            r["scaling_efficiency"] = round(r["tokens_per_s"] / (base * n), 3)
        report(r)
    return out


if __name__ == "__main__":
    main()
