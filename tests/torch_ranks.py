"""Rank bodies of the port's multi-device tests (``test_torch_parallel``,
``test_torch_sp``, ``test_torch_pp``, ``test_torch_sp_serving`` and the
tensor-parallel cases of ``test_torch_serving``).

This module imports torch, numpy and the port only: the ranks it runs are
spawned processes that must never import JAX. A test module builds the
inputs (weights flattened from the JAX package to torch tensors), saves
them with ``torch.save``, launches one world of ranks for the module
(``world``) and compares what the ranks return with the JAX package.

Each case is ``case(rank, inp) -> result`` (numpy arrays and numbers), run
by every rank of the world in the same order; a rank outside the case's
mesh returns None.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tinychatengine_tpu_torch.core.config import (GenerationConfig,
                                                  ModelConfig, QuantConfig)
from tinychatengine_tpu_torch.generation import kv_cache as kvc
from tinychatengine_tpu_torch.generation.engine import Engine
from tinychatengine_tpu_torch.models import gptbigcode, llama, opt
from tinychatengine_tpu_torch.ops import attention as att
from tinychatengine_tpu_torch.ops import int4_matmul as int4m
from tinychatengine_tpu_torch.parallel import distributed as dist_
from tinychatengine_tpu_torch.parallel import pp, sp, tp
from tinychatengine_tpu_torch.parallel.sharding import (make_mesh,
                                                        opt_param_specs,
                                                        shard_params)
from tinychatengine_tpu_torch.runtime.serving import ServingEngine
from tinychatengine_tpu_torch.tools import scaling
from tinychatengine_tpu_torch.tools.convert import refuse_llama_tp

GREEDY = dict(temp=0.0, repeat_penalty=1.0, repeat_last_n=1)
FAMILY = {"llama": llama, "opt": opt, "gptbigcode": gptbigcode}
FOREIGN = ("jax", "jaxlib", "ml_dtypes", "tinychatengine_tpu")


def np_(t):
    return t.detach().float().cpu().numpy()


def model(inp, key="flat"):
    """(cfg, qcfg, params on the CPU) of a case's flattened weights."""
    cfg = ModelConfig(**inp["cfg"])
    qcfg = QuantConfig(**inp.get("qcfg", {}))
    mod = FAMILY[cfg.family]
    return cfg, qcfg, mod.params_from_numpy(inp[key], cfg, qcfg,
                                            device="cpu")


def cache_for(fwd, cfg, batch, max_len=None, **kw):
    init = getattr(fwd, "init_cache", kvc.init_cache)
    return init(cfg.num_layers, batch, max_len or cfg.max_sqlen,
                cfg.num_kv_heads, cfg.head_dim, device="cpu", **kw)


def ids_of(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.int64)


def foreign_modules(rank, inp):
    """The JAX-side modules this rank has imported (none, ever)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)


def rank_modules(rank, world):
    """A launched rank's own body: its JAX-side modules."""
    return foreign_modules(rank, None)


def rank_fails(rank, world):
    """A launched rank's body that raises on the last rank."""
    if rank == world - 1:
        raise ValueError(f"planted failure on rank {rank}")
    return rank


# -- tensor parallelism (test_torch_parallel) -------------------------------

def tp_logits(rank, inp):
    """Prefill logits through the TP forward over a 1 x n mesh."""
    mesh = make_mesh(1, inp["n_model"])
    if not mesh.member:
        return None
    cfg, qcfg, params = model(inp)
    fwd = tp.make_tp_forward(mesh, device="cpu")
    logits, cache = fwd(shard_params(params, mesh), cfg, ids_of(inp["ids"]),
                        cache_for(fwd, cfg, 1), 0)
    return {"logits": np_(logits), "length": cache.length}


def dp_tp_decode(rank, inp):
    """generate_device through a 2 x 4 mesh's TP forward."""
    cfg, qcfg, params = model(inp)
    mesh = make_mesh(2, 4)
    eng = Engine(shard_params(params, mesh), cfg, qcfg, batch=2,
                 device="cpu",
                 forward_fn=tp.make_tp_forward(mesh, device="cpu"))
    g = GenerationConfig(n_predict=4, **dict(GREEDY, repeat_last_n=64))
    toks = eng.generate_device(np.asarray(inp["ids"]), g, n_tokens=4)
    return {"tokens": toks.numpy(), "graphs": eng.graphs is None}


def tp_prefill_decode(rank, inp):
    """A 5-token prefill against 3 tokens then two decode steps."""
    mesh = make_mesh(1, 4)
    if not mesh.member:
        return None
    cfg, qcfg, params = model(inp)
    fwd = tp.make_tp_forward(mesh, device="cpu")
    p = shard_params(params, mesh)
    ids = ids_of(inp["ids"])
    la, _ = fwd(p, cfg, ids, cache_for(fwd, cfg, 1), 0)
    lb, cache = fwd(p, cfg, ids[:, :3], cache_for(fwd, cfg, 1), 0)
    for t in range(3, 5):
        lb, cache = fwd(p, cfg, ids[:, t:t + 1], cache, t)
    return {"la": np_(la), "lb": np_(lb)}


def opt_tp_logits(rank, inp):
    mesh = make_mesh(1, 4)
    if not mesh.member:
        return None
    cfg, qcfg, params = model(inp)
    fwd = tp.make_tp_forward(mesh, forward=opt.forward, device="cpu")
    p = shard_params(params, mesh, specs_fn=opt_param_specs)
    logits, _ = fwd(p, cfg, ids_of(inp["ids"]), cache_for(fwd, cfg, 1), 0)
    return {"logits": np_(logits)}


def tp_collectives(rank, inp):
    """Collective calls of one TP prefill and of one decode step after it
    (``distributed.STATS``)."""
    mesh = make_mesh(1, 4)
    if not mesh.member:
        return None
    cfg, qcfg, params = model(inp)
    fwd = tp.make_tp_forward(mesh, device="cpu")
    p = shard_params(params, mesh)
    ids = ids_of(inp["ids"])
    out = {}
    dist_.reset_stats()
    _, cache = fwd(p, cfg, ids, cache_for(fwd, cfg, 1), 0)
    out["prefill"] = dict(dist_.STATS)
    dist_.reset_stats()
    fwd(p, cfg, ids[:, :1], cache, ids.shape[1])
    out["decode"] = dict(dist_.STATS)
    return out


def multihost_helpers(rank, inp):
    dist_.initialize()  # a group exists: a no-op
    mesh = dist_.make_multihost_mesh(n_model=4)
    return {"info": dist_.process_info(), "shape": mesh.shape}


def scaling_run(rank, inp):
    cfg = ModelConfig(**inp["cfg"])
    qcfg = QuantConfig(scheme="fp")

    def params_fn(n_model):
        return llama.init_random_params(cfg, qcfg, seed=0, device="cpu",
                                        tp_degree=n_model)
    return scaling.run_config(params_fn, cfg, qcfg, 2, 4, prompt_len=4,
                              n_decode=3, trials=1, device="cpu")


def tp_fused_decode(rank, inp):
    """One decode step under TP with the fused decode switched on."""
    mesh = make_mesh(1, 2)
    if not mesh.member:
        return None
    cfg, qcfg, params = model(inp)
    fwd = tp.make_tp_forward(mesh, device="cpu")
    p = shard_params(params, mesh)
    _, cache = fwd(p, cfg, ids_of(inp["ids"]), cache_for(fwd, cfg, 1), 0)
    int4m.FUSED_DECODE = True
    try:
        lg, _ = fwd(p, cfg, ids_of([[7]]), cache, 6)
    finally:
        int4m.FUSED_DECODE = False
    return {"logits": np_(lg)}


def dryrun_serving_step(rank, inp):
    """Prefill and greedy decode through a 2 x 2 TP x DP mesh in a world of
    its own (the port's counterpart of scripts/dryrun_multiprocess.py)."""
    cfg, qcfg, params = model(inp)
    mesh = make_mesh(2, 2)
    p = shard_params(params, mesh)
    eng = Engine(p, cfg, qcfg, batch=2, device="cpu",
                 forward_fn=tp.make_tp_forward(mesh, device="cpu"))
    g = GenerationConfig(n_predict=4, **GREEDY)
    toks = eng.generate_device(np.asarray(inp["ids"]), g, n_tokens=4)
    return {"tokens": toks.numpy(), "info": dist_.process_info()}


# -- serving under TP (test_torch_serving) ----------------------------------

def tp_serving(rank, inp):
    """ServingEngine through a 1 x 4 TP forward, dense or paged."""
    cfg, qcfg, params = model(inp)
    mesh = make_mesh(1, 4)
    g = GenerationConfig(n_predict=inp["n_predict"], **GREEDY)
    srv = ServingEngine(shard_params(params, mesh), cfg, qcfg, slots=2,
                        gcfg=g, device="cpu",
                        forward_fn=tp.make_tp_forward(mesh, device="cpu"),
                        **inp["kw"])
    reqs = [srv.submit(np.asarray(p)) for p in inp["prompts"]]
    srv.run()
    cache = srv.page_cache if srv.paged else srv.cache
    return {"tokens": [r.output_ids for r in reqs],
            "heads": cache.k.shape[2], "graphs": srv.graphs is None}


# -- sequence parallelism (test_torch_sp) -----------------------------------

def ring(rank, inp):
    """ring_attention over an n-rank seq axis on this rank's slice."""
    n = inp["n_seq"]
    mesh = sp.make_sp_mesh(n)
    if not mesh.member:
        return None
    seq = mesh["seq"]
    q, k, v, pos = (torch.as_tensor(inp[x]) for x in ("q", "k", "v", "pos"))
    s_loc = q.shape[1] // n
    sl = slice(rank * s_loc, (rank + 1) * s_loc)
    dist_.reset_stats()
    out = att.ring_attention(q[:, sl], k[:, sl], v[:, sl], pos[:, sl], seq,
                             window=inp["window"])
    got = seq.all_gather(out, dim=1)
    return {"out": np_(got), "permutes": dist_.STATS["collective_permute"]}


def sp_prefill(rank, inp):
    """make_sp_prefill over an (n_seq, n_model) mesh, then the decode step
    from the spliced single-device cache (or full logits)."""
    mesh = sp.make_sp_mesh(inp["n_seq"], inp["n_model"])
    if not mesh.member:
        return None
    cfg, qcfg, params = model(inp)
    cfg1, _, params1 = model(inp, "flat1") if "flat1" in inp else (
        cfg, qcfg, params)
    ids = ids_of(inp["ids"])
    b, s = ids.shape
    cache = sp.shard_sp_cache(
        kvc.init_cache(cfg.num_layers, b, s, cfg.num_kv_heads, cfg.head_dim,
                       device="cpu"), mesh)
    fwd = sp.make_sp_prefill(mesh, device="cpu")
    dist_.reset_stats()
    logits, cache = fwd(shard_params(params, mesh), cfg, ids, cache,
                        true_len=inp.get("true_len"),
                        full_logits=inp.get("full_logits", False))
    stats = dict(dist_.STATS)
    out = {"logits": np_(logits), "length": cache.length, "stats": stats}
    full = kvc.init_cache(cfg.num_layers, b, cfg.max_sqlen, cfg.num_kv_heads,
                          cfg.head_dim, device="cpu")
    sp.sp_cache_into(full, cache, mesh)
    out["k"], out["v"] = np_(full.k[:, :, :, :s]), np_(full.v[:, :, :, :s])
    if "decode_tok" in inp:
        ld, _ = llama.forward(params1, cfg1, ids_of(inp["decode_tok"]), full,
                              s)
        out["decode"] = np_(ld)
    return out


# -- pipeline parallelism (test_torch_pp) -----------------------------------

def pp_run(rank, inp):
    """A prefill and ``inp["steps"]`` greedy decode steps through the PP
    forward over an (n_pipe, n_model) mesh."""
    n_model = inp.get("n_model", 1)
    mesh = pp.make_pp_mesh(inp["n_pipe"], n_model)
    if not mesh.member:
        return None
    cfg, qcfg, params = model(inp)
    mod = FAMILY[cfg.family]
    ids = ids_of(inp["ids"])
    b, s = ids.shape
    glob = kvc.init_cache(cfg.num_layers, b, cfg.max_sqlen, cfg.num_kv_heads,
                          cfg.head_dim, device="cpu",
                          quantized=inp.get("int8", False))
    p, cache = pp.shard_pp(params, glob, mesh)
    fwd = pp.make_pp_forward(mesh, inp["n_micro"], forward=mod.forward,
                             device="cpu")
    dist_.reset_stats()
    logits, cache = fwd(p, cfg, ids, cache, 0)
    out = {"logits": [np_(logits)], "length": cache.length,
           "stats": dict(dist_.STATS)}
    pipe = mesh["pipe"]  # the stages' KV gathered back over the layers
    gathered = {k: pipe.all_gather(t, dim=0) for k, t in (
        ("k", cache.k), ("v", cache.v), ("k_scale", cache.k_scale))
        if t is not None}
    if n_model > 1:
        gathered = {k: mesh["model"].all_gather(t, dim=2)
                    for k, t in gathered.items()}
    out.update({k: np_(t[:, :, :, :s]) for k, t in gathered.items()})
    if inp.get("tokens") is not None:  # the caller's tokens, teacher-forced
        toks = [ids_of(t) for t in inp["tokens"]]
    else:
        toks = None
    pos = s
    for i in range(inp.get("steps", 0)):
        tok = toks[i] if toks is not None else torch.argmax(
            logits, -1)[:, None]
        logits, cache = fwd(p, cfg, tok, cache, pos)
        out["logits"].append(np_(logits))
        pos += 1
    return out


def pp_reject_tp(rank, inp):
    cfg, qcfg, params = model(inp)
    try:
        pp._pp_param_specs(params, tp=True)
    except ValueError as exc:
        return str(exc)
    return "accepted"


# -- golden transcripts through the multi-device paths ----------------------

def _bytellama(inp):
    from tinychatengine_tpu_torch.core.config import get_model_config
    from tinychatengine_tpu_torch.tools.checkpoint import load_checkpoint
    cfg = get_model_config("bytellama_5m")
    params, qcfg = load_checkpoint(inp["ckpt"], cfg, device="cpu")
    return cfg, qcfg, params


def golden_sp_pp(rank, inp):
    """SP (4 seq ranks, a right-padded bucket) then single-device decode
    from the spliced cache; PP (4 stages, one microbatch)."""
    cfg, qcfg, params = _bytellama(inp)
    ids = np.asarray(inp["ids"])
    n, n_check = len(ids), inp["n_check"]
    mesh = sp.make_sp_mesh(4)
    bucket = -(-n // 4) * 4
    row = np.zeros((1, bucket), np.int64)
    row[0, :n] = ids
    cache = sp.shard_sp_cache(kvc.init_cache(
        cfg.num_layers, 1, bucket, cfg.num_kv_heads, cfg.head_dim,
        device="cpu"), mesh)
    logits, filled = sp.make_sp_prefill(mesh, device="cpu")(
        shard_params(params, mesh), cfg, ids_of(row), cache, true_len=n)
    full = kvc.init_cache(cfg.num_layers, 1, cfg.max_sqlen, cfg.num_kv_heads,
                          cfg.head_dim, device="cpu")
    sp.sp_cache_into(full, filled, mesh)
    got_sp, pos = [], n
    for _ in range(n_check):
        t = int(torch.argmax(logits[0]))
        got_sp.append(t)
        logits, full = llama.forward(params, cfg, ids_of([[t]]), full, pos)
        pos += 1
    mesh_pp = pp.make_pp_mesh(4)
    p, c = pp.shard_pp(params, kvc.init_cache(
        cfg.num_layers, 1, cfg.max_sqlen, cfg.num_kv_heads, cfg.head_dim,
        device="cpu"), mesh_pp)
    fwd = pp.make_pp_forward(mesh_pp, 1, device="cpu")
    logits, c = fwd(p, cfg, ids_of(ids[None]), c, 0)
    got_pp, pos = [], n
    for _ in range(n_check):
        t = int(torch.argmax(logits[0]))
        got_pp.append(t)
        logits, c = fwd(p, cfg, ids_of([[t]]), c, pos)
        pos += 1
    return {"sp": got_sp, "pp": got_pp}


def golden_sp_tp_serving(rank, inp):
    """SP admission on a 2 seq x 2 model mesh, TP decode on ranks 0-1
    (ranks 2-3 follow the host program), the golden prompt."""
    cfg, qcfg, params1 = _bytellama(inp)
    params = refuse_llama_tp(params1, cfg, tp_degree=2)
    ids = np.asarray(inp["ids"])
    n_check = inp["n_check"]
    g = GenerationConfig(n_predict=n_check, **GREEDY)
    tp_mesh = make_mesh(1, 2)
    sp_mesh = sp.make_sp_mesh(2, 2)
    srv = ServingEngine(shard_params(params, tp_mesh), cfg, qcfg, slots=2,
                        gcfg=g, device="cpu",
                        forward_fn=tp.make_tp_forward(
                            tp_mesh, followers=sp_mesh, device="cpu"),
                        sp_mesh=sp_mesh, sp_threshold=16,
                        sp_params=shard_params(params, sp_mesh))
    req = srv.submit(ids, n_predict=n_check)
    srv.run()
    return {"tokens": req.output_ids, "finished": req.finished,
            "sp_stats": srv.sp_stats}


def sp_admission(rank, inp):
    """SP admission over 4 seq ranks, plain decode on every rank."""
    cfg, qcfg, params = model(inp)
    g = GenerationConfig(n_predict=inp["n_predict"], **GREEDY)
    srv = ServingEngine(params, cfg, qcfg, slots=2, gcfg=g, device="cpu",
                        sp_mesh=sp.make_sp_mesh(4), sp_threshold=32,
                        **inp.get("kw", {}))
    reqs = [srv.submit(np.asarray(p), n_predict=inp["n_predict"])
            for p in inp["prompts"]]
    srv.run()
    return {"tokens": [r.output_ids for r in reqs],
            "finished": [r.finished for r in reqs],
            "sp_stats": srv.sp_stats}


def pp_serving_golden(rank, inp):
    """ServingEngine decoding through a 2-stage PP forward (2 slots as 2
    microbatches), the golden prompt and a second request."""
    mesh = pp.make_pp_mesh(2)
    if not mesh.member:
        return None
    cfg, qcfg, params = _bytellama(inp)
    max_len = 256
    p, c = pp.shard_pp(params, kvc.init_cache(
        cfg.num_layers, 2, max_len, cfg.num_kv_heads, cfg.head_dim,
        device="cpu"), mesh)
    g = GenerationConfig(n_predict=inp["n_check"], **GREEDY)
    srv = ServingEngine(p, cfg, qcfg, slots=2, max_len=max_len, gcfg=g,
                        device="cpu",
                        forward_fn=pp.make_pp_forward(mesh, n_micro=2,
                                                      device="cpu"))
    srv.cache = c
    req = srv.submit(np.asarray(inp["ids"]), n_predict=inp["n_check"])
    req2 = srv.submit(np.asarray(inp["other"]), n_predict=8)
    srv.run()
    return {"tokens": req.output_ids, "tokens2": req2.output_ids,
            "finished": req.finished and req2.finished}


CASES = {f.__name__: f for f in (
    foreign_modules, tp_logits, dp_tp_decode, tp_prefill_decode,
    opt_tp_logits, tp_collectives, multihost_helpers, scaling_run,
    tp_fused_decode, dryrun_serving_step, tp_serving, ring, sp_prefill,
    pp_run, pp_reject_tp, golden_sp_pp, golden_sp_tp_serving, sp_admission,
    pp_serving_golden)}


def run(rank: int, world: int, data_path: str, jobs: list) -> dict:
    """Every job (key, case name) of a module in order on this rank; the
    inputs are ``torch.load(data_path)[key]``."""
    data = torch.load(data_path, weights_only=False)
    out = {}
    with torch.inference_mode():
        for key, name in jobs:
            out[key] = CASES[name](rank, data.get(key))
    return out


def world(tmp_dir, data: dict, jobs: list, n_ranks: int):
    """Save ``data`` and launch ``n_ranks`` ranks running ``jobs`` from a
    worker thread, so the caller computes its references meanwhile;
    returns the future of the ranks' results."""
    import concurrent.futures
    import os
    path = os.path.join(str(tmp_dir), "rank_inputs.pt")
    torch.save(data, path)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        return pool.submit(dist_.launch, run, n_ranks, args=(path, jobs),
                           device="cpu")
    finally:
        pool.shutdown(wait=False)

