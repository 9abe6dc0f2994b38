#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tinychatengine_tpu_torch``) on one
NVIDIA GPU. Run from the root of a checkout: ``python3 chip_smoke.py``.

Phases (any failure ends the run with a non-zero exit code):

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles every kernel under ``tinychatengine_tpu_torch/csrc``
   with nvcc, one process per source, all at once; ``int4_matmul``'s SASS
   must hold HGMMA instructions (its tile route on the tensor cores),
   ``flash_prefill``'s (both products), ``int4_matmul_kouter``'s (K-outer
   and GLU), ``int4_matmul_fused``'s and ``mlp_fused``'s (the contraction
   of ``csrc/int4_mma.cuh``) and ``int3_matmul``'s HMMA or HGMMA, and
   ``int4_matmul_a8``'s (the int8 tensor cores) IMMA or IGMMA;
3. kernels: each kernel against its plain PyTorch version on the card at
   llama3_8b's main-path and serving shapes (B = 8 slots, ragged lengths,
   a shuffled page table), with the stated tolerance, and timed beside its
   plain version, one PyTorch library call and its bound:
   ``int4_matmul_a8`` at qkv, wo, gate_up, down and the lm_head at M = 1,
   8 and 64, and gate_up at M = 100 (``A8_MAX_ROWS``); ``int4_matmul``'s
   tile route at 2048 and 64 rows (and gate_up at 512), its band route at
   M = 1 (qkv, wo, gate_up, down and the 129024-column lm_head); decode
   over 1..4095 keys (a
   4608-key cache); paged and dense
   decode of the same keys must be bit-identical, also at StarCoder's
   multi-query shape (48 query heads on one KV head); ``flash_prefill`` at
   2048 rows, 64 rows over a long prefix, the batched admission (8 ragged
   prompts of phase 5's mix in the 512-row bucket) and a 512-row chunk at
   start 3072, each start-0 case also timed beside causal SDPA
   (``library_causal_ms``); ``int8_decode`` at
   opt_6.7b's decode and serving shapes and at D = 64, held in units of
   pv_alpha (``int8_err``), its structure and splits a row printed;
   ``int4_matmul_fused`` at the fused decode's
   llama3_8b and StarCoder shapes at M = 1 and at a serving tick's 8 rows
   (``FUSED_CASES``: StarCoder's five call sites, llama3_8b's gate_up; the
   roped and the pass-through columns held apart); the int8-KV kernels
   (``flash_decode_int8``, ``flash_prefill_int8``,
   ``flash_decode_paged_int8``) at llama3_8b's decode (320 and 4095 keys),
   MQA, D = 64 with a window, B = 8 ragged over 1..4607 keys dense and
   paged (bit-identical), a 2048-token prefill and a 512-token tail at
   start 2048; the split-K kernels at llama3_8b's widths:
   ``int4_matmul_kouter`` (phase 4f's qkv, wo, gate_up and down at M = 1,
   16, 64 and 496, ``KOUTER_BLOCKS``; 496 leaves a partial 64-row tile),
   ``int4_matmul_glu`` (down from gu at M = 1, 8
   and 64; also against int4_matmul -> silu * up -> int4_matmul within
   ``GLU_COMPOSITION_TOL``), ``mlp_fused`` (the whole MLP at M = 1 and 16)
   and ``int3_matmul`` (gate_up and down widths at M = 1, 8 and 64, f32
   scales); the shapes of phases 12 and 13 (``check_vlm_spec_kernels``):
   ``flash_prefill`` at the speculative verify (8 slots of 8 rows at the
   per-row starts of phase 5's mix) and at VILA-7B's 608-token image
   prompt in the 1024 bucket (Hq = Hkv = 32), ``flash_decode`` at
   Hq = Hkv = 32 over 672 keys, ``int4_matmul_a8`` at VILA-7B's five
   linears at M = 1 and 64 and ``int4_matmul``'s tile route at its gate_up
   and down at 1024 rows;
   then opt_6.7b's W8A8 linears at M = 1, timed beside their bound, their
   int32 products checked against the CPU's;
4. main path: llama3_8b W4A8 at full width (all 32 layers, random packed
   weights from a seed) through ``Engine.generate_device`` (64-token
   prompt, 256 greedy tokens with repeat_penalty 1.1 over the last 64) and
   a 2048-token prefill; each of the path's four kernels must launch; a
   2-layer cut of the same model must agree with the plain path on the CPU;
4b. llama3_8b W4A16 fused decode: phase 4's packed weights re-wrapped as
   W4A16 (no new memory) through phase 4's run with 64 decode tokens
   (``SHORT_DECODE``), unfused and then with ``FUSED_DECODE`` on
   (``fused_ab``): one decode step launches
   ``int4_matmul`` (unfused) or ``int4_matmul_fused`` (fused) 4 * 32 + 1
   times and ``flash_decode`` 32 times, nothing else; the first decode
   step's logits of the two agree within ``FUSED_STEP_TOL``;
4f. llama3_8b W4A16 through the K-outer route (``kouter_engine``): phase
   4b's weights through phase 4's run with 64 decode tokens and
   ``DECODE_KOUTER`` listing the four stacked shapes at ``KOUTER_BLOCKS``:
   one decode step launches ``int4_matmul_kouter`` 4 * 32 times,
   ``int4_matmul`` once (the unstacked lm_head) and ``flash_decode`` 32
   times, nothing else; the 64-token prompt's prefill routes its 128
   stacked linears there, the 2048-token prefill none; the first decode
   step's logits agree with the table empty within ``KOUTER_STEP_TOL``,
   each setting after its own prefill (the empty table's 64-row prompt
   runs ``int4_matmul``'s tile route, on bf16-rounded weights) and after
   one prefill through the K-outer kernel; fed the K-outer run's tokens
   (``teacher_forced``; the K-outer setting must choose its own tokens
   again), every step lies within ``KOUTER_STEP_TOL`` of the plain
   version at the K-outer kernel's cast point (``exact_int4``, no kernel
   of the K-outer or band route) and of the table empty after the K-outer
   prefill, and against the table empty after its own prefill at least
   ``KOUTER_OWN_MIN_WITHIN`` steps lie within it with a median step gap
   of at most ``KOUTER_OWN_MEDIAN_TOL``;
   greedy tokens against phase 4b's unfused run are
   printed, with the table-empty margin where the two part; the table is
   restored after;
4c. llama3_8b W4A8 with the int8 KV cache (``kv_cache_dtype="int8"``) on
   phase 4's weights through phase 4's run: ``flash_decode_int8`` exactly
   32 times per decode step, ``flash_prefill_int8`` once per layer per
   prefill, no bf16 attention kernel and no plain version; the 2-layer cut
   against the CPU; the first decode step's logits against bf16 KV's;
4d. long-context serving on the same weights: bench_serving ``--long``'s
   mix (prompts of 3072-3967 tokens, ``max_len`` 4608) cut to 8 requests x
   64 tokens, bf16 KV dense, int8 KV dense and int8 KV paged: every
   request ends at its length, only the storage's attention kernels run;
4e. the prefix cache on the int8-KV server: 8 greedy requests sharing a
   2048-token header with 256-1024-token tails, dense with the cache, dense
   without, paged with: >= 7 hits, the same tokens in all three;
5. serving: the same model at full width through ``ServingEngine``
   (scripts/bench_serving.py's load: 8 slots, 24 requests of 32-320
   prompt tokens, 64 new tokens each, three sampling configs), once with
   the dense slot cache and once paged; every request must finish at its
   length, ``flash_decode_paged`` must launch in the paged run only, and
   no plain version of a ported kernel may run on the card;
6. real weights: ``assets/bytellama_5m`` greedy goldens and perplexity
   budgets (fp < 3.5, w4a16 <= +3 %, w4a8 <= +4 %, w4a16 and w4a8 with the
   int8 KV cache <= +4 %, through ``flash_prefill_int8`` at D = 64) on the
   card, w4a8 also over 64-token windows, where it runs the W4A8 kernel,
   and w4a16 at the band route's cast point (``exact_int4``) beside the
   tile route's, the same budget; then the goldens through ``ServingEngine`` (2 slots, dense and paged,
   fp and w4a8): fp keeps the card's golden threshold, w4a8 paged equals
   w4a8 dense;
6c. bytellama_5m requantized to W4A16 at group 32 (every linear passes
   the fused gate there): 32 greedy tokens of each golden prompt through
   ``Engine``, fused decode against unfused, >= 16 must agree;
7. OPT main path: opt_6.7b W8A8 at full width (32 layers, random int8
   weights from a seed) through ``Engine.generate_device`` with phase 4's
   settings at 128 decode tokens, TTFT and a 2048-token prefill;
   ``int8_decode`` must launch once per layer per decode step and nothing
   else, no plain version may run; a 2-layer cut must agree with the plain
   path on the CPU;
8. OPT serving: the same model through ``ServingEngine`` with the dense
   int8 slot cache (8 slots, 16 requests of bench_serving's mix, 64 new
   tokens each): every request ends at its length, ``int8_decode``
   launches once per layer per tick;
9. OPT real weights: ``assets/byteopt_4m`` calibrated to W8A8 by the port
   (``opt_real_weights``): ppl fp < 3.5 and W8A8 <= +1 %; greedy tokens on
   the card against the CPU and ServingEngine against Engine;
10. StarCoder main path: starcoder_15.5b W4A16 at full width and depth
   (40 layers, random int4 weights made on the card from a seed, one KV
   head) through phase 4b's run, unfused and then fused (``fused_ab``): 161
   fused launches per decode step when fused, none unfused, the first
   step's logits agreeing within ``FUSED_STEP_TOL``, each mode's 2-layer
   cut agreeing with the CPU's plain path;
11. StarCoder serving: the same model with the fused decode through
   ``ServingEngine`` (bench_serving's mix cut to 16 requests x 64 tokens,
   8 slots), dense then paged: every request ends at its length,
   ``flash_decode_paged`` launches in the paged run only and
   ``int4_matmul_fused`` 161 times per decode tick; its kernels' device ms
   per tick of a profiled burst is printed (``FUSED_KERNEL_NAMES``), as
   phase 5's W4A8 kernel's is (``A8_KERNEL_NAMES``);
12. logprobs and speculation (``spec_logprobs_serving``) on phase 4's
   llama3_8b W4A8 weights: phase 5's mix (8 requests x 32 tokens, every
   second with ``logprobs=5``) dense and paged through the captured ticks
   and once eager (identical), tokens equal to a run without logprobs,
   each logprob within ``LP_CARD_TOL`` of the teacher-forced eager
   forward; speculative serving (8 greedy requests on 32-token segments
   tiled to 256, x 64) against the same server without it: drafts
   accepted, tokens equal up to the first parting, which needs a plain
   top-2 margin within ``SPEC_TIE_TOL``; ``generate_pld`` (64-token
   repetitive prompt, 128 tokens, K = 7) against ``generate_device``;
13. the VLM path (``vlm_path``): CLIP ViT-L/14-336 at f32 and VILA-7B
   W4A8, a 480 x 640 image encoded at bf16, an 8 + 576 + 24-token prompt
   through ``generate_with_image``, ``generate_device`` (graphs) and an
   eager Engine (identical, 64 greedy tokens, exact launches), a second
   image, one ServingEngine request with the embeds, 2-layer cuts of the
   decoder and the tower against the CPU.

The Engine and the server run their captured CUDA graphs
(``generation/cuda_graph.py``): in phases 4, 4b, 4c, 4f, 7 and 10 the
prompt chunks and the decode step of ``generate_device`` replay graphs
(TTFT and the 2048-token prefill replay their prompt graphs, each timed
once captured), and an eager Engine (``cuda_graphs=False``) on the same
weights must choose the same greedy token at every step; phase 4 also
times the eager loop's decode rate. ``decode_profile`` replays the
captured step: its device ms by CUDA events and by kernel, busy share and
graph nodes a step. The serving phases replay the captured tick (bursts
and single ticks; admission stays eager); phase 6b runs each server again
with ``cuda_graphs=False`` and needs identical tokens, dense and paged.
Launch counts and plain-version counts are per replay
(``_build.record_launches``), so every exact count keeps its meaning.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. ``--kernels-only`` stops after phase 3.
Each phase prints its seconds.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_S = 3.35e12   # H100 SXM HBM3
BF16_FLOP_S = 989e12    # dense bf16 tensor-core peak
INT8_OP_S = 1979e12     # dense int8 tensor-core peak
MAT_TOL = 1e-2          # matmuls: max |kernel - plain| <= MAT_TOL * max |plain|
ATTN_RTOL = 2.0 ** -6   # attention, element by element: see attn_err
ATTN_TOL_TEXT = "2^-6 * (|plain| + max|plain| of the row)"
CUT_TOL = 5e-2          # 2-layer cuts: GPU kernels vs CPU plain
# fused against unfused W4A16 decode at full depth: max |diff| / max |logit|
# of the first decode step. Two functions (exact codes times f32 scales
# against bf16-rounded dequantized weights) 32-40 layers apart; a fault
# (a wrong layer, a missing bias or norm) moves the logits by O(1)
FUSED_STEP_TOL = 0.1
# the main path's kernels (Engine, phase 4); serving (phase 5) adds
# flash_decode_paged, OPT W8A8 (phases 7-9) int8_decode; a W4A16 Engine run
# (phases 4b, 10) launches W4A16_KERNELS, and int4_matmul_fused with the
# fused decode on (its prefill stays unfused); the int8 KV cache (phases
# 4c-4e, 6) swaps each attention kernel for its int8 variant (INT8_KV)
ENGINE_KERNELS = ("int4_matmul", "int4_matmul_a8", "flash_decode",
                  "flash_prefill")
W4A16_KERNELS = ("int4_matmul", "flash_decode", "flash_prefill")
# decode tokens of the runs cut to keep the whole smoke run near 700 s:
# phases 4b and 10 (W4A16 unfused and fused) decode 64 where phase 4 decodes
# 256; phase 5 serves 64 new tokens per request (bench_serving: 128) and
# phase 7 decodes 128
SHORT_DECODE = 64
# phase 4f: llama3_8b's four stacked shapes through the K-outer kernel at
# (block_n, block_k); against int4_matmul and the plain version at full
# depth, max |diff| / max |logit| of a decode step (the first, and each of
# the run's steps fed its tokens). The K-outer kernel, int4_matmul's band
# route (M = 1) and the plain version compute the exact codes times the
# scales in f32 and differ in the order of the sums only, which 32 layers
# amplify: the first step read 7.0e-3 on an H100; a fault (a wrong band,
# layer or row) moves the logits by O(1)
KOUTER_BLOCKS = (2048, 1024)
KOUTER_STEP_TOL = 0.03
# phase 12, logprobs: |served - log_softmax(teacher-forced eager forward)|
# in nats. The teacher replays the server's arithmetic (the prompt in the
# admission's 512-row bucket on the tile route, then one-row decode steps:
# int4_matmul_a8 and flash_decode give a row bits of its own at any batch)
# and may part only where the batched admission's rows round otherwise
LP_CARD_TOL = 0.05
# phase 12, speculation: a verify computes its tokens through
# flash_prefill and int4_matmul_a8 at 64 rows, plain decode through
# flash_decode at 8 rows: the attention rounds in another order (a few bf16
# steps of a row, chip_smoke.attn_err), which 32 layers carry to the
# logits as phase 4f's two cast points do (KOUTER_STEP_TOL). The greedy
# tokens may part only at a step whose plain top-2 logit margin is within
# this share of max |logit|
SPEC_TIE_TOL = KOUTER_STEP_TOL
# phase 13: the tower's 2-layer cut at f32 (``encode_hidden``, f32 out;
# TF32 off: the same products summed in another order), max |diff| over
# max |ref|. (Its bf16 cut, through ``encode_image``, ends in a bf16
# rounding, a step of 2^-8 of an element: CUT_TOL.)
CLIP_F32_CUT_TOL = 1e-3
# the table empty after its own prefill: the 64-row prompt runs
# int4_matmul's tile route on bf16-rounded weights, so its cache differs;
# uniform random bytes put -0.5 d sum(x) into every product, the logits'
# sign rides on a sum near zero, and a step can part by 2.0 of max |logit|
# (35.5 logits). Held by the count of steps within KOUTER_STEP_TOL and the
# median step gap instead: on an H100, 63 of 64 steps within, median
# 3.5e-3; a fault in the prompt's pass (a wrong layer, row or tile) moves
# every step
KOUTER_OWN_MIN_WITHIN = 60
KOUTER_OWN_MEDIAN_TOL = 0.01
INT8_KV = {"flash_decode": "flash_decode_int8",
           "flash_prefill": "flash_prefill_int8",
           "flash_decode_paged": "flash_decode_paged_int8"}


def log(*a):
    print(*a, flush=True)


def attn_err(got: torch.Tensor, want: torch.Tensor, d: int):
    """Holds an attention output to its plain version element by element:
    |got - want| <= ATTN_RTOL * (|want| + max |want| over the same head's
    row of ``d`` values). The kernels round the probabilities to bf16
    before dividing by their sum, the plain versions after, and both round
    the output to bf16: they differ by a few bf16 steps (2^-8 relative) of
    the element or of its row. A key tile left out or a mask one key off
    moves whole rows by more. Returns (max |got - want|, the largest share
    of its limit that an element takes); a case passes at a share <= 1."""
    g, w = got.float().reshape(-1, d), want.float().reshape(-1, d)
    diff = (g - w).abs()
    limit = ATTN_RTOL * (w.abs() + w.abs().amax(dim=1, keepdim=True))
    return float(diff.max()), float((diff / limit).max())


def bound(bytes_moved: float, ops: float, op_rate: float):
    t_bytes, t_ops = bytes_moved / HBM_BYTES_S, ops / op_rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _events():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of one eager call, by CUDA events over ``iters`` calls
    launched back to back: device time, or the host's launch time where that
    is longer (small shapes)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = _events()
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean device time of one call: ``iters`` calls captured in a CUDA
    graph and replayed, so host launch costs drop out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture (library init)
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0, t1 = _events()
    t0.record()
    g.replay()
    t1.record()
    torch.cuda.synchronize()
    del g
    return t0.elapsed_time(t1) / iters


def case_recorder(cases: list):
    """``add(...)``: times one kernel case (CUDA-graph and eager), its
    library call and its bound, appends the row to ``cases`` and fails the
    run if the error takes more than its tolerance."""
    def add(kernel, case, err, share, tol, run, iters, plain_ms, lib,
            bytes_moved, ops, rate, **extra):
        bms, by = bound(bytes_moved, ops, rate)
        row = dict(kernel=kernel, case=case, max_abs_err=err, err_share=share,
                   tol=tol, ms=graph_ms(run, iters),
                   eager_ms=time_ms(run, iters), plain_ms=plain_ms,
                   library_ms=graph_ms(lib, iters), bound_ms=bms, bound_by=by,
                   **extra)
        cases.append(row)
        log(json.dumps(row))
        if not share <= 1.0:
            raise SystemExit(f"{kernel} {case}: error {err} takes {share:.3f} "
                             f"of its tolerance ({tol})")
    return add


def int4_cases(gen, add, name, k, n, a8_rows, w4_rows, label=""):
    """``int4_matmul_a8`` at ``a8_rows`` and ``int4_matmul`` at ``w4_rows``
    rows against their plain versions on one random [K, N] weight stacked
    over enough layers that a timing loop cycling through them does not
    run out of the 50 MB L2; library: bf16 ``torch.matmul`` on the
    dequantized weight. ``label`` prefixes the case names."""
    from tinychatengine_tpu_torch.ops import int4_matmul as im
    from tinychatengine_tpu_torch.ops.ref import dequantize_int4
    dev = torch.device("cuda")
    n_layers = max(2, -(-200_000_000 // (k * n // 2)))
    packed = torch.randint(0, 256, (n_layers, k // 2, n), dtype=torch.uint8,
                           device=dev, generator=gen)
    scales = ((torch.rand((n_layers, k // 128, n), device=dev,
                          generator=gen) + 0.5) * 0.005).to(torch.bfloat16)
    w_lib = dequantize_int4(packed[0], scales[0], 128, torch.bfloat16)
    runs = [("int4_matmul_a8", im.int4_matmul_a8, im.int4_matmul_a8_plain,
             m, INT8_OP_S) for m in a8_rows]
    runs += [("int4_matmul", im.int4_matmul, im.int4_matmul_plain, m,
              BF16_FLOP_S) for m in w4_rows]
    for kernel, fn, plain, m, rate in runs:
        x = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
        err = share = 0.0
        for li in (0, n_layers - 1):  # stacked layer_idx
            y = fn(x, packed, scales, 128, layer_idx=li).float()
            ref = plain(x, packed, scales, 128, layer_idx=li).float()
            e = float((y - ref).abs().max())
            err = max(err, e)
            share = max(share, e / (MAT_TOL * float(ref.abs().max())))
        it = 5 if m >= 512 else 50
        state = {"li": 0}

        def run(fn=fn, x=x):
            state["li"] = (state["li"] + 1) % n_layers
            fn(x, packed, scales, 128, layer_idx=state["li"])
        plain_ms = time_ms(lambda: plain(x, packed, scales, 128,
                                         layer_idx=0), 3 if m >= 512 else 10)
        bytes_moved = m * k * 2 + k * n // 2 + (k // 128) * n * 2 + m * n * 2
        add(kernel, f"{label}{name} M={m} K={k} N={n}", err, share,
            f"{MAT_TOL} * max|plain|", run, it, plain_ms,
            lambda: torch.matmul(x, w_lib), bytes_moved, 2.0 * m * n * k,
            rate)
    del packed, scales, w_lib
    torch.cuda.empty_cache()


def check_kernels(gen):
    """Phase 3: every kernel against its plain version at the main path's
    shapes, timed. Returns one row per case."""
    from tinychatengine_tpu_torch.ops import attention as att
    dev = torch.device("cuda")
    cases = []
    add = case_recorder(cases)

    # ---- int4 matmuls (``int4_cases``)
    shapes = {"qkv": (4096, 6144), "wo": (4096, 4096),
              "gate_up": (4096, 28672), "down": (14336, 4096),
              "lm_head": (4096, 129024)}
    for name, (k, n) in shapes.items():
        # M = 1: Engine decode; 8: serving decode over 8 slots; 64: prompt;
        # 100: the most rows W4A8 takes (A8_MAX_ROWS), at gate_up
        a8_rows = (1, 8, 64, 100) if name == "gate_up" else (1, 8, 64)
        # int4_matmul's tile route at the 2048-token prefill, at the 64-row
        # prompt bucket of phases 4b and 4f (one partial 128-row tile) and
        # at gate_up's 512-row admission chunk; its band route at M = 1 at
        # every shape of the unfused W4A16 decode (down's 56 superblocks
        # leave a ragged last band) and the K-outer path's lm_head
        w4 = {"lm_head": (1,), "gate_up": (2048, 512, 64, 1),
              "down": (2048, 64, 1)}.get(name, (2048, 1))
        int4_cases(gen, add, name, k, n, a8_rows, w4)

    # ---- attention over a 32-layer stacked cache (B=1, Hkv=8, S=2048)
    # (and StarCoder's MQA: 48 query heads on one KV head, 6 blocks a row)
    L, S = 32, 2048
    for d, hq, hkv in ((128, 32, 8), (64, 32, 8), (128, 48, 1)):
        ck = torch.randn((L, 1, hkv, S, d), device=dev, generator=gen).to(torch.bfloat16)
        cv = torch.randn((L, 1, hkv, S, d), device=dev, generator=gen).to(torch.bfloat16)
        g = hq // hkv
        lengths = {(128, 32): (1, 65, 320, 2047), (64, 32): (65, 2047),
                   (128, 48): (320, 2047)}[(d, hq)]
        for length in lengths:
            q = torch.randn((1, hq, d), device=dev, generator=gen).to(torch.bfloat16)
            err = share = 0.0
            for li in (0, L - 1):
                y = att.flash_decode(q, ck, cv, li, length)
                ref = att.flash_decode_plain(q, ck, cv, li, length)
                e, sh = attn_err(y, ref, d)
                err, share = max(err, e), max(share, sh)
            state = {"li": 0}

            def run():
                state["li"] = (state["li"] + 1) % L
                att.flash_decode(q, ck, cv, state["li"], length)
            plain_ms = time_ms(lambda: att.flash_decode_plain(q, ck, cv, 0, length), 10)
            kr = ck[0, :, :, :length].repeat_interleave(g, dim=1)
            vr = cv[0, :, :, :length].repeat_interleave(g, dim=1)
            add("flash_decode", f"B=1 Hq={hq} Hkv={hkv} D={d} length={length}",
                err, share, ATTN_TOL_TEXT, run, 64, plain_ms,
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q[:, :, None], kr, vr),
                2 * hq * d * 2 + 2 * hkv * length * d * 2, 4.0 * hq * length * d,
                BF16_FLOP_S)
        for s, start in ((2048, 0), (64, S - 64)):
            if (d == 64 or hkv == 1) and s == 64:
                continue
            length = start + s
            q = torch.randn((1, s, hq, d), device=dev, generator=gen).to(torch.bfloat16)
            err = share = 0.0
            for li in (0, L - 1):
                y = att.flash_prefill(q, ck, cv, li, start, length)
                ref = att.flash_prefill_plain(q, ck, cv, li, start, length)
                assert not torch.isnan(y).any(), "NaN in flash_prefill output"
                e, sh = attn_err(y, ref, d)
                err, share = max(err, e), max(share, sh)
            it = 5 if s == 2048 else 50
            state = {"li": 0}

            def run():
                state["li"] = (state["li"] + 1) % L
                att.flash_prefill(q, ck, cv, state["li"], start, length)
            plain_ms = time_ms(lambda: att.flash_prefill_plain(
                q, ck, cv, 0, start, length), 3)
            kr = ck[0, :, :, :length].repeat_interleave(g, dim=1)
            vr = cv[0, :, :, :length].repeat_interleave(g, dim=1)
            qt = q.transpose(1, 2)
            mask = (torch.arange(length, device=dev)[None, :]
                    <= start + torch.arange(s, device=dev)[:, None])
            pairs = sum(min(start + r + 1, length) for r in range(s))
            add("flash_prefill", f"B=1 S={s} start={start} Hq={hq} Hkv={hkv} D={d}",
                err, share, ATTN_TOL_TEXT, run, it, plain_ms,
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kr, vr, attn_mask=mask),
                2 * s * hq * d * 2 + 2 * hkv * length * d * 2,
                4.0 * hq * pairs * d, BF16_FLOP_S,
                library_causal_ms=causal_ms(qt, kr, vr, it) if start == 0
                else None)
        del ck, cv
        torch.cuda.empty_cache()
    check_prefill_cases(gen, add)
    check_long_decode(gen, add)
    check_serving_kernels(gen, add)
    check_int8_kernels(gen, add)
    check_fused_kernels(gen, add)
    check_int8_kv_kernels(gen, add)
    check_split_k_kernels(gen, add)
    check_vlm_spec_kernels(gen, add)
    return cases


# phase 12's speculative verify: K drafts and the last token per slot
SPEC_K = 7
# phase 13's VILA-7B prompt: scripts/bench_vlm.py's 8 text tokens, CLIP's
# 576 patch embeddings and 24 text tokens, prefilled in the 1024 bucket
VLM_PRE, VLM_IMG, VLM_POST = 8, 576, 24
VLM_PROMPT = VLM_PRE + VLM_IMG + VLM_POST


def check_vlm_spec_kernels(gen, add):
    """The shapes phases 12 and 13 add (llama3_8b's serving verify and
    VILA-7B's group-1 attention and widths): ``flash_prefill`` at the
    speculative verify (8 slots of K + 1 = 8 rows at the per-row starts of
    phase 5's mix, 32 layers of a 2048-position slot cache) and at VILA's
    prompt (S 1024 holding the 608-token prompt, Hq = Hkv = 32);
    ``flash_decode`` at Hq = Hkv = 32 over 672 keys (the prompt and 64
    decode steps); ``int4_matmul_a8`` at VILA's five linears at M = 1 and
    64 (the speculative verify's rows); ``int4_matmul``'s tile route at
    VILA's gate_up and down at 1024 rows (the image prompt's bucket)."""
    from tinychatengine_tpu_torch.ops import attention as att
    dev = torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    vila = model_config("vila_7b")
    e, f, v = vila.embed_dim, vila.hidden_dim, 32768   # lm_head N padded
    hq = vila.num_heads
    for name, (k, n) in {"qkv": (e, 3 * e), "wo": (e, e),
                         "gate_up": (e, 2 * f), "down": (f, e),
                         "lm_head": (e, v)}.items():
        w4 = (1024,) if name in ("gate_up", "down") else ()
        int4_cases(gen, add, name, k, n, (1, 8 * (SPEC_K + 1)), w4,
                   label="vila_7b ")
    L, d = 32, 128
    starts = admission_lengths(8, model_config("llama3_8b").vocab_size)
    for b, s, smax, hq_, hkv, st, lengths, label in (
            (8, SPEC_K + 1, 2048, 32, 8, starts,
             [x + SPEC_K + 1 for x in starts],
             "spec verify B=8 S=8 Hq=32 Hkv=8 D=128 starts "
             f"{min(starts)}..{max(starts)}"),
            (1, 1024, 2048, hq, hq, [0], [VLM_PROMPT],
             f"vila_7b B=1 S=1024 length={VLM_PROMPT} Hq=32 Hkv=32 "
             "D=128")):
        ck = torch.randn((L, b, hkv, smax, d), device=dev,
                         generator=gen).to(torch.bfloat16)
        cv = torch.randn((L, b, hkv, smax, d), device=dev,
                         generator=gen).to(torch.bfloat16)
        q = torch.randn((b, s, hq_, d), device=dev,
                        generator=gen).to(torch.bfloat16)
        st_t = torch.tensor(st, dtype=torch.int32, device=dev)
        len_t = torch.tensor(lengths, dtype=torch.int32, device=dev)
        err = share = 0.0
        for li in (0, L - 1):
            y = att.flash_prefill(q, ck, cv, li, st_t, len_t)
            assert not torch.isnan(y).any(), "NaN in flash_prefill output"
            e_, sh = attn_err(y, att.flash_prefill_plain(q, ck, cv, li, st_t,
                                                         len_t), d)
            err, share = max(err, e_), max(share, sh)
        state = {"li": 0}

        def run(q=q, ck=ck, cv=cv, st_t=st_t, len_t=len_t):
            state["li"] = (state["li"] + 1) % L
            att.flash_prefill(q, ck, cv, state["li"], st_t, len_t)
        plain_ms = time_ms(lambda: att.flash_prefill_plain(
            q, ck, cv, 0, st_t, len_t), 3)
        qt = q.transpose(1, 2)
        qpos = st_t.long()[:, None, None] + torch.arange(s, device=dev)[:, None]
        mask = (torch.arange(smax, device=dev)[None, None]
                < torch.minimum(qpos + 1, len_t.long()[:, None, None]))[:, None]
        pairs = sum(min(a + r + 1, n) for a, n in zip(st, lengths)
                    for r in range(s))
        add("flash_prefill", label, err, share, ATTN_TOL_TEXT, run, 10,
            plain_ms, lambda: sdpa(qt, ck[0], cv[0], attn_mask=mask,
                                   enable_gqa=True),
            2 * b * s * hq_ * d * 2 + 2 * hkv * sum(lengths) * d * 2 + 8 * b,
            4.0 * hq_ * pairs * d, BF16_FLOP_S)
        del ck, cv
        torch.cuda.empty_cache()
    n = VLM_PROMPT + 64
    ck = torch.randn((L, 1, hq, 2048, d), device=dev,
                     generator=gen).to(torch.bfloat16)
    cv = torch.randn((L, 1, hq, 2048, d), device=dev,
                     generator=gen).to(torch.bfloat16)
    q = torch.randn((1, hq, d), device=dev, generator=gen).to(torch.bfloat16)
    err = share = 0.0
    for li in (0, L - 1):
        e_, sh = attn_err(att.flash_decode(q, ck, cv, li, n),
                          att.flash_decode_plain(q, ck, cv, li, n), d)
        err, share = max(err, e_), max(share, sh)
    state = {"li": 0}

    def run_decode():
        state["li"] = (state["li"] + 1) % L
        att.flash_decode(q, ck, cv, state["li"], n)
    add("flash_decode", f"vila_7b B=1 Hq={hq} Hkv={hq} D={d} length={n}",
        err, share, ATTN_TOL_TEXT, run_decode, 64,
        time_ms(lambda: att.flash_decode_plain(q, ck, cv, 0, n), 10),
        lambda: sdpa(q[:, :, None], ck[0, :, :, :n], cv[0, :, :, :n]),
        2 * hq * d * 2 + 2 * hq * n * d * 2, 4.0 * hq * n * d, BF16_FLOP_S)
    del ck, cv
    torch.cuda.empty_cache()


def causal_ms(qt, k, v, iters: int) -> float:
    """SDPA with ``is_causal=True`` (PyTorch's flash backend) on a start-0
    chunk's q [B, Hq, S, D] and its keys: the causal yardstick beside the
    masked call that is the table's ``library_ms``."""
    return graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, k, v, is_causal=True, enable_gqa=True), iters)


def admission_lengths(n: int, vocab: int, seed: int = 0,
                      plen=(32, 320)) -> list:
    """The prompt lengths of ``serving_load``'s first ``n`` requests
    (phase 5's mix: the same draws from ``default_rng(seed)``)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(*plen))
        rng.integers(100, vocab - 100, k)
        out.append(k)
    return out


def check_prefill_cases(gen, add):
    """``flash_prefill`` at two more main-path shapes (llama3_8b: Hq 32,
    Hkv 8, D 128, bf16, 32 layers cycled): phase 5's batched admission (8
    rows at start 0 with ragged lengths from its prompt mix, in the 512-row
    bucket, rows past a length attending to its whole prefix) and a 512-row
    chunk of a long-context prompt at start 3072 (phase 4d's admission, a
    4608-key cache). Library: SDPA with the same mask; causal: SDPA with
    ``is_causal`` over the ragged batch's full 512-row squares."""
    from tinychatengine_tpu_torch.ops import attention as att
    dev = torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    L, hq, hkv, d = 32, 32, 8, 128
    lens = admission_lengths(8, model_config("llama3_8b").vocab_size)
    for b, s, smax, start, lengths in ((8, 512, 512, 0, lens),
                                       (1, 512, 4608, 3072, (3584,))):
        ck = torch.randn((L, b, hkv, smax, d), device=dev, generator=gen).to(torch.bfloat16)
        cv = torch.randn((L, b, hkv, smax, d), device=dev, generator=gen).to(torch.bfloat16)
        q = torch.randn((b, s, hq, d), device=dev, generator=gen).to(torch.bfloat16)
        length = (torch.tensor(lengths, dtype=torch.int32, device=dev)
                  if b > 1 else lengths[0])
        st = torch.zeros(b, dtype=torch.int32, device=dev) if b > 1 else start
        err = share = 0.0
        for li in (0, L - 1):
            y = att.flash_prefill(q, ck, cv, li, st, length)
            assert not torch.isnan(y).any(), "NaN in flash_prefill output"
            e, sh = attn_err(y, att.flash_prefill_plain(q, ck, cv, li, st,
                                                        length), d)
            err, share = max(err, e), max(share, sh)
        state = {"li": 0}

        def run(q=q, ck=ck, cv=cv, st=st, length=length):
            state["li"] = (state["li"] + 1) % L
            att.flash_prefill(q, ck, cv, state["li"], st, length)
        plain_ms = time_ms(lambda: att.flash_prefill_plain(
            q, ck, cv, 0, st, length), 3)
        qt = q.transpose(1, 2)
        qpos = start + torch.arange(s, device=dev)[:, None]
        lim = torch.tensor(lengths, device=dev)[:, None, None]
        mask = (torch.arange(smax, device=dev)[None, None]
                < torch.minimum(qpos[None] + 1, lim))[:, None]
        pairs = sum(min(start + r + 1, n) for n in lengths for r in range(s))
        keys = sum(lengths)
        if b > 1:
            case = f"B={b} S={s} start=0 Hq={hq} Hkv={hkv} D={d} ragged " \
                   f"{min(lengths)}..{max(lengths)}"
        else:
            case = f"B=1 S={s} start={start} Hq={hq} Hkv={hkv} D={d}"
        add("flash_prefill", case, err, share, ATTN_TOL_TEXT, run, 10,
            plain_ms, lambda: sdpa(qt, ck[0], cv[0], attn_mask=mask,
                                   enable_gqa=True),
            2 * b * s * hq * d * 2 + 2 * hkv * keys * d * 2 + 8 * b,
            4.0 * hq * pairs * d, BF16_FLOP_S,
            library_causal_ms=causal_ms(qt, ck[0], cv[0], 10) if b > 1
            else None)
        del ck, cv
        torch.cuda.empty_cache()


def check_long_decode(gen, add):
    """bf16 ``flash_decode`` at llama3_8b's GQA over 4095 keys of a
    4608-key cache (the long-context serving mix's row), 32 layers."""
    from tinychatengine_tpu_torch.ops import attention as att
    dev = torch.device("cuda")
    L, S, hq, hkv, d, n = 32, 4608, 32, 8, 128, 4095
    ck = torch.randn((L, 1, hkv, S, d), device=dev, generator=gen).to(torch.bfloat16)
    cv = torch.randn((L, 1, hkv, S, d), device=dev, generator=gen).to(torch.bfloat16)
    q = torch.randn((1, hq, d), device=dev, generator=gen).to(torch.bfloat16)
    err = share = 0.0
    for li in (0, L - 1):
        e, sh = attn_err(att.flash_decode(q, ck, cv, li, n),
                         att.flash_decode_plain(q, ck, cv, li, n), d)
        err, share = max(err, e), max(share, sh)
    state = {"li": 0}

    def run():
        state["li"] = (state["li"] + 1) % L
        att.flash_decode(q, ck, cv, state["li"], n)
    plain_ms = time_ms(lambda: att.flash_decode_plain(q, ck, cv, 0, n), 10)
    kr = ck[0, :, :, :n].repeat_interleave(hq // hkv, dim=1)
    vr = cv[0, :, :, :n].repeat_interleave(hq // hkv, dim=1)
    add("flash_decode", f"B=1 Hq={hq} Hkv={hkv} D={d} length={n}", err,
        share, ATTN_TOL_TEXT, run, 64, plain_ms,
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], kr, vr),
        2 * hq * d * 2 + 2 * hkv * n * d * 2, 4.0 * hq * n * d, BF16_FLOP_S)
    del ck, cv, kr, vr
    torch.cuda.empty_cache()


SERVING_LENGTHS = (1, 37, 128, 129, 320, 700, 1500, 2047)


def check_serving_kernels(gen, add):
    """Decode attention at the serving shapes: 8 slots with ragged lengths,
    dense (``flash_decode``) and paged (``flash_decode_paged``, a shuffled
    page table), on the same keys, over a 32-layer stack."""
    from tinychatengine_tpu_torch.ops import attention as att
    dev = torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    S, B = 2048, len(SERVING_LENGTHS)
    lengths = torch.tensor(SERVING_LENGTHS, dtype=torch.int32, device=dev)
    # llama3_8b (GQA, page 128 and a window), bytellama's D = 64 at page 16,
    # StarCoder's MQA (one KV head: 64 layers so the cycled keys leave L2)
    for L, d, hq, hkv, p, windows in ((32, 128, 32, 8, 128, (None, 256)),
                                      (32, 64, 32, 8, 16, (None,)),
                                      (64, 128, 48, 1, 128, (None,))):
        mp = S // p
        ck = torch.randn((L, B, hkv, S, d), device=dev, generator=gen).to(torch.bfloat16)
        cv = torch.randn((L, B, hkv, S, d), device=dev, generator=gen).to(torch.bfloat16)
        # the same keys in a page pool: page 0 dead, the rest shuffled
        n_pages = B * mp + 1
        table = (torch.randperm(B * mp, device=dev, generator=gen) + 1
                 ).to(torch.int32).reshape(B, mp)

        def paged(c):
            pool = torch.zeros((L, n_pages, hkv, p, d), dtype=c.dtype, device=dev)
            pool[:, table.reshape(-1).long()] = c.reshape(
                L, B, hkv, mp, p, d).transpose(2, 3).reshape(L, B * mp, hkv, p, d)
            return pool
        pk, pv = paged(ck), paged(cv)
        q = torch.randn((B, hq, d), device=dev, generator=gen).to(torch.bfloat16)
        for window in windows:
            kept = [min(n, window or n) for n in SERVING_LENGTHS]
            kv_bytes = 2 * hkv * sum(kept) * d * 2
            io_bytes = 2 * B * hq * d * 2 + 4 * B
            ops = 4.0 * hq * sum(kept) * d
            col = torch.arange(S, device=dev)
            lo = (lengths - window).clamp(min=0) if window else 0 * lengths
            mask = ((col[None] < lengths[:, None]) & (col[None] >= lo[:, None])
                    )[:, None, None, :]
            tag = (f"B={B} Hq={hq} Hkv={hkv} D={d} ragged"
                   + (f" window={window}" if window else ""))
            for kernel in ("flash_decode", "flash_decode_paged"):
                if kernel == "flash_decode":
                    def call(li, q=q, window=window):
                        return att.flash_decode(q, ck, cv, li, lengths, window=window)

                    def plain(li, q=q, window=window):
                        return att.flash_decode_plain(q, ck, cv, li, lengths,
                                                      window=window)

                    def lib(q=q, mask=mask):
                        return sdpa(q[:, :, None], ck[0], cv[0], attn_mask=mask,
                                    enable_gqa=True)
                    extra, case = 0, tag
                else:
                    def call(li, q=q, window=window):
                        return att.flash_decode_paged(q, pk, pv, li, lengths,
                                                      table, window=window)

                    def plain(li, q=q, window=window):
                        return att.flash_decode_paged_plain(
                            q, pk, pv, li, lengths, table, window=window)

                    def lib(q=q, mask=mask):  # gather the pages, then SDPA
                        k, v = att.gather_pages(pk, pv, 0, table)
                        return sdpa(q[:, :, None], k, v, attn_mask=mask,
                                    enable_gqa=True)
                    extra = 4 * sum(-(-n // p) for n in SERVING_LENGTHS)
                    case = tag.replace(" ragged", f" P={p} ragged")
                err = share = 0.0
                for li in (0, L - 1):
                    e, sh = attn_err(call(li), plain(li), d)
                    err, share = max(err, e), max(share, sh)
                state = {"li": 0}

                def run(call=call):
                    state["li"] = (state["li"] + 1) % L
                    call(state["li"])
                plain_ms = time_ms(lambda plain=plain: plain(0), 5)
                add(kernel, case, err, share, ATTN_TOL_TEXT, run, 32, plain_ms,
                    lib, io_bytes + kv_bytes + extra, ops, BF16_FLOP_S)
            same = all(torch.equal(att.flash_decode(q, ck, cv, li, lengths,
                                                    window=window),
                                   att.flash_decode_paged(q, pk, pv, li, lengths,
                                                          table, window=window))
                       for li in (0, L - 1))
            log(f"paged == dense decode, bit for bit ({tag}): {same}")
            if not same:
                raise SystemExit("paged and dense decode of the same keys differ")
        del ck, cv, pk, pv
        torch.cuda.empty_cache()


INT8_ELEM_TOL = 2 * 128  # int8_decode, in units of pv_alpha (see int8_err)
INT8_PAIR_TOL = 0.01     # share of (row, head) pairs that may differ at all
INT8_TOL_TEXT = ("|diff| <= 256 * pv_alpha per element; <= 1 % of "
                 "(row, head) pairs differ")


def int8_err(got: torch.Tensor, want: torch.Tensor, pv_alpha: float):
    """Holds ``int8_decode`` to its plain version in units of pv_alpha
    (out / pv_alpha, rounded: the int32 PV sums). Both requantize the
    probabilities against the same stats; another exp or summation order
    can put p * 127 on the other side of a .5 boundary and move one
    probability code by one, which moves an element by |v| <= 128 units.
    Returns (max |got - want|, the share of (row, head) pairs that differ
    at all, the largest share of a limit taken)."""
    diff = (torch.round(got.float() / pv_alpha)
            - torch.round(want.float() / pv_alpha)).abs()
    pairs = float((diff.amax(dim=-1) > 0).float().mean())
    share = max(float(diff.max()) / INT8_ELEM_TOL, pairs / INT8_PAIR_TOL)
    return float((got - want).abs().max()), pairs, share


INT8_CASES = (  # (case, layers stacked, H, D, S_max, lengths)
    ("B=1 H=32 D=128 length=320", 32, 32, 128, 2048, (320,)),  # opt_6.7b
    ("B=8 H=32 D=128 ragged", 32, 32, 128, 2048, SERVING_LENGTHS),
    ("B=2 H=4 D=64 ragged", 256, 4, 64, 1024, (37, 1023)))     # byteopt_4m


def check_int8_kernels(gen, add):
    """``int8_decode`` against ``int8_decode_plain`` at opt_6.7b's decode
    shape, its serving shapes (ragged to 2047 keys, and phase 8's tick of
    short rows) and byteopt_4m's D = 64, over a layer stack
    that the timing loop cycles through (the keys come from HBM, not L2).
    Library: SDPA over the same keys cast to bf16, the nearest call (it has
    no x127 requant, so it is not the same function)."""
    from tinychatengine_tpu_torch.ops import attention as att
    dev = torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qk_alpha, pv_alpha = 3e-5, 1e-3  # scores of std ~2: a spread of codes
    # phase 8's tick: 8 slots holding the serving mix's first prompts, 32
    # tokens into their decode, in the 2048-key slot cache (short rows)
    tick = tuple(n + 32 for n in admission_lengths(
        8, model_config("opt_6.7b").vocab_size))
    for case, n_layers, h, d, smax, lengths in INT8_CASES + (
            (f"B=8 H=32 D=128 serving tick {min(tick)}..{max(tick)}", 32, 32,
             128, 2048, tick),):
        b = len(lengths)

        def s8(shape):
            return torch.randint(-127, 128, shape, dtype=torch.int8,
                                 device=dev, generator=gen)
        ck, cv = s8((n_layers, b, h, smax, d)), s8((n_layers, b, h, smax, d))
        q = s8((b, h, d))
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        ln = lengths[0] if b == 1 else lens
        err = pairs = share = 0.0
        for li in (0, n_layers - 1):
            e, p, sh = int8_err(
                att.int8_decode(q, ck, cv, li, ln, qk_alpha, pv_alpha),
                att.int8_decode_plain(q, ck, cv, li, ln, qk_alpha, pv_alpha),
                pv_alpha)
            err, pairs, share = max(err, e), max(pairs, p), max(share, sh)
        state = {"li": 0}

        def run(q=q, ck=ck, cv=cv, ln=ln):
            state["li"] = (state["li"] + 1) % n_layers
            att.int8_decode(q, ck, cv, state["li"], ln, qk_alpha, pv_alpha)
        plain_ms = time_ms(lambda: att.int8_decode_plain(
            q, ck, cv, 0, ln, qk_alpha, pv_alpha), 10)
        qb = q.to(torch.bfloat16)[:, :, None]
        if b == 1:
            kb, vb = (c[0, :, :, :lengths[0]].to(torch.bfloat16)
                      for c in (ck, cv))
            mask = None
        else:
            kb, vb = ck[0].to(torch.bfloat16), cv[0].to(torch.bfloat16)
            mask = (torch.arange(smax, device=dev)[None]
                    < lens[:, None])[:, None, None, :]

        def lib(qb=qb, kb=kb, vb=vb, mask=mask):
            return sdpa(qb, kb, vb, attn_mask=mask, scale=qk_alpha)
        keys = sum(lengths)
        add("int8_decode", case, err, share, INT8_TOL_TEXT, run, 64,
            plain_ms, lib, 2 * h * keys * d + 5 * b * h * d + 4 * b,
            4.0 * h * keys * d, INT8_OP_S, differing_pairs=pairs)
        n_split = att.int8_splits(lengths[0] if b == 1 else smax)
        log(f"int8_decode {case}: structure (a), one launch, a row's "
            f"{n_split} splits of {att.INT8_SPLIT} keys on one cluster of "
            f"{att.int8_cluster(n_split, b > 1)} blocks")
        del ck, cv, kb, vb
        torch.cuda.empty_cache()


def int8_kv(shape, gen, dev="cuda"):
    """Random int8 codes [..., D] and their positive f32 per-position
    scales [...] (kv_cache_dtype "int8"), as a K or V cache."""
    codes = torch.randint(-127, 128, shape, dtype=torch.int8, device=dev,
                          generator=gen)
    scales = torch.rand(shape[:-1], device=dev, generator=gen) * 0.03 + 0.005
    return codes, scales


def dequant(codes, scales):
    """bf16 copies of int8 codes times their scales (the library's input)."""
    return (codes.float() * scales[..., None]).to(torch.bfloat16)


# the int8-KV kernels' cases: (kernel, case, L, B, Hq, Hkv, D, S_max, lengths,
# window); decode lengths per row, prefill (S, start) in place of lengths
INT8_KV_DECODE = (
    ("B=1 Hq=32 Hkv=8 D=128 length=320", 32, 32, 8, 128, 4096, (320,), None),
    ("B=1 Hq=32 Hkv=8 D=128 length=4095", 32, 32, 8, 128, 4096, (4095,),
     None),
    ("B=1 Hq=48 Hkv=1 D=128 length=2047", 64, 48, 1, 128, 2048, (2047,),
     None),
    ("B=1 Hq=32 Hkv=8 D=64 length=2047 window=256", 32, 32, 8, 64, 2048,
     (2047,), 256))
INT8_KV_LENGTHS = (1, 37, 128, 129, 700, 1500, 3000, 4607)


def check_int8_kv_kernels(gen, add):
    """The int8-KV kernels (``flash_decode_int8``, ``flash_prefill_int8``,
    ``flash_decode_paged_int8``) against their plain versions on the card,
    held to ``attn_err``, over layer stacks the timing loop cycles
    through: decode at llama3_8b's GQA (320 and 4095 keys), MQA and D = 64
    with a window; B = 8 ragged over 1..4607 keys dense and paged (P = 128,
    a shuffled table), which must be bit-identical; prefill S = 2048 at
    start 0 and S = 512 at start 2048 (a prefix hit's tail). Bound by
    bytes: codes and scales, 2 * Hkv * length * (D + 4) per row, plus q
    and the output. Library: SDPA on bf16 copies dequantized beforehand."""
    from tinychatengine_tpu_torch.ops import attention as att
    dev = torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def kv_bytes(hkv, d, keys):
        return 2 * hkv * keys * (d + 4)

    for case, L, hq, hkv, d, smax, lengths, window in INT8_KV_DECODE:
        k, ks = int8_kv((L, 1, hkv, smax, d), gen)
        v, vs = int8_kv((L, 1, hkv, smax, d), gen)
        q = torch.randn((1, hq, d), device=dev, generator=gen).to(torch.bfloat16)
        n = lengths[0]
        err = share = 0.0
        for li in (0, L - 1):
            e, sh = attn_err(att.flash_decode(q, k, v, li, n, ks, vs,
                                              window=window),
                             att.flash_decode_plain(q, k, v, li, n, ks, vs,
                                                    window=window), d)
            err, share = max(err, e), max(share, sh)
        state = {"li": 0}

        def run(q=q, k=k, v=v, ks=ks, vs=vs, n=n, window=window, L=L):
            state["li"] = (state["li"] + 1) % L
            att.flash_decode(q, k, v, state["li"], n, ks, vs, window=window)
        lo = max(n - window, 0) if window else 0
        kd, vd = dequant(k[0, :, :, lo:n], ks[0, :, :, lo:n]), dequant(
            v[0, :, :, lo:n], vs[0, :, :, lo:n])
        plain_ms = time_ms(lambda: att.flash_decode_plain(
            q, k, v, 0, n, ks, vs, window=window), 10)
        add("flash_decode_int8", case, err, share, ATTN_TOL_TEXT, run, 64,
            plain_ms, lambda: sdpa(q[:, :, None], kd, vd, enable_gqa=True),
            2 * 1 * hq * d * 2 + kv_bytes(hkv, d, n - lo),
            4.0 * hq * (n - lo) * d, BF16_FLOP_S)
        del k, v, ks, vs, kd, vd
        torch.cuda.empty_cache()

    # B = 8 ragged, dense and paged over the same codes and scales
    L, hq, hkv, d, p, smax = 32, 32, 8, 128, 128, 4608
    b, mp = len(INT8_KV_LENGTHS), smax // p
    k, ks = int8_kv((L, b, hkv, smax, d), gen)
    v, vs = int8_kv((L, b, hkv, smax, d), gen)
    table = (torch.randperm(b * mp, device=dev, generator=gen) + 1
             ).to(torch.int32).reshape(b, mp)

    def paged(c):
        pool = torch.zeros((L, b * mp + 1, hkv, p, *c.shape[4:]),
                           dtype=c.dtype, device=dev)
        pool[:, table.reshape(-1).long()] = c.reshape(
            L, b, hkv, mp, p, *c.shape[4:]).transpose(2, 3).reshape(
                L, b * mp, hkv, p, *c.shape[4:])
        return pool
    pk, pv, pks, pvs = paged(k), paged(v), paged(ks), paged(vs)
    lengths = torch.tensor(INT8_KV_LENGTHS, dtype=torch.int32, device=dev)
    q = torch.randn((b, hq, d), device=dev, generator=gen).to(torch.bfloat16)
    mask = (torch.arange(smax, device=dev)[None] < lengths[:, None]
            )[:, None, None, :]
    kd, vd = dequant(k[0], ks[0]), dequant(v[0], vs[0])
    keys = sum(INT8_KV_LENGTHS)
    tag = f"B={b} Hq={hq} Hkv={hkv} D={d}"
    for kernel in ("flash_decode_int8", "flash_decode_paged_int8"):
        if kernel == "flash_decode_int8":
            def call(li):
                return att.flash_decode(q, k, v, li, lengths, ks, vs)

            def plain(li):
                return att.flash_decode_plain(q, k, v, li, lengths, ks, vs)
            case, extra = f"{tag} ragged 1..4607", 0
        else:
            def call(li):
                return att.flash_decode_paged(q, pk, pv, li, lengths, table,
                                              pks, pvs)

            def plain(li):
                return att.flash_decode_paged_plain(q, pk, pv, li, lengths,
                                                    table, pks, pvs)
            case = f"{tag} P={p} ragged 1..4607"
            extra = 4 * sum(-(-n // p) for n in INT8_KV_LENGTHS)
        err = share = 0.0
        for li in (0, L - 1):
            e, sh = attn_err(call(li), plain(li), d)
            err, share = max(err, e), max(share, sh)
        state = {"li": 0}

        def run(call=call):
            state["li"] = (state["li"] + 1) % L
            call(state["li"])
        plain_ms = time_ms(lambda plain=plain: plain(0), 5)
        add(kernel, case, err, share, ATTN_TOL_TEXT, run, 32, plain_ms,
            lambda: sdpa(q[:, :, None], kd, vd, attn_mask=mask,
                         enable_gqa=True),
            2 * b * hq * d * 2 + 4 * b + kv_bytes(hkv, d, keys) + extra,
            4.0 * hq * keys * d, BF16_FLOP_S)
    same = all(torch.equal(att.flash_decode(q, k, v, li, lengths, ks, vs),
                           att.flash_decode_paged(q, pk, pv, li, lengths,
                                                  table, pks, pvs))
               for li in (0, L - 1))
    log(f"int8 paged == dense decode, bit for bit ({tag} ragged): {same}")
    if not same:
        raise SystemExit("int8 paged and dense decode of the same keys differ")
    del k, v, ks, vs, pk, pv, pks, pvs, kd, vd
    torch.cuda.empty_cache()

    # prefill: a 2048-token prompt, and a 512-token tail at start 2048
    L, hq, hkv, d, smax = 32, 32, 8, 128, 4096
    k, ks = int8_kv((L, 1, hkv, smax, d), gen)
    v, vs = int8_kv((L, 1, hkv, smax, d), gen)
    for s, start in ((2048, 0), (512, 2048)):
        length = start + s
        q = torch.randn((1, s, hq, d), device=dev, generator=gen).to(torch.bfloat16)
        err = share = 0.0
        for li in (0, L - 1):
            y = att.flash_prefill(q, k, v, li, start, length, ks, vs)
            assert not torch.isnan(y).any(), "NaN in flash_prefill_int8 output"
            e, sh = attn_err(y, att.flash_prefill_plain(
                q, k, v, li, start, length, ks, vs), d)
            err, share = max(err, e), max(share, sh)
        state = {"li": 0}

        def run(q=q, start=start, length=length):
            state["li"] = (state["li"] + 1) % L
            att.flash_prefill(q, k, v, state["li"], start, length, ks, vs)
        plain_ms = time_ms(lambda: att.flash_prefill_plain(
            q, k, v, 0, start, length, ks, vs), 3)
        kd, vd = (dequant(c[0, :, :, :length], sc[0, :, :, :length])
                  for c, sc in ((k, ks), (v, vs)))
        qt = q.transpose(1, 2)
        causal = (torch.arange(length, device=dev)[None, :]
                  <= start + torch.arange(s, device=dev)[:, None])
        pairs = sum(min(start + r + 1, length) for r in range(s))
        add("flash_prefill_int8", f"B=1 S={s} start={start} Hq={hq} "
            f"Hkv={hkv} D={d}", err, share, ATTN_TOL_TEXT, run, 5, plain_ms,
            lambda: sdpa(qt, kd, vd, attn_mask=causal, enable_gqa=True),
            2 * s * hq * d * 2 + kv_bytes(hkv, d, length),
            4.0 * hq * pairs * d, BF16_FLOP_S,
            library_causal_ms=causal_ms(qt, kd, vd, 5) if start == 0
            else None)
        del kd, vd
    del k, v, ks, vs
    torch.cuda.empty_cache()


# int4_matmul_fused at the decode shapes of the fused paths: (model, linear,
# M, K, N, fused parts); M = 8 is a serving tick over 8 slots: StarCoder's
# five call sites (models/gptbigcode.py) and llama3_8b's gate_up
FUSED_CASES = (
    ("llama3_8b", "qkv", 1, 4096, 6144, ("rmsnorm", "rope")),
    ("llama3_8b", "gate_up", 1, 4096, 28672, ("rmsnorm",)),
    ("llama3_8b", "down", 1, 14336, 4096, ("residual",)),
    ("llama3_8b", "lm_head", 1, 4096, 129024, ("rmsnorm",)),
    ("starcoder", "c_attn", 1, 6144, 6400, ("layernorm", "bias")),
    ("starcoder", "fc_out", 1, 24576, 6144, ("bias", "residual")),
    ("starcoder", "c_attn", 8, 6144, 6400, ("layernorm", "bias")),
    ("starcoder", "c_proj", 8, 6144, 6144, ("bias", "residual")),
    ("starcoder", "fc_in", 8, 6144, 24576, ("layernorm", "bias")),
    ("starcoder", "fc_out", 8, 24576, 6144, ("bias", "residual")),
    ("starcoder", "lm_head", 8, 6144, 49152, ("layernorm", "bias")),
    ("llama3_8b", "gate_up", 8, 4096, 28672, ("rmsnorm",)),
)
LLAMA_QK_COLS = 5120  # llama3_8b's roped q|k columns: (32 + 8) heads of 128
FUSED_TOL_TEXT = (f"{MAT_TOL} * max|plain|, the RoPE and the pass-through "
                  "columns each against their own")


def check_fused_kernels(gen, add):
    """``int4_matmul_fused`` against its plain version at ``FUSED_CASES``,
    over a layer stack the timing loop cycles through (the weights come
    from HBM, not L2), with random norm weights, biases, residuals and
    RoPE rows. Where RoPE runs, the roped columns and the pass-through v
    columns are held apart, each to its own largest value, so a fault in
    one cannot hide behind the other's scale. Library: ``torch.matmul`` on
    the layer's bf16-dequantized weight (the yardstick of rows 1-2; it
    does none of the glue)."""
    from tinychatengine_tpu_torch.ops import int4_matmul as im
    from tinychatengine_tpu_torch.ops.ref import (dequantize_int4,
                                                  make_rope_cache)
    dev = torch.device("cuda")
    cos_t, sin_t = make_rope_cache(128, 2048, 500000.0, device=dev)

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=gen)
    for model, name, m, k, n, parts in FUSED_CASES:
        n_layers = max(2, -(-200_000_000 // (k * n // 2)))
        packed = torch.randint(0, 256, (n_layers, k // 2, n), dtype=torch.uint8,
                               device=dev, generator=gen)
        scales = ((torch.rand((n_layers, k // 128, n), device=dev,
                              generator=gen) + 0.5) * 0.005).to(torch.bfloat16)
        w_lib = dequantize_int4(packed[0], scales[0], 128, torch.bfloat16)
        x = randn(m, k).to(torch.bfloat16)
        kw, extra = {}, 0
        if "rmsnorm" in parts or "layernorm" in parts:
            kw["norm_w"] = (randn(n_layers, k) * 0.3 + 1.0).to(torch.bfloat16)
            extra += 2 * k
        if "layernorm" in parts:
            kw["norm_b"] = (randn(n_layers, k) * 0.2).to(torch.bfloat16)
            extra += 2 * k
        if "rope" in parts:
            pos = torch.randint(0, 2048, (m,), device=dev, generator=gen)
            kw.update(rope_cos=cos_t[pos], rope_sin=sin_t[pos],
                      rope_qk_cols=LLAMA_QK_COLS, head_dim=128)
            extra += 2 * m * 128 * 4
        if "bias" in parts:
            kw["bias"] = randn(n_layers, n) * 0.05  # f32, as StarCoder's
            extra += 4 * n
        if "residual" in parts:
            kw["residual"] = randn(m, n).to(torch.bfloat16)
            extra += 2 * m * n
        regions = ([slice(0, LLAMA_QK_COLS), slice(LLAMA_QK_COLS, n)]
                   if "rope" in parts else [slice(0, n)])
        err = share = 0.0
        for li in (0, n_layers - 1):
            y = im.int4_matmul_fused(x, packed, scales, 128, layer_idx=li,
                                     **kw).float()
            ref = im.int4_matmul_fused_plain(x, packed, scales, 128,
                                             layer_idx=li, **kw).float()
            for cols in regions:
                e = float((y[:, cols] - ref[:, cols]).abs().max())
                err = max(err, e)
                share = max(share, e / (MAT_TOL * float(
                    ref[:, cols].abs().max())))
        state = {"li": 0}

        def run(x=x, packed=packed, scales=scales, kw=kw, n_layers=n_layers):
            state["li"] = (state["li"] + 1) % n_layers
            im.int4_matmul_fused(x, packed, scales, 128, layer_idx=state["li"],
                                 **kw)
        plain_ms = time_ms(lambda: im.int4_matmul_fused_plain(
            x, packed, scales, 128, layer_idx=0, **kw), 3)
        bytes_moved = (k * n // 2 + (k // 128) * n * 2 + m * k * 2 + m * n * 2
                       + extra)
        add("int4_matmul_fused", f"{model} {name} M={m} K={k} N={n} "
            + "+".join(parts), err, share, FUSED_TOL_TEXT, run, 50, plain_ms,
            lambda: torch.matmul(x, w_lib), bytes_moved, 2.0 * m * n * k,
            BF16_FLOP_S, ksplit=im.fused_kernel_split(m, n, k)[1])
        del packed, scales, w_lib, kw
        torch.cuda.empty_cache()


# the unfused composition (int4_matmul gate_up -> silu * up -> int4_matmul
# down) against int4_matmul_glu on the same gu: two roundings of one
# function (silu * up rounded to bf16 by torch or by the kernel, sums in
# other orders), held as JAX's own test holds them
GLU_COMPOSITION_TOL = 0.06
# row counts of phase 3's GLU and int3 cases: decode, a serving tick's 8
# slots, a 64-row prompt bucket
GLU_ROWS = INT3_ROWS = (1, 8, 64)


def int4_stack(gen, k, n, dtype=torch.bfloat16, n_layers=None):
    """Random packed int4 weights [L, K/2, N] and scales [L, K/128, N] on
    the card, over enough layers that a loop cycling through them does not
    run in the 50 MB L2."""
    n_layers = n_layers or max(2, -(-200_000_000 // (k * n // 2)))
    packed = torch.randint(0, 256, (n_layers, k // 2, n), dtype=torch.uint8,
                           device="cuda", generator=gen)
    scales = ((torch.rand((n_layers, k // 128, n), device="cuda",
                          generator=gen) + 0.5) * 0.005).to(dtype)
    return packed, scales


def int3_dequant(pa, pb, scales, group_size=128):
    """QM_TPU3 planes → [K, N] bf16 weights, (A + 4 B - 4) * d (the
    library yardstick's operand)."""
    k, n = 4 * pa.shape[0], pa.shape[1]
    a = pa.reshape(-1, 128, n)
    qa = torch.stack([(a >> (2 * j)) & 3 for j in range(4)], 1).reshape(k, n)
    b = pb.reshape(-1, 128, n)
    qb = torch.stack([(b >> j) & 1 for j in range(8)], 1).reshape(k, n)
    w = (qa + 4 * qb).float() - 4.0
    return (w.reshape(-1, group_size, n) * scales.float()[:, None]
            ).reshape(k, n).to(torch.bfloat16)


def mat_err(y, ref):
    """(max |y - ref|, its share of MAT_TOL * max |ref|)."""
    e = float((y.float() - ref.float()).abs().max())
    return e, e / (MAT_TOL * float(ref.float().abs().max()))


def check_split_k_kernels(gen, add):
    """The K-outer, GLU, fused-MLP and int3 kernels against their plain
    versions at llama3_8b's widths, over layer stacks a timing loop cycles
    through. Library: bf16 ``torch.matmul`` on the layer's dequantized
    weights (with silu * mul for GLU and the MLP)."""
    from tinychatengine_tpu_torch.ops import int3_matmul as i3
    from tinychatengine_tpu_torch.ops import int4_matmul as im
    from tinychatengine_tpu_torch.ops import mlp_fused as mf
    from tinychatengine_tpu_torch.ops.linear import Int4Linear
    from tinychatengine_tpu_torch.ops.ref import dequantize_int4
    silu = torch.nn.functional.silu
    dev = torch.device("cuda")
    bn, bk = KOUTER_BLOCKS

    def cycle(n_layers, call):
        state = {"li": 0}

        def run():
            state["li"] = (state["li"] + 1) % n_layers
            call(state["li"])
        return run

    # ---- int4_matmul_kouter: phase 4f's four stacked shapes at decode
    # (M = 1), at 16 rows, at its prompt bucket (M = 64) and at the largest
    # bucket the route takes (496: a partial last 64-row tile)
    shapes = (("gate_up", 4096, 28672), ("down", 14336, 4096),
              ("qkv", 4096, 6144), ("wo", 4096, 4096))
    for (name, k, n), m in itertools.product(shapes, (1, 16, 64, 496)):
        packed, scales = int4_stack(gen, k, n)
        nl = packed.shape[0]
        w_lib = dequantize_int4(packed[0], scales[0], 128, torch.bfloat16)
        x = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
        kw = dict(block_n=bn, block_k=bk)
        err = share = 0.0
        for li in (0, nl - 1):
            e, sh = mat_err(
                im.int4_matmul_kouter(x, packed, scales, 128, layer_idx=li,
                                      **kw),
                im.int4_matmul_kouter_plain(x, packed, scales, 128,
                                            layer_idx=li, **kw))
            err, share = max(err, e), max(share, sh)
        plain_ms = time_ms(lambda: im.int4_matmul_kouter_plain(
            x, packed, scales, 128, layer_idx=0, **kw), 3)
        add("int4_matmul_kouter", f"{name} M={m} K={k} N={n} bn={bn} bk={bk}",
            err, share, f"{MAT_TOL} * max|plain|",
            cycle(nl, lambda li: im.int4_matmul_kouter(
                x, packed, scales, 128, layer_idx=li, **kw)),
            50 if m == 1 else 20, plain_ms, lambda: torch.matmul(x, w_lib),
            m * k * 2 + k * n // 2 + (k // 128) * n * 2 + m * n * 2,
            2.0 * m * n * k, BF16_FLOP_S, bands=k // bk)
        del packed, scales, w_lib
        torch.cuda.empty_cache()

    # ---- int4_matmul_glu: llama3_8b's down from gu, decode, 8 slots and a
    # 64-row prompt bucket; then against the unfused composition on a gu
    # made by int4_matmul
    f, n = 14336, 4096
    packed, scales = int4_stack(gen, f, n)
    nl = packed.shape[0]
    w_lib = dequantize_int4(packed[0], scales[0], 128, torch.bfloat16)
    for m in GLU_ROWS:
        gu = torch.randn((m, 2 * f), device=dev, generator=gen).to(
            torch.bfloat16)
        err = share = 0.0
        for li in (0, nl - 1):
            e, sh = mat_err(
                im.int4_matmul_glu(gu, packed, scales, 128, layer_idx=li),
                im.int4_matmul_glu_plain(gu, packed, scales, 128,
                                         layer_idx=li))
            err, share = max(err, e), max(share, sh)
        plain_ms = time_ms(lambda: im.int4_matmul_glu_plain(
            gu, packed, scales, 128, layer_idx=0), 3)
        add("int4_matmul_glu", f"down M={m} F={f} N={n}", err, share,
            f"{MAT_TOL} * max|plain|",
            cycle(nl, lambda li: im.int4_matmul_glu(gu, packed, scales, 128,
                                                    layer_idx=li)),
            50, plain_ms,
            lambda: torch.matmul(silu(gu[:, :f]) * gu[:, f:], w_lib),
            m * 2 * f * 2 + f * n // 2 + (f // 128) * n * 2 + m * n * 2,
            2.0 * m * n * f, BF16_FLOP_S, bands=im.glu_split(m, n, f)[1])
    wgu, sgu = int4_stack(gen, 4096, 2 * f, n_layers=1)
    x = torch.randn((8, 4096), device=dev, generator=gen).to(torch.bfloat16)
    gu = im.int4_matmul(x, wgu, sgu, 128, layer_idx=0)
    act = (silu(gu[:, :f].float()) * gu[:, f:].float()).to(torch.bfloat16)
    unfused = im.int4_matmul(act, packed, scales, 128, layer_idx=0)
    glu = im.int4_matmul_glu(gu, packed, scales, 128, layer_idx=0)
    diff = float((glu.float() - unfused.float()).abs().max())
    rel = diff / float(unfused.float().abs().max())
    log(f"int4_matmul_glu M=8 against int4_matmul -> silu * up -> "
        f"int4_matmul: max |diff| / max |unfused| = {rel:.3e} (tol "
        f"{GLU_COMPOSITION_TOL})")
    if not rel <= GLU_COMPOSITION_TOL:
        raise SystemExit("int4_matmul_glu disagrees with the unfused "
                         "composition")
    del packed, scales, w_lib, wgu, sgu
    torch.cuda.empty_cache()

    # ---- mlp_fused: the whole llama3_8b MLP, decode and 16 rows
    e = 4096
    n_layers = 3  # 88 MB of weights a layer
    wgu, sgu = int4_stack(gen, e, 2 * f, n_layers=n_layers)
    wdn, sdn = int4_stack(gen, f, e, n_layers=n_layers)
    lin_gu, lin_dn = Int4Linear(wgu, sgu), Int4Linear(wdn, sdn)
    lib_gu = dequantize_int4(wgu[0], sgu[0], 128, torch.bfloat16)
    lib_dn = dequantize_int4(wdn[0], sdn[0], 128, torch.bfloat16)
    for m in (1, 16):
        if not mf.mlp_fused_supported(e, f, m, 2048):
            raise SystemExit(f"mlp_fused_supported refuses llama3_8b at M={m}")
        x = (torch.randn((m, e), device=dev, generator=gen) * 0.5).to(
            torch.bfloat16)
        err = share = 0.0
        for li in (0, n_layers - 1):
            e_, sh = mat_err(mf.mlp_fused(x, lin_gu, lin_dn, li),
                             mf.mlp_fused_plain(x, lin_gu, lin_dn, li))
            err, share = max(err, e_), max(share, sh)
        plain_ms = time_ms(lambda: mf.mlp_fused_plain(x, lin_gu, lin_dn, 0),
                           3)

        def lib(x=x):
            g = torch.matmul(x, lib_gu)
            return torch.matmul(silu(g[:, :f]) * g[:, f:], lib_dn)
        add("mlp_fused", f"llama3_8b M={m} E={e} F={f} bn=2048", err, share,
            f"{MAT_TOL} * max|plain|",
            cycle(n_layers, lambda li: mf.mlp_fused(x, lin_gu, lin_dn, li)),
            20, plain_ms, lib,
            3 * e * f // 2 + (e // 128) * 2 * f * 2 + (f // 128) * e * 2
            + 2 * m * e * 2, 6.0 * m * e * f, BF16_FLOP_S)
    del wgu, sgu, wdn, sdn, lin_gu, lin_dn, lib_gu, lib_dn
    torch.cuda.empty_cache()

    # ---- int3_matmul: llama3_8b's gate_up and down widths, f32 scales, at
    # decode, 8 slots and a 64-row prompt bucket
    for (name, k, n), m in itertools.product(
            (("gate_up", 4096, 28672), ("down", 14336, 4096)), INT3_ROWS):
        nl = max(2, -(-200_000_000 // (k * n * 3 // 8)))
        layers = [(torch.randint(0, 256, (k // 4, n), dtype=torch.uint8,
                                 device=dev, generator=gen),
                   torch.randint(0, 256, (k // 8, n), dtype=torch.uint8,
                                 device=dev, generator=gen),
                   (torch.rand((k // 128, n), device=dev, generator=gen)
                    + 0.5) * 0.01) for _ in range(nl)]
        w_lib = int3_dequant(*layers[0])
        x = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
        err = share = 0.0
        for li in (0, nl - 1):
            e_, sh = mat_err(i3.int3_matmul(x, *layers[li]),
                             i3.int3_matmul_plain(x, *layers[li]))
            err, share = max(err, e_), max(share, sh)
        plain_ms = time_ms(lambda: i3.int3_matmul_plain(x, *layers[0]), 3)
        add("int3_matmul", f"{name} M={m} K={k} N={n}", err, share,
            f"{MAT_TOL} * max|plain|",
            cycle(nl, lambda li: i3.int3_matmul(x, *layers[li])), 50,
            plain_ms, lambda: torch.matmul(x, w_lib),
            k * n * 3 // 8 + (k // 128) * n * 4 + m * k * 2 + m * n * 2,
            2.0 * m * n * k, BF16_FLOP_S, bands=i3.int3_split(m, n, k)[1])
        del layers, w_lib
        torch.cuda.empty_cache()


def w8a8_linear_times(gen):
    """opt_6.7b's W8A8 linears at M = 1 (a decode step; ``s8_matmul`` pads
    the rows for ``torch._int_mm``) through ``apply_linear``, timed beside
    their byte bound, with the int32 product checked against the CPU's.
    Returns one row per shape."""
    from tinychatengine_tpu_torch.ops.linear import (W8A8Linear,
                                                     apply_linear, s8_matmul)
    dev = torch.device("cuda")
    rows = []
    for name, (k, n) in {"q/k/v/out_proj": (4096, 4096),
                         "fc1": (4096, 16384), "fc2": (16384, 4096)}.items():
        n_layers = max(2, -(-200_000_000 // (k * n)))
        w = torch.randint(-127, 128, (n_layers, n, k), dtype=torch.int8,
                          device=dev, generator=gen).transpose(1, 2)
        lin = W8A8Linear(weight=w,
                         alpha=torch.full((n_layers,), 1e-3, device=dev),
                         bias=torch.zeros((n_layers, n), device=dev))
        x = torch.randint(-127, 128, (1, k), dtype=torch.int8, device=dev,
                          generator=gen)
        exact = torch.equal(s8_matmul(x, w[1]).cpu(),
                            torch._int_mm(x.cpu(), w[1].cpu()))
        state = {"li": 0}

        def run(lin=lin, x=x, n_layers=n_layers):
            state["li"] = (state["li"] + 1) % n_layers
            apply_linear(lin, x, out_int8=True, layer_idx=state["li"])
        bms, by = bound(k * n + k + 8 * n, 2.0 * k * n, INT8_OP_S)
        # torch._int_mm alone on the padded rows, with the weight N-major
        # (W8A8Linear's layout) and row-major [K, N]
        xp = torch.nn.functional.pad(x, (0, 0, 0, 31))
        row_major = w.contiguous()

        def int_mm(weights, xp=xp, n_layers=n_layers):
            state["li"] = (state["li"] + 1) % n_layers
            torch._int_mm(xp, weights[state["li"]])
        row = dict(linear=name, K=k, N=n, M=1, exact=exact,
                   ms=graph_ms(run, 50), eager_ms=time_ms(run, 50),
                   bound_ms=bms, bound_by=by,
                   int_mm_ms=graph_ms(lambda: int_mm(lin.weight), 50),
                   int_mm_row_major_ms=graph_ms(
                       lambda: int_mm(row_major), 50))
        rows.append(row)
        log("w8a8 linear:", json.dumps(row))
        if not exact:
            raise SystemExit(f"s8_matmul {name} is not exact on the card")
        del w, lin, row_major
        torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def plain_calls():
    """Counts the calls of the ported kernels' plain versions while open (on
    the card a wrapper launches its kernel or raises: the counts must stay
    0), per replay of a graph captured meanwhile (``_build.counting``)."""
    from tinychatengine_tpu_torch.ops import attention as att
    from tinychatengine_tpu_torch.ops import int3_matmul as i3
    from tinychatengine_tpu_torch.ops import int4_matmul as im
    from tinychatengine_tpu_torch.ops import mlp_fused as mf
    names = [(att, "flash_decode_plain"), (att, "flash_prefill_plain"),
             (att, "flash_decode_paged_plain"), (att, "int8_decode_plain"),
             (im, "int4_matmul_plain"), (im, "int4_matmul_a8_plain"),
             (im, "int4_matmul_fused_plain"), (im, "int4_matmul_kouter_plain"),
             (im, "int4_matmul_glu_plain"), (mf, "mlp_fused_plain"),
             (i3, "int3_matmul_plain")]
    from tinychatengine_tpu_torch.ops import _build
    counts = dict.fromkeys((n for _, n in names), 0)
    saved = [(mod, n, getattr(mod, n)) for mod, n in names]
    for mod, n, fn in saved:
        def counted(*a, _fn=fn, _n=n, **kw):
            counts[_n] += 1
            return _fn(*a, **kw)
        setattr(mod, n, counted)
    try:  # registered: a graph captured meanwhile adds its calls per replay
        with _build.counting(counts):
            yield counts
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)


def random_model(cfg, dev, max_pos=None):
    """The random full-width model of a phase, made on ``dev`` from a
    seeded generator: llama W4A8 or GPTBigCode W4A16 (packed int4) or opt
    W8A8 (int8). Returns (params, qcfg)."""
    from tinychatengine_tpu_torch.core.config import QuantConfig
    from tinychatengine_tpu_torch.models import gptbigcode, llama, opt
    t0 = time.perf_counter()
    if cfg.family == "llama":
        qcfg = QuantConfig(scheme="w4a8", group_size=128)
        params = llama.init_random_params(cfg, qcfg, seed=0, max_pos=max_pos,
                                          fast=True, device=dev)
    elif cfg.family == "gptbigcode":
        qcfg = QuantConfig(scheme="w4a16", group_size=128)
        params = gptbigcode.init_random_params(cfg, seed=0, qcfg=qcfg,
                                               fast=True, device=dev)
    else:
        qcfg = QuantConfig(scheme="w8a8")
        params = opt.init_random_params(cfg, quantized=True, seed=0,
                                        fast=True, device=dev)
    if dev == "cuda":
        torch.cuda.synchronize()
    log(f"{cfg.name} {qcfg.scheme} random init: "
        f"{time.perf_counter() - t0:.1f} s")
    return params, qcfg


def model_config(model):
    """A registry name, or a ``ModelConfig`` as it is (CPU rehearsals of a
    family whose registry models are all full size)."""
    from tinychatengine_tpu_torch.core.config import get_model_config
    return get_model_config(model) if isinstance(model, str) else model


@contextlib.contextmanager
def fused_decode(on: bool):
    """``FUSED_DECODE`` set to ``on`` while open."""
    from tinychatengine_tpu_torch.ops import int4_matmul as im
    saved = im.FUSED_DECODE
    im.FUSED_DECODE = on
    try:
        yield
    finally:
        im.FUSED_DECODE = saved


@contextlib.contextmanager
def kouter_table(table: dict):
    """``DECODE_KOUTER`` replaced by ``table`` while open, restored after."""
    from tinychatengine_tpu_torch.ops import int4_matmul as im
    saved = im.DECODE_KOUTER
    im.DECODE_KOUTER = dict(table)
    try:
        yield
    finally:
        im.DECODE_KOUTER = saved


def exact_int4_matmul(x, packed, scales, group_size: int = 128, *,
                      layer_idx=None) -> torch.Tensor:
    """``int4_matmul``'s function at the TPU kernel's cast point (exact
    codes, f32 scales once per group: ``factored_int4``), in plain PyTorch
    on x's device, bf16 out. The cast point of the band and K-outer routes,
    computed by none of their kernels."""
    from tinychatengine_tpu_torch.ops import int4_matmul as im
    if layer_idx is not None:
        packed, scales = packed[layer_idx], scales[layer_idx]
    k, kw = x.shape[-1], 2 * packed.shape[-2]
    x2 = x.reshape(-1, k).to(torch.bfloat16)
    if kw > k:  # pack-padded K: the pad codes meet zeros
        x2 = torch.nn.functional.pad(x2, (0, kw - k))
    y = im.factored_int4(x2, packed, scales, group_size)
    return y.to(torch.bfloat16).reshape(*x.shape[:-1], -1)


@contextlib.contextmanager
def exact_int4():
    """Every W4A16 linear (``ops.linear``'s ``int4_matmul``) computed by
    ``exact_int4_matmul`` while open, restored after."""
    from tinychatengine_tpu_torch.ops import linear
    saved = linear.int4_matmul
    linear.int4_matmul = exact_int4_matmul
    try:
        yield
    finally:
        linear.int4_matmul = saved


def as_w4a16(p):
    """The same tree with every W4A8 container re-wrapped as W4A16 over the
    same packed bytes (no new memory)."""
    from tinychatengine_tpu_torch.ops.linear import Int4A8Linear, Int4Linear
    if isinstance(p, Int4A8Linear):
        return Int4Linear(packed=p.packed, scales=p.scales, bias=p.bias)
    if p is None or isinstance(p, torch.Tensor):
        return p
    return type(p)(**{f.name: as_w4a16(getattr(p, f.name))
                      for f in dataclasses.fields(p)})


def tree_map(p, fn):
    """``fn`` over every tensor leaf of a parameter dataclass tree."""
    if p is None or isinstance(p, torch.Tensor):
        return None if p is None else fn(p)
    return type(p)(**{f.name: tree_map(getattr(p, f.name), fn)
                      for f in dataclasses.fields(p)})


def cut_params(p, n_layers: int, where):
    """The first ``n_layers`` layers of a layer-stacked model, on ``where``."""
    head = tree_map(dataclasses.replace(p, layers=None), lambda t: t.to(where))
    return dataclasses.replace(head, layers=tree_map(
        p.layers, lambda t: t[:n_layers].to(where)))


def main_path(model="llama3_8b", dev="cuda", long_len=2048, fused=False,
              model_params=None, n_predict=256, eager_rate=False):
    """Phase 4 (llama3_8b W4A8), 7 (opt_6.7b W8A8) or one mode of
    ``fused_ab`` (phases 4b and 10): ``model`` (a registry name or a
    ``ModelConfig``) at full width through the Engine, with
    ``FUSED_DECODE`` set to ``fused``. ``model_params``: (params, qcfg) of a
    model already on ``dev``, else a random one is made. The Engine runs
    its captured graphs; an eager Engine (``cuda_graphs=False``) on the
    same weights must choose the same greedy tokens at every step, and
    with ``eager_rate`` its decode rate is timed too. Returns (launches of
    the run, launches of one decode step, metrics). The arguments shrink
    the run for a rehearsal on the CPU (tests)."""
    with fused_decode(fused):
        return _engine_run(model_config(model), dev, long_len, model_params,
                           n_predict, eager_rate)


def greedy_config(n_predict):
    """The Engine runs' sampling: greedy under a repeat penalty."""
    from tinychatengine_tpu_torch.core.config import GenerationConfig
    return GenerationConfig(temp=0.0, n_predict=n_predict, repeat_penalty=1.1,
                            repeat_last_n=64)


DECODE_TRIALS = 3  # decode_rate's trials: each time is their median


def decode_rate(eng, prompt, gcfg, n_predict, sync):
    """(n - 1) / (t(n tokens) - t(1 token)) of ``eng.generate_device``,
    each time the median of ``DECODE_TRIALS`` runs (a 1-token run, then an
    n-token run, in turn), with the n-token runs' tokens (which must not
    change from trial to trial) and both times."""
    def gen_s(n):
        sync()
        t = time.perf_counter()
        out = eng.generate_device(prompt, gcfg, n_tokens=n).cpu()
        return time.perf_counter() - t, out
    t1s, tns, runs = [], [], []
    for _ in range(DECODE_TRIALS):
        t1s.append(gen_s(1)[0])
        tn, toks = gen_s(n_predict)
        tns.append(tn)
        runs.append(toks)
    if any(not torch.equal(r, runs[0]) for r in runs):
        raise SystemExit("greedy decode tokens changed from trial to trial")
    t1, tn = float(np.median(t1s)), float(np.median(tns))
    return (n_predict - 1) / (tn - t1), runs[0], t1, tn


def _engine_run(cfg, dev, long_len, model_params, n_predict, eager_rate):
    from tinychatengine_tpu_torch.generation import sampling
    from tinychatengine_tpu_torch.generation.engine import (
        Engine, forward_for_family)
    from tinychatengine_tpu_torch.ops import _build
    from tinychatengine_tpu_torch.ops import int4_matmul as im

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    fused, kouter = im.FUSED_DECODE, bool(im.DECODE_KOUTER)
    forward = forward_for_family(cfg.family)
    params, qcfg = model_params or random_model(cfg, dev)
    int8_kv = qcfg.kv_cache_dtype == "int8" and cfg.family != "opt"
    label = (f"{cfg.name} {qcfg.scheme}" + (" fused" if fused else "")
             + (" K-outer" if kouter else "")
             + (" int8 KV" if int8_kv else ""))
    eng = Engine(params, cfg, qcfg, batch=1, max_len=long_len, device=dev)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (1, 64))
    long_prompt = rng.integers(0, cfg.vocab_size, (1, long_len))
    gcfg = greedy_config(n_predict)
    # the timed prompts' caches (the graphs run in the engine's own cache
    # and copy the prompt's positions out to these)
    pre_cache, ttft_cache = eng.new_cache(), eng.new_cache()

    def prefill_s():
        pre_cache.length = 0
        sync()
        t = time.perf_counter()
        logits, cache = eng.prefill(long_prompt, pre_cache)
        sync()
        return time.perf_counter() - t, logits, cache

    def ttft_s():
        ttft_cache.length = 0
        sync()
        t = time.perf_counter()
        logits, _ = eng.prefill(prompt, ttft_cache)
        state = sampling.SamplerState.init(0, 1, 5.0, dev)
        tok, _ = sampling.sample(logits, state, gcfg, None)
        tok.cpu()
        return time.perf_counter() - t

    # the plain calls are counted from before the warm-up, which captures
    # every graph the timed runs replay (prompt buckets, the decode step):
    # a plain version captured into a graph counts at each replay
    with plain_calls() as plain:
        eng.generate_device(prompt, gcfg, n_tokens=2)
        prefill_s()
        ttft_s()
        _build.reset_launches()
        rate, toks, t1, tn = decode_rate(eng, prompt, gcfg, n_predict, sync)
        ttft = ttft_s()
        t_pre, logits, cache = prefill_s()
        launches = dict(_build.LAUNCHES)
    log(f"{label} main-path launches:", json.dumps(launches),
        "plain calls:", json.dumps(plain))
    # the eager loop on the same weights: the same greedy token at every
    # step (and, for phase 4, its decode rate beside the graphs')
    eager = Engine(params, cfg, qcfg, batch=1, max_len=long_len, device=dev,
                   cuda_graphs=False)
    if eager_rate:
        eager.generate_device(prompt, gcfg, n_tokens=2)
        eager_tok_s, eager_toks, _, _ = decode_rate(eager, prompt, gcfg,
                                                    n_predict, sync)
    else:
        eager_toks = eager.generate_device(prompt, gcfg,
                                           n_tokens=n_predict).cpu()
    del eager
    same = next((i for i, (a, b) in enumerate(
        zip(toks[0].tolist(), eager_toks[0].tolist())) if a != b), None)
    log(f"{label} graph vs eager greedy tokens: "
        + ("equal at every step" if same is None else f"part at step {same}"))
    if same is not None:
        raise SystemExit(f"{label}: graph tokens part from the eager loop's "
                         f"at step {same}")

    with torch.inference_mode():  # launches of one (eager) decode step
        eng.prefill(prompt, ttft_cache)
        _build.reset_launches()
        forward(params, cfg, torch.tensor([[1]], device=dev), ttft_cache, 64)
    per_step = dict(_build.LAUNCHES)
    if dev == "cuda":
        if any(plain.values()):
            raise SystemExit(f"plain versions ran on the card: {plain}")
        # opt: int8_decode once per layer per decode step (1 + n_predict
        # steps a trial), and nothing else; W4A16: each linear (4 per layer
        # and the head) through one matmul kernel per step, fused or not,
        # and one flash_decode per layer
        nl = cfg.num_layers
        n_prefills = 2 * DECODE_TRIALS + 2  # the trials', TTFT, long prompt
        want = ({"int8_decode": DECODE_TRIALS * (n_predict + 1) * nl}
                if cfg.family == "opt" else None)
        if want is not None and {k: v for k, v in launches.items() if v} \
                != want:
            raise SystemExit(f"{label}: launches {launches}, want {want}")
        kernels = (ENGINE_KERNELS if qcfg.scheme == "w4a8" else
                   W4A16_KERNELS + (("int4_matmul_fused",) if fused else ())
                   + (("int4_matmul_kouter",) if kouter else ()))
        if int8_kv:  # each attention kernel's int8 variant, and only it
            kernels = tuple(INT8_KV.get(k, k) for k in kernels)
            mm = ("int4_matmul_a8" if qcfg.scheme == "w4a8" else
                  "int4_matmul_fused" if fused else "int4_matmul")
            step_want = {mm: 4 * nl + 1, "flash_decode_int8": nl}
            if any(launches[k] for k in INT8_KV) or launches[
                    "flash_prefill_int8"] != n_prefills * nl or {
                        k: v for k, v in per_step.items() if v} != step_want:
                raise SystemExit(f"{label}: launches {launches}, per decode "
                                 f"step {per_step}, want {step_want} per "
                                 f"step and {n_prefills * nl} "
                                 f"flash_prefill_int8 ({n_prefills} "
                                 "prefills)")
        if want is None and not all(launches[k] > 0 for k in kernels):
            raise SystemExit(f"a kernel was never launched on the main path: "
                             f"{launches}")
        if qcfg.scheme == "w4a16":
            mm = "int4_matmul_fused" if fused else "int4_matmul"
            step_want = {mm: 4 * nl + 1, "flash_decode": nl}
            if kouter:  # the stacked linears K-outer, the head unstacked
                step_want = {"int4_matmul_kouter": 4 * nl, "int4_matmul": 1,
                             "flash_decode": nl}
            if {k: v for k, v in per_step.items() if v} != step_want or (
                    not fused and launches["int4_matmul_fused"]):
                raise SystemExit(f"{label}: launches per decode step "
                                 f"{per_step}, want {step_want}")
    if toks.shape != (1, n_predict) or int(toks.min()) < 0 \
            or int(toks.max()) >= cfg.vocab_size:
        raise SystemExit(f"bad decode tokens {toks.shape}")
    if logits.shape != (1, cfg.vocab_size) or not torch.isfinite(logits).all() \
            or cache.length != long_len:
        raise SystemExit("bad long-prompt prefill output")

    decode_tok_s = rate
    metrics = dict(decode_tok_s=decode_tok_s, ttft_ms=ttft * 1e3,
                   prefill_tok_s=long_len / t_pre, gen_n_s=tn, gen1_s=t1,
                   prefill_s=t_pre, graph_eq_eager=same is None)
    if eager_rate:
        metrics["eager_decode_tok_s"] = eager_tok_s
    if dev == "cuda":
        metrics["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        metrics.update(decode_profile(eng, 1e3 / decode_tok_s))
    if eng.graphs is not None:  # what the captures cost, once an engine
        metrics.update(graph_captures=eng.graphs.captures,
                       graph_capture_s=eng.graphs.capture_s)
    log(f"{label} main-path metrics:", json.dumps(metrics))
    metrics["tokens"] = toks[0].tolist()  # the greedy run, for comparisons

    # a 2-layer cut at full width: kernels on the card against the plain
    # path on the CPU, 64-token prefill then 2 decode steps
    cut = dataclasses.replace(cfg, num_layers=2)
    outs = {}
    with torch.inference_mode():
        for where in (dev, "cpu"):
            p = cut_params(params, 2, where)
            cache_c = Engine(p, cut, qcfg, max_len=128,
                             device=where).new_cache()
            ids = torch.as_tensor(prompt, device=where)
            seq = [forward(p, cut, ids, cache_c, 0)[0].float().cpu()]
            for step, t in enumerate((11, 22)):
                seq.append(forward(p, cut, torch.tensor([[t]], device=where),
                                   cache_c, 64 + step)[0].float().cpu())
            outs[where] = seq
            del p, cache_c
    errs = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(outs[dev], outs["cpu"])]
    metrics["cut_err"] = max(errs)
    log(f"{label} 2-layer cut, kernels vs CPU plain: max |diff| / max |ref| "
        f"= {max(errs):.3e} (tol {CUT_TOL})")
    if not max(errs) <= CUT_TOL:
        raise SystemExit("2-layer cut disagrees with the plain path")
    del params, eng
    if dev == "cuda":
        torch.cuda.empty_cache()
    return launches, per_step, metrics


def fused_ab(model, dev="cuda", long_len=2048, model_params=None,
             n_predict=256):
    """Phases 4b (llama3_8b W4A16 on phase 4's weights) and 10
    (starcoder_15.5b W4A16): phase 4's Engine run unfused, then with the
    fused decode, on the same weights; then the first decode step of each
    after the same 64-token prompt, whose logits must agree within
    ``FUSED_STEP_TOL``. Returns {"unfused": (launches, per_step, metrics),
    "fused": (...), "first_step": {...}}."""
    cfg = model_config(model)
    params, qcfg = model_params or random_model(cfg, dev)
    out = {mode: main_path(cfg, dev, long_len, fused=mode == "fused",
                           model_params=(params, qcfg), n_predict=n_predict)
           for mode in ("unfused", "fused")}
    out["first_step"] = first_step_diff(params, cfg, (qcfg, False),
                                        (qcfg, True), dev)
    log(f"{cfg.name} first decode step, fused vs unfused: max |diff| / "
        f"max |logit| = {out['first_step']['rel_diff']:.3e} (tol "
        f"{FUSED_STEP_TOL}), same argmax {out['first_step']['same_argmax']}")
    if not out["first_step"]["rel_diff"] <= FUSED_STEP_TOL:
        raise SystemExit(f"{cfg.name}: fused decode disagrees with unfused")
    del params
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def first_step_diff(params, cfg, a, b, dev, prefill_table=None):
    """The first decode step's logits after the same 64-token prompt under
    two (qcfg, fused) or (qcfg, fused, K-outer table) settings ``a`` and
    ``b``: max |b - a| absolute and over max |a|, and whether the argmax
    agrees. With ``prefill_table`` both prompts are prefilled under that
    K-outer table, so only the decode step's routes differ."""
    from tinychatengine_tpu_torch.generation.engine import (
        Engine, forward_for_family)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 64))
    forward = forward_for_family(cfg.family)
    logits = []
    for qcfg, fused, *table in (a, b):
        table = table[0] if table else {}
        with fused_decode(fused), torch.inference_mode():
            eng = Engine(params, cfg, qcfg, max_len=128, device=dev,
                         cuda_graphs=False)
            cache = eng.new_cache()
            with kouter_table(table if prefill_table is None
                              else prefill_table):
                eng.prefill(prompt, cache)
            with kouter_table(table):
                logits.append(forward(params, cfg,
                                      torch.tensor([[1]], device=dev), cache,
                                      64)[0].float())
            del cache
    diff = float((logits[1] - logits[0]).abs().max())
    return dict(max_abs_diff=diff,
                rel_diff=diff / float(logits[0].abs().max()),
                same_argmax=bool(torch.equal(logits[0].argmax(-1),
                                             logits[1].argmax(-1))))


def stacked_shapes(params) -> list:
    """(packed K, N) of a llama model's four stacked linears."""
    lyr = params.layers
    return [(2 * p.packed.shape[-2], p.packed.shape[-1])
            for p in (lyr.wqkv, lyr.wo, lyr.wgate_up, lyr.down)]


def prefill_launches(params, cfg, qcfg, dev, lengths) -> dict:
    """Kernel launches of one prefill of each prompt length into a fresh
    cache (one chunk each)."""
    from tinychatengine_tpu_torch.generation.engine import Engine
    from tinychatengine_tpu_torch.ops import _build
    eng = Engine(params, cfg, qcfg, max_len=max(lengths), device=dev)
    rng = np.random.default_rng(1)
    out = {}
    with torch.inference_mode():
        for n in lengths:
            cache = eng.new_cache()
            _build.reset_launches()
            eng.prefill(rng.integers(0, cfg.vocab_size, (1, n)), cache)
            out[n] = {k: v for k, v in _build.LAUNCHES.items() if v}
            del cache
    return out


def teacher_forced(params, cfg, qcfg, dev, tokens, table, prefill_table):
    """``tokens`` fed one by one after the Engine run's 64-token prompt
    with ``DECODE_KOUTER`` set to ``table``, the prompt prefilled under
    ``prefill_table``. Returns the raw logits before each token [n, V] f32,
    the greedy choice there under the run's repeat penalty [n], and the
    penalised top-2 margin there [n]."""
    from tinychatengine_tpu_torch.generation import sampling
    from tinychatengine_tpu_torch.generation.engine import (
        Engine, forward_for_family)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 64))
    gcfg = greedy_config(len(tokens))
    forward = forward_for_family(cfg.family)
    seen, choice, margin = [], [], []
    with kouter_table(table), torch.inference_mode():
        eng = Engine(params, cfg, qcfg, max_len=64 + len(tokens), device=dev,
                     cuda_graphs=False)
        with kouter_table(prefill_table):
            logits, cache = eng.prefill(prompt, eng.new_cache())
        last = torch.as_tensor(prompt, device=dev)  # the 64-token window
        for pos, tok in enumerate(tokens, 64):
            lf = logits.float()  # as sampling.sample takes them
            seen.append(lf[0])
            choice.append(sampling.greedy_penalized(lf, last, gcfg)[0])
            top2 = torch.topk(sampling.apply_repetition_penalty(
                lf, last, gcfg.repeat_penalty), 2).values[0]
            margin.append(top2[0] - top2[1])
            ids = torch.tensor([[tok]], device=dev)
            last = torch.cat([last[:, 1:], ids], dim=1)
            logits, cache = forward(params, cfg, ids, cache, pos)
        del cache
    return (torch.stack(seen), torch.stack(choice).cpu(),
            torch.stack(margin).cpu())


def kouter_engine(model, model_params, dev="cuda", long_len=2048,
                  n_predict=SHORT_DECODE, blocks=KOUTER_BLOCKS,
                  unfused_tokens=None):
    """Phase 4f: phase 4b's W4A16 model (``model_params``) through phase
    4's Engine run with ``DECODE_KOUTER`` listing its four stacked shapes
    at ``blocks``: one decode step launches ``int4_matmul_kouter`` once per
    stacked linear, ``int4_matmul`` once (the unstacked head) and
    ``flash_decode`` once per layer; the 64-token prompt's prefill routes
    its stacked linears to the K-outer kernel, the ``long_len`` one none;
    the first decode step's logits agree with the table empty within
    ``KOUTER_STEP_TOL``, after each setting's own prefill (the empty
    table's prompt runs int4_matmul's tile route on bf16-rounded weights)
    and after one prefill through the K-outer kernel. Fed the run's tokens
    (``teacher_forced``), every step of the K-outer setting lies within
    ``KOUTER_STEP_TOL`` of the plain version at its cast point
    (``exact_int4``) and of the table empty after the K-outer prefill;
    against the table empty after its own prefill, at least
    ``KOUTER_OWN_MIN_WITHIN`` steps do and the median step gap is at most
    ``KOUTER_OWN_MEDIAN_TOL``; the K-outer setting chooses its own tokens
    again. The table is restored after. Returns {"run": (launches,
    per_step, metrics), "prefill": {length: launches}, "first_step": {...}
    (own prefills), "first_step_kouter_prefill": {...}, "tokens_agreeing":
    leading greedy tokens equal to ``unfused_tokens`` (phase 4b's unfused
    run), "teacher_forced": per reference ("plain", "empty_own_prefill",
    "empty_kouter_prefill") the steps it chooses as the run did, the steps
    within ``KOUTER_STEP_TOL``, the largest and the median step's max
    |diff| / max |logit|, the first step where it chooses otherwise with
    its penalised top-2 margin and max |diff| there; "steps", and
    "self_agree": the steps where the K-outer setting chose as the run did;
    "table": the table}."""
    cfg = model_config(model)
    params, qcfg = model_params
    table = dict.fromkeys(stacked_shapes(params), tuple(blocks))
    with kouter_table(table):
        run = main_path(cfg, dev, long_len, model_params=model_params,
                        n_predict=n_predict)
        prefill = prefill_launches(params, cfg, qcfg, dev, (64, long_len))
    # the first decode step, each setting after its own prefill (the empty
    # table's 64-row prompt runs int4_matmul's tile route, on bf16-rounded
    # dequantized weights), and after one prefill through the K-outer
    # kernel (the decode step's routes alone)
    first_own = first_step_diff(params, cfg, (qcfg, False),
                                (qcfg, False, table), dev)
    first = first_step_diff(params, cfg, (qcfg, False), (qcfg, False, table),
                            dev, prefill_table=table)
    toks = run[2]["tokens"]
    agree = len(toks) if unfused_tokens is None else next(
        (i for i, (a, b) in enumerate(zip(toks, unfused_tokens)) if a != b),
        min(len(toks), len(unfused_tokens)))
    # every setting fed the K-outer run's tokens: each step compared on the
    # same context, so a fault after a few steps or in the 64-row prompt
    # bucket shows in its own step, and where the greedy runs part the
    # reference's margin says whether it was a near tie. References: the
    # plain version at the K-outer kernel's cast point (``exact_int4``:
    # every linear, the prompt's too, in plain PyTorch, no kernel of the
    # K-outer or band route); the table empty, its prompt through the tile
    # route (another cast point); the table empty after the K-outer
    # kernel's prefill (the decode step's band route alone)
    kl, kc, _ = teacher_forced(params, cfg, qcfg, dev, toks, table, table)
    want = torch.tensor(toks, dtype=kc.dtype)

    def against(ref):
        rl, rc, rm = ref
        step_abs = (kl - rl).abs().amax(-1).cpu()
        rel = step_abs / rl.abs().amax(-1).cpu()
        part = next((i for i, ok in enumerate((rc == want).tolist())
                     if not ok), None)
        return dict(
            agree=int((rc == want).sum()),
            steps_within=int((rel <= KOUTER_STEP_TOL).sum()),
            max_rel_diff=float(rel.max()),
            median_rel_diff=float(rel.median()),
            first_parting_step=part,
            margin_there=None if part is None else float(rm[part]),
            max_abs_diff_there=None if part is None
            else float(step_abs[part]))
    with exact_int4():
        forced = {"plain": against(teacher_forced(params, cfg, qcfg, dev,
                                                  toks, {}, {}))}
    forced["empty_own_prefill"] = against(teacher_forced(
        params, cfg, qcfg, dev, toks, {}, {}))
    forced["empty_kouter_prefill"] = against(teacher_forced(
        params, cfg, qcfg, dev, toks, {}, table))
    forced["steps"], forced["self_agree"] = len(toks), int((kc == want).sum())
    del kl
    own = forced["empty_own_prefill"]
    log(f"{cfg.name} K-outer: prefill launches {json.dumps(prefill)}; first "
        f"decode step against the table empty, each its own prefill "
        f"{json.dumps(first_own)}, one K-outer prefill {json.dumps(first)} "
        f"(tol {KOUTER_STEP_TOL}); greedy tokens agreeing with the unfused "
        f"run: {agree} of {len(toks)}; fed the K-outer tokens, K-outer "
        f"against each reference: {json.dumps(forced)} (every step within "
        f"{KOUTER_STEP_TOL} of the plain version and of the table empty "
        f"after the K-outer prefill; after its own prefill >= "
        f"{KOUTER_OWN_MIN_WITHIN} steps within it, median <= "
        f"{KOUTER_OWN_MEDIAN_TOL})")
    if dev == "cuda":
        nl = cfg.num_layers
        want_short = {"int4_matmul_kouter": 4 * nl, "int4_matmul": 1,
                      "flash_prefill": nl}
        if prefill[64] != want_short or prefill[long_len].get(
                "int4_matmul_kouter", 0) or prefill[long_len].get(
                    "int4_matmul") != 4 * nl + 1:
            raise SystemExit(f"{cfg.name} K-outer prefill launches "
                             f"{prefill}, want {want_short} at 64 tokens and "
                             f"no K-outer kernel at {long_len}")
        if not max(first["rel_diff"], first_own["rel_diff"]) \
                <= KOUTER_STEP_TOL:
            raise SystemExit(f"{cfg.name}: K-outer decode disagrees with "
                             "int4_matmul")
        if not max(forced["plain"]["max_rel_diff"],
                   forced["empty_kouter_prefill"]["max_rel_diff"]) \
                <= KOUTER_STEP_TOL:
            raise SystemExit(f"{cfg.name}: a K-outer step fed the run's "
                             "tokens disagrees with the plain version or "
                             "int4_matmul")
        if not (own["steps_within"] >= KOUTER_OWN_MIN_WITHIN
                and own["median_rel_diff"] <= KOUTER_OWN_MEDIAN_TOL):
            raise SystemExit(f"{cfg.name}: K-outer steps after its own "
                             "prefill disagree with int4_matmul's")
        if forced["self_agree"] != len(toks):
            raise SystemExit(f"{cfg.name}: the K-outer run fed its own "
                             "tokens chose others")
    return {"run": run, "prefill": prefill, "first_step": first_own,
            "first_step_kouter_prefill": first, "tokens_agreeing": agree,
            "teacher_forced": forced, "table": table}


def int8_kv_engine(model, model_params, dev="cuda", long_len=2048,
                   n_predict=256):
    """Phase 4c: phase 4's model (``model_params``, W4A8) with the int8 KV
    cache through phase 4's Engine run (``flash_decode_int8`` exactly once
    per layer per decode step, ``flash_prefill_int8`` once per layer per
    prefill, no bf16 attention kernel), then the first decode step's
    logits against the bf16 KV cache's. Returns (launches, per_step,
    metrics) with metrics["first_step_vs_bf16_kv"]."""
    params, qcfg = model_params
    cfg = model_config(model)
    q8 = dataclasses.replace(qcfg, kv_cache_dtype="int8")
    launches, per_step, metrics = main_path(
        cfg, dev, long_len, model_params=(params, q8), n_predict=n_predict)
    metrics["first_step_vs_bf16_kv"] = first_step_diff(
        params, cfg, (qcfg, False), (q8, False), dev)
    log(f"{cfg.name} first decode step, int8 vs bf16 KV:",
        json.dumps(metrics["first_step_vs_bf16_kv"]))
    return launches, per_step, metrics


def serving_load(srv, cfg, n_requests: int, n_predict: int, seed: int = 0,
                 plen=(32, 320), logprobs=None):
    """scripts/bench_serving.py's load: prompts of ``plen`` tokens (32-320;
    its ``--long`` mix 3072-3967) from ``default_rng(seed)``, the engine's
    greedy config and two sampled configs in turn; every second request
    (the first included) asks for ``logprobs``."""
    from tinychatengine_tpu_torch.core.config import GenerationConfig
    rng = np.random.default_rng(seed)
    variants = [
        None,
        GenerationConfig(temp=1.0, top_p=0.9, n_predict=n_predict,
                         repeat_penalty=1.1, repeat_last_n=64, seed=11),
        GenerationConfig(temp=0.7, top_k=40, n_predict=n_predict,
                         repeat_penalty=1.0, repeat_last_n=1, seed=12)]
    reqs = []
    for i in range(n_requests):
        ids = rng.integers(100, cfg.vocab_size - 100,
                           int(rng.integers(*plen)))
        reqs.append(srv.submit(ids, n_predict=n_predict,
                               gcfg=variants[i % len(variants)],
                               logprobs=None if i % 2 else logprobs))
    return reqs


def serving_path(model="llama3_8b", dev="cuda", n_requests=24, n_predict=128,
                 max_len=2048, fused=False):
    """Phase 5 (llama3_8b W4A8, dense then paged), 8 (opt_6.7b W8A8,
    dense only: OPT W8A8 has no paged path) or 11 (starcoder_15.5b W4A16
    with ``fused``, dense then paged): ``model`` (a registry name or a
    ``ModelConfig``) at full width through ServingEngine (n_pages the
    dense-equivalent capacity), each mode after a 2-request warm-up.
    Returns {mode: metrics and launches}. The arguments shrink the run for
    a rehearsal on the CPU (tests)."""
    with fused_decode(fused):
        return _serving_run(model_config(model), dev, n_requests, n_predict,
                            max_len)


def _serving_run(cfg, dev, n_requests, n_predict, max_len):
    from tinychatengine_tpu_torch.core.config import GenerationConfig
    from tinychatengine_tpu_torch.generation.engine import forward_for_family
    from tinychatengine_tpu_torch.ops import int4_matmul as im
    from tinychatengine_tpu_torch.runtime.serving import ServingEngine

    model, fused = cfg.name, im.FUSED_DECODE
    paged_ok = cfg.family != "opt"
    params, qcfg = random_model(cfg, dev, max_pos=max_len)
    gcfg = GenerationConfig(temp=0.0, n_predict=n_predict, repeat_penalty=1.1,
                            repeat_last_n=64, seed=0)
    out, greedy = {}, {}
    for mode in ("dense", "paged") if paged_ok else ("dense",):
        srv = ServingEngine(params, cfg, qcfg, slots=8, max_len=max_len,
                            gcfg=gcfg, admission_chunk=512, tick_batch=16,
                            forward_fn=forward_for_family(cfg.family),
                            paged=mode == "paged", device=dev)
        reqs, m = timed_run(
            srv, lambda: serving_load(srv, cfg, n_requests, n_predict), dev,
            warmup=lambda: serving_load(srv, cfg, 2, n_predict, seed=1))
        launches, ticks = m["launches"], m["decode_ticks"]
        log(f"{model} serving {mode}:", json.dumps(m))
        check_lengths(reqs, n_predict, f"serving {mode}")
        if dev == "cuda":  # the CPU rehearsal runs the plain versions
            if any(m["plain_calls"].values()):
                raise SystemExit(f"serving {mode}: plain versions ran: "
                                 f"{m['plain_calls']}")
            # llama and gptbigcode: each mode's decode attention kernel runs,
            # the other one never, and with the fused decode every tick
            # launches int4_matmul_fused once per linear (4 per layer and
            # the head); opt: int8_decode once per layer per tick, nothing
            # else
            ran, idle = (("flash_decode_paged", "flash_decode") if mode == "paged"
                         else ("flash_decode", "flash_decode_paged"))
            mm = "int4_matmul_a8" if qcfg.scheme == "w4a8" else "int4_matmul"
            if not paged_ok:
                want = {"int8_decode": cfg.num_layers * ticks}
                if {k: v for k, v in launches.items() if v} != want:
                    raise SystemExit(f"{model} serving: launches {launches}, "
                                     f"want {want}")
            elif launches[idle] or not all(
                    launches[k] > 0 for k in (mm, "flash_prefill", ran)):
                raise SystemExit(f"serving {mode}: wrong kernels ran: {launches}")
            if fused and launches["int4_matmul_fused"] != \
                    (4 * cfg.num_layers + 1) * ticks:
                raise SystemExit(f"{model} serving {mode}: "
                                 f"{launches['int4_matmul_fused']} fused "
                                 f"launches over {ticks} ticks")
        greedy[mode] = [r.output_ids for r in reqs if r.gcfg is None]
        if dev == "cuda" and paged_ok:
            m.update(burst_profile(srv, cfg))
            log(f"serving {mode} burst profile:", json.dumps(m["burst"]))
        out[mode] = m
        del srv
        if dev == "cuda":
            torch.cuda.empty_cache()
    if paged_ok:
        same = sum(a == b for a, b in zip(greedy["dense"], greedy["paged"]))
        out["greedy_dense_eq_paged"] = [same, len(greedy["dense"])]
        log(f"serving: {same} of {len(greedy['dense'])} greedy requests "
            "agree token for token, dense vs paged")
    del params
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def timed_run(srv, submit, dev, warmup=None):
    """Drain the requests ``warmup()`` queues (untimed), then those
    ``submit()`` queues, through ``srv``, the second from zeroed tick
    counters and launch counts: wall clock, tokens/s, TTFT p50 / p95
    (first token - submit), decode ticks, the tick mix, kernel launches,
    and the plain-version calls of both (the warm-up captures the ticks
    that the timed run replays). Returns (requests, metrics)."""
    from tinychatengine_tpu_torch.ops import _build
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    with plain_calls() as plain:
        if warmup is not None:
            warmup()
            srv.run()
        srv.done.clear()
        for k in srv.tick_stats:
            srv.tick_stats[k] = 0
        sync()
        _build.reset_launches()
        t0 = time.perf_counter()
        reqs = submit()
        srv.run()
        sync()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    ttft = sorted(r.first_token_t - r.submit_t for r in reqs)
    total = sum(len(r.output_ids) for r in reqs)
    ticks = srv.tick_stats["burst_ticks"] + srv.tick_stats["single_ticks"]
    m = dict(tok_s=total / wall, wall_s=wall, tokens=total,
             ttft_p50_s=ttft[len(ttft) // 2],
             ttft_p95_s=ttft[int(len(ttft) * 0.95)],
             decode_ticks=ticks, tick_stats=dict(srv.tick_stats),
             launches=launches, plain_calls=dict(plain))
    if dev == "cuda":
        m["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return reqs, m


def check_lengths(reqs, n_predict: int, what: str):
    """Every request must have ended at its length budget."""
    bad = [r.request_id for r in reqs
           if r.finish_reason != "length" or len(r.output_ids) != n_predict]
    if bad:
        raise SystemExit(f"{what}: requests {bad} did not finish at their "
                         "length")


ATTENTION = ("flash_decode", "flash_prefill", "flash_decode_paged",
             *INT8_KV.values())


def check_serving_attention(m, kv: str, mode: str, what: str):
    """A llama serving run on the card: no plain version ran, and of the
    six attention kernels exactly the storage's (bf16 or int8) prefill and
    the mode's (dense or paged) decode kernel launched."""
    want = ["flash_prefill", "flash_decode_paged" if mode == "paged"
            else "flash_decode"]
    if kv == "int8":
        want = [INT8_KV[k] for k in want]
    ran = [k for k in ATTENTION if m["launches"][k]]
    if any(m["plain_calls"].values()) or sorted(ran) != sorted(want):
        raise SystemExit(f"{what}: attention kernels {ran}, want {want}; "
                         f"plain calls {m['plain_calls']}")


LONG_PROMPTS = (3072, 3968)  # scripts/bench_serving.py --long's lengths


def long_serving(model, model_params, dev="cuda", n_requests=8, n_predict=64,
                 max_len=4608, plen=LONG_PROMPTS):
    """Phase 4d: scripts/bench_serving.py ``--long``'s mix (prompts of
    3072-3967 tokens from ``default_rng(0)``, ``max_len`` 4608, 8 slots,
    ``admission_chunk`` 512, ``tick_batch`` 16, the three sampling configs)
    cut to ``n_requests`` x ``n_predict``, on phase 4's model
    (``model_params``), three times: bf16 KV dense, int8 KV dense, int8 KV
    paged, each after a 2-request warm-up. Every request ends at its
    length; only the storage's and the mode's attention kernels launch.
    Returns {"<kv> <mode>": metrics}."""
    from tinychatengine_tpu_torch.core.config import GenerationConfig
    from tinychatengine_tpu_torch.runtime.serving import ServingEngine
    params, qcfg = model_params
    cfg = model_config(model)
    gcfg = GenerationConfig(temp=0.0, n_predict=n_predict, repeat_penalty=1.1,
                            repeat_last_n=64, seed=0)
    out = {}
    for kv, mode in (("bf16", "dense"), ("int8", "dense"), ("int8", "paged")):
        srv = ServingEngine(
            params, cfg, dataclasses.replace(qcfg, kv_cache_dtype=kv),
            slots=8, max_len=max_len, gcfg=gcfg, admission_chunk=512,
            tick_batch=16, paged=mode == "paged", device=dev)
        reqs, m = timed_run(srv, lambda: serving_load(
            srv, cfg, n_requests, n_predict, plen=plen), dev,
            warmup=lambda: serving_load(srv, cfg, 2, 8, seed=1))
        name = f"{kv} {mode}"
        log(f"{cfg.name} long-context serving {name}:", json.dumps(m))
        check_lengths(reqs, n_predict, f"long-context serving {name}")
        if dev == "cuda":
            check_serving_attention(m, kv, mode,
                                    f"long-context serving {name}")
        out[name] = m
        del srv
        if dev == "cuda":
            torch.cuda.empty_cache()
    return out


def prefix_serving(model, model_params, dev="cuda", n_requests=8,
                   header=2048, tails=(256, 1024), n_predict=32,
                   max_len=4096, admission_chunk=512):
    """Phase 4e: the prefix cache on the int8-KV server. ``n_requests``
    greedy requests share one ``header``-token prefix (a multiple of
    ``admission_chunk``, so the chunks of a hit's tail start where an
    uncached prefill's do) and end in random tails of ``tails`` tokens,
    all submitted at once to 8 slots: dense with the cache
    (``prefix_cache_entries=2``, ``prefix_min=64``), dense without it, and
    paged with it. The cached runs need >= n_requests - 1 hits; the tokens
    must be identical in all three; only the int8 kernels launch. Returns
    {run: metrics with prefix_stats}."""
    from tinychatengine_tpu_torch.core.config import GenerationConfig
    from tinychatengine_tpu_torch.runtime.serving import ServingEngine
    params, qcfg = model_params
    cfg = model_config(model)
    q8 = dataclasses.replace(qcfg, kv_cache_dtype="int8")
    rng = np.random.default_rng(3)
    head = rng.integers(100, cfg.vocab_size - 100, header)
    prompts = [np.concatenate([head, rng.integers(
        100, cfg.vocab_size - 100, int(rng.integers(*tails)))])
        for _ in range(n_requests)]
    gcfg = GenerationConfig(temp=0.0, n_predict=n_predict, repeat_penalty=1.0,
                            repeat_last_n=1)
    out, toks = {}, {}
    for name, mode, entries in (("dense uncached", "dense", 0),
                                ("dense cached", "dense", 2),
                                ("paged cached", "paged", 2)):
        srv = ServingEngine(params, cfg, q8, slots=8, max_len=max_len,
                            gcfg=gcfg, admission_chunk=admission_chunk,
                            tick_batch=16, paged=mode == "paged",
                            prefix_cache_entries=entries, prefix_min=64,
                            device=dev)
        reqs, m = timed_run(srv, lambda: [srv.submit(p) for p in prompts],
                            dev)
        m["prefix_stats"] = getattr(srv, "prefix_stats", None)
        toks[name] = [r.output_ids for r in reqs]
        log(f"{cfg.name} int8-KV prefix cache, {name}:", json.dumps(m))
        check_lengths(reqs, n_predict, f"prefix cache {name}")
        if dev == "cuda":
            check_serving_attention(m, "int8", mode, f"prefix cache {name}")
        if entries and m["prefix_stats"]["hits"] < n_requests - 1:
            raise SystemExit(f"prefix cache {name}: {m['prefix_stats']}")
        out[name] = m
        del srv
        if dev == "cuda":
            torch.cuda.empty_cache()
    same = {name: t == toks["dense uncached"] for name, t in toks.items()}
    out["tokens_equal_uncached"] = same
    log("prefix cache: tokens equal to the uncached dense run:",
        json.dumps(same))
    if not all(same.values()):
        raise SystemExit("the prefix cache changed the greedy tokens")
    return out


def forced_logits(params, cfg, qcfg, dev, prompt, tokens, bucket=None,
                  input_embeds=None):
    """The eager forward teacher-forced over ``tokens`` after ``prompt``:
    the prompt prefilled at once (right-padded to ``bucket`` rows, as a
    server's admission pads it), then one-token decode steps. Returns the
    logits before each token, [len(tokens), V] f32 on ``dev``."""
    from tinychatengine_tpu_torch.generation import kv_cache as kvc
    from tinychatengine_tpu_torch.generation.engine import _bucket
    from tinychatengine_tpu_torch.models import llama
    n = len(prompt)
    bucket = bucket or _bucket(n)
    cache = kvc.init_cache(cfg.num_layers, 1, 2048, cfg.num_kv_heads,
                           cfg.head_dim, device=dev)
    ids = np.zeros((1, bucket), np.int64)
    ids[0, :n] = prompt
    kw = {}
    if input_embeds is not None:
        kw["input_embeds"] = torch.nn.functional.pad(
            input_embeds, (0, 0, 0, bucket - n))
    out = []
    with torch.inference_mode():
        logits, _ = llama.forward(params, cfg, torch.as_tensor(ids, device=dev),
                                  cache, 0, true_len=n, **kw)
        out.append(logits[0].float())
        for i, t in enumerate(tokens[:-1]):
            logits, _ = llama.forward(params, cfg,
                                      torch.tensor([[int(t)]], device=dev),
                                      cache, n + i)
            out.append(logits[0].float())
    return torch.stack(out)


def partings(name, got, want, logits_of):
    """Greedy ``got`` against the plain run's ``want``: equal up to the
    first parting, where the plain run's top-2 logit margin (from
    ``logits_of(step)``, the logits that chose want[step]) must lie within
    SPEC_TIE_TOL of max |logit|. Prints the parting; returns it or None."""
    p = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if p is None:
        return None
    lg = logits_of(p)
    top = torch.topk(lg, 2).values
    margin, scale = float(top[0] - top[1]), float(lg.abs().max())
    row = dict(request=name, step=p, got=int(got[p]), plain=int(want[p]),
               plain_margin=margin, max_abs_logit=scale,
               share=margin / (SPEC_TIE_TOL * scale))
    log("speculation parts from plain greedy:", json.dumps(row))
    if not margin <= SPEC_TIE_TOL * scale:
        raise SystemExit(f"{name}: tokens part at step {p} with a plain "
                         f"top-2 margin of {margin} (> {SPEC_TIE_TOL} of "
                         f"max |logit| {scale})")
    return row


def spec_logprobs_serving(model, model_params, dev="cuda", n_requests=8,
                          n_predict=32, spec_predict=64, max_len=2048,
                          pld_tokens=128):
    """Phase 12 on phase 4's llama3_8b W4A8 weights (``model_params``).
    Logprobs: phase 5's mix (8 requests x ``n_predict``, greedy and sampled
    configs in turn, every second request with ``logprobs=5``) through the
    dense server's captured ticks, its paged twin and an eager dense server
    (``cuda_graphs=False``, identical tokens and logprobs), and a dense
    server without logprobs (identical tokens); every logprob within
    LP_CARD_TOL of ``forced_logits``' log-softmax, tops descending, the
    greedy top-1 the chosen token. Speculation: 8 greedy requests whose
    prompts are 32 random tokens (``default_rng(0)``) tiled to 256, x
    ``spec_predict``, with ``speculative=True`` and then without: spec
    ticks > 0 and spec tokens > spec ticks, tokens parting only at a tie
    (``partings``). PLD: ``generate_pld`` on the Engine (a 64-token
    repetitive prompt, ``pld_tokens``, K = SPEC_K) against greedy
    ``generate_device``, each timed on its second call. Returns metrics;
    the arguments shrink the run for a rehearsal on the CPU."""
    from tinychatengine_tpu_torch.core.config import GenerationConfig
    from tinychatengine_tpu_torch.generation.engine import Engine
    from tinychatengine_tpu_torch.generation.speculative import generate_pld
    from tinychatengine_tpu_torch.runtime.serving import ServingEngine
    params, qcfg = model_params
    cfg = model_config(model)
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    greedy = GenerationConfig(temp=0.0, n_predict=n_predict,
                              repeat_penalty=1.0, repeat_last_n=1, seed=0)
    out, runs = {}, {}
    for name, paged, graphs, lp in (("dense", False, True, 5),
                                    ("dense without logprobs", False, True,
                                     None),
                                    ("paged", True, True, 5),
                                    ("dense eager", False, False, 5)):
        srv = ServingEngine(params, cfg, qcfg, slots=8, max_len=max_len,
                            gcfg=greedy, admission_chunk=512, tick_batch=16,
                            paged=paged, logprobs_k=8, device=dev,
                            cuda_graphs=graphs)
        reqs, m = timed_run(
            srv, lambda: serving_load(srv, cfg, n_requests, n_predict,
                                      logprobs=lp), dev,
            warmup=lambda: serving_load(srv, cfg, 2, 8, seed=1, logprobs=lp))
        check_lengths(reqs, n_predict, f"logprobs serving {name}")
        if dev == "cuda":
            check_serving_attention(m, "bf16", "paged" if paged else "dense",
                                    f"logprobs serving {name}")
        runs[name] = reqs
        log(f"{cfg.name} logprobs serving {name}:", json.dumps(m))
        out[name] = m
        del srv
        if dev == "cuda":
            torch.cuda.empty_cache()
    base = runs["dense"]

    def tokens(name):
        return [r.output_ids for r in runs[name]]
    if tokens("dense without logprobs") != tokens("dense"):
        raise SystemExit("logprobs serving: asking for logprobs changed the "
                         "tokens")
    if tokens("dense eager") != tokens("dense") or \
            lp_of(runs["dense eager"]) != lp_of(base):
        raise SystemExit("logprobs serving: the eager server's tokens or "
                         "logprobs differ from the captured ticks'")
    same = sum(a == b for a, b in zip(tokens("paged"), tokens("dense")))
    out["paged_eq_dense"] = [same, len(base)]
    worst = {}
    # the teacher prefills each prompt as its admission did: dense admits
    # the 8 at once in the 512 bucket, paged one by one in each's own
    for name, bucket in (("dense", 512), ("paged", None)):
        worst[name] = 0.0
        for i, r in enumerate(runs[name]):
            if r.logprobs is None:
                if r.output_logprobs:
                    raise SystemExit("logprobs returned to a request that "
                                     "did not ask for them")
                continue
            lsm = torch.log_softmax(forced_logits(
                params, cfg, qcfg, dev, r.prompt_ids, r.output_ids,
                bucket=bucket), dim=-1)
            chosen = lsm[torch.arange(len(r.output_ids)), torch.as_tensor(
                r.output_ids, device=lsm.device)].cpu()
            worst[name] = max(worst[name], float(
                (chosen - torch.tensor(r.output_logprobs)).abs().max()))
            for t, top in zip(r.output_ids, r.output_top_logprobs):
                vals = [v for _, v in top]
                if len(top) != 5 or vals != sorted(vals, reverse=True) or (
                        r.gcfg is None and top[0][0] != t):
                    raise SystemExit(f"logprobs {name} request {i}: bad top "
                                     f"list {top} for token {t}")
    out["lp_max_abs_err"] = worst
    log(f"logprobs against the teacher-forced eager forward: max |diff| "
        f"{json.dumps(worst)} nats (tol {LP_CARD_TOL}); paged tokens equal "
        f"to dense in {same} of {len(base)} requests")
    if not max(worst.values()) <= LP_CARD_TOL:
        raise SystemExit("served logprobs disagree with the raw forward")

    # ---- speculative serving
    rng = np.random.default_rng(0)
    prompts = [np.tile(rng.integers(100, cfg.vocab_size - 100, 32), 8)
               for _ in range(8)]
    sg = dataclasses.replace(greedy, n_predict=spec_predict)
    toks, spec = {}, {}
    for on in (True, False):
        srv = ServingEngine(params, cfg, qcfg, slots=8, max_len=max_len,
                            gcfg=sg, admission_chunk=512, tick_batch=16,
                            speculative=on, device=dev)

        def submit(srv=srv):
            if on:
                srv._spec_stats.update(ticks=0, tokens=0)
            return [srv.submit(p) for p in prompts]
        reqs, m = timed_run(srv, submit, dev, warmup=lambda: [
            srv.submit(p, n_predict=16) for p in prompts[:2]])
        check_lengths(reqs, spec_predict, f"speculative serving {on}")
        if dev == "cuda":  # a verify is a prefill: decode may not run
            ran = {k for k in ATTENTION if m["launches"][k]}
            if any(m["plain_calls"].values()) or "flash_prefill" not in ran \
                    or not ran <= {"flash_prefill", "flash_decode"} \
                    or not m["launches"]["int4_matmul_a8"]:
                raise SystemExit(f"speculative serving {on}: launches "
                                 f"{m['launches']}, plain calls "
                                 f"{m['plain_calls']}")
        if on:
            m["spec_stats"] = dict(srv._spec_stats)
            st = m["spec_stats"]
            m["tokens_per_spec_tick"] = st["tokens"] / max(st["ticks"], 1)
            if not (st["ticks"] > 0 and st["tokens"] > st["ticks"]):
                raise SystemExit(f"speculative serving accepted no drafts: "
                                 f"{st}")
        toks[on] = [r.output_ids for r in reqs]
        spec["speculative" if on else "plain"] = m
        log(f"{cfg.name} speculative={on} serving:", json.dumps(m))
        del srv
        if dev == "cuda":
            torch.cuda.empty_cache()
    parts = [partings(f"spec serving {i}", a, b, lambda step, i=i: forced_logits(
        params, cfg, qcfg, dev, prompts[i], toks[False][i][:step + 1],
        bucket=256)[step])
             for i, (a, b) in enumerate(zip(toks[True], toks[False]))]
    spec["partings"] = [p for p in parts if p]
    out["speculative"] = spec

    # ---- generate_pld on the Engine
    eng = Engine(params, cfg, qcfg, batch=1, max_len=max_len, device=dev)
    rep = np.tile(np.random.default_rng(1).integers(
        100, cfg.vocab_size - 100, 16), 4)[None]
    n = pld_tokens
    pg = dataclasses.replace(greedy, n_predict=n)
    res = {}
    for name, fn in (("generate_device",
                      lambda: eng.generate_device(rep, pg, n_tokens=n)[0]
                      .tolist()),
                     ("generate_pld",
                      lambda: generate_pld(eng, rep, n, K=SPEC_K))):
        fn()  # captures
        sync()
        t = time.perf_counter()
        r = fn()
        sync()
        res[name] = (r, time.perf_counter() - t)
    (pld, steps, _), t_pld = res["generate_pld"]
    plain, t_plain = res["generate_device"]
    pld_part = partings("generate_pld", pld.tolist(), plain,
                        lambda step: forced_logits(
                            params, cfg, qcfg, dev, rep[0], plain[:step + 1])
                        [step])
    out["pld"] = dict(steps=steps, tokens=n, tok_s=n / t_pld,
                      greedy_tok_s=n / t_plain, parting=pld_part)
    log(f"{cfg.name} generate_pld: {steps} forward steps for {n} tokens, "
        f"{n / t_pld:.1f} tok/s against generate_device's "
        f"{n / t_plain:.1f} (each end to end, prefill included)")
    del eng
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def lp_of(reqs):
    return [(r.output_logprobs, r.output_top_logprobs) for r in reqs]


def tree_bytes(p) -> int:
    """Bytes of every tensor leaf of a parameter dataclass tree."""
    if p is None:
        return 0
    if isinstance(p, torch.Tensor):
        return p.numel() * p.element_size()
    return sum(tree_bytes(getattr(p, f.name)) for f in dataclasses.fields(p))


def vlm_image(seed: int) -> np.ndarray:
    """A 480 x 640 uint8 image from ``default_rng(seed)``: a 12 x 16 grid of
    random 40-pixel blocks, which survives the antialiased shrink to 336
    (pixel noise averages out to one grey, and two such images then encode
    alike)."""
    cells = np.random.default_rng(seed).integers(0, 256, (12, 16, 3),
                                                 np.uint8)
    return np.kron(cells, np.ones((40, 40, 1), np.uint8))


def vlm_path(dev="cuda", n_predict=64, clip_model="clip_vit_large",
             vila_model="vila_7b"):
    """Phase 13: CLIP ViT-L/14-336 (``clip_vit_large``, the port's
    ``init_random_params(seed=0)`` at f32) in front of VILA-7B W4A8 at
    group 128 (32 layers, E 4096, 32 / 32 heads, F 11008, random packed
    weights made on the card from a seed, codes centred on the zero point
    so that the tokens follow the image, ``max_len`` 2048). A 480 x 640
    image (``vlm_image(0)``) through preprocess and the bf16 encode
    (timed by CUDA events), then ``generate_with_image`` on an 8 + 576 + 24
    token prompt (scripts/bench_vlm.py's layout) and ``generate_device`` on
    its embeds (captured graphs) = an eager Engine's tokens, n_predict
    greedy; exact launches (flash_prefill once per layer, int4_matmul on
    the 1024-row prompt, flash_decode and int4_matmul_a8 per step) and no
    plain call; a second image gives other tokens; one ServingEngine
    request with the embeds gives the Engine's tokens; 2-layer cuts of the
    decoder (with input_embeds) and of the tower against the CPU's plain
    path. Prints encode ms, image TTFT, decode tok/s and the weights' bytes
    by count. Returns the launches and metrics. The arguments shrink the
    run for a rehearsal on the CPU."""
    from tinychatengine_tpu_torch.core.config import (GenerationConfig,
                                                      QuantConfig)
    from tinychatengine_tpu_torch.generation import kv_cache as kvc
    from tinychatengine_tpu_torch.generation import vlm
    from tinychatengine_tpu_torch.generation.engine import Engine
    from tinychatengine_tpu_torch.models import clip, llama
    from tinychatengine_tpu_torch.ops import _build
    from tinychatengine_tpu_torch.runtime.serving import ServingEngine
    from tinychatengine_tpu_torch.tokenizers.byte_fallback import (
        ByteTokenizer)
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    ccfg, vcfg = model_config(clip_model), model_config(vila_model)
    n_img = (ccfg.image_size // ccfg.patch_size) ** 2
    t0 = time.perf_counter()
    cparams = clip.init_random_params(ccfg, seed=0, device=dev)
    qcfg = QuantConfig(scheme="w4a8", group_size=128)
    vparams = llama.init_random_params(vcfg, qcfg, seed=0, max_pos=2048,
                                       fast=True, device=dev, centered=True)
    sync()
    m = dict(init_s=time.perf_counter() - t0,
             decoder_gb=tree_bytes(vparams) / 1e9,
             tower_gb=tree_bytes(cparams) / 1e9)
    log(f"vila_7b w4a8 + clip_vit_large f32 random init: {m['init_s']:.1f} s,"
        f" weights by count: decoder {m['decoder_gb']:.3f} GB, tower "
        f"{m['tower_gb']:.3f} GB")
    img_a, img_b = vlm_image(0), vlm_image(1)

    def encode(img):
        return vlm.encode_image(cparams, ccfg, img)
    emb_a = encode(img_a)
    if emb_a.shape != (n_img, vcfg.embed_dim) or \
            not torch.isfinite(emb_a.float()).all():
        raise SystemExit(f"bad image embeddings {tuple(emb_a.shape)}")
    enc = []
    for _ in range(3):  # CUDA events on the card (host time in a rehearsal)
        if dev == "cuda":
            a, b = _events()
            a.record()
            encode(img_a)
            b.record()
            sync()
            enc.append(a.elapsed_time(b))
        else:
            t = time.perf_counter()
            encode(img_a)
            enc.append((time.perf_counter() - t) * 1e3)
    m["encode_ms"] = float(np.median(enc))

    tok = ByteTokenizer()
    prompt = "Image: " + vlm.IMAGE_MARKER + " What is in this image?\n"
    g = GenerationConfig(temp=0.0, n_predict=n_predict, repeat_penalty=1.0,
                         repeat_last_n=1)
    eng = Engine(vparams, vcfg, qcfg, batch=1, max_len=2048, device=dev)
    ids, embeds = vlm.build_multimodal_inputs(tok, vparams.embed, prompt,
                                              emb_a)
    if ids.shape != (1, VLM_PRE + n_img + VLM_POST):
        raise SystemExit(f"the VLM prompt is {ids.shape[1]} tokens, not "
                         f"{VLM_PRE} + {n_img} + {VLM_POST}")
    res = vlm.generate_with_image(eng, cparams, ccfg, tok, prompt, img_a, g)
    with plain_calls() as plain:
        eng.generate_device(ids, g, n_tokens=2, input_embeds=embeds)
        sync()
        _build.reset_launches()
        got = eng.generate_device(ids, g, n_tokens=n_predict,
                                  input_embeds=embeds)[0].tolist()
        sync()
        launches = dict(_build.LAUNCHES)
    nl = vcfg.num_layers
    want = {"flash_prefill": nl, "int4_matmul": 4 * nl,
            "flash_decode": n_predict * nl,
            "int4_matmul_a8": n_predict * (4 * nl + 1) + 1}
    log("vila_7b generate_device launches:", json.dumps(launches),
        "plain calls:", json.dumps(plain))
    if dev == "cuda" and ({k: v for k, v in launches.items() if v} != want
                          or any(plain.values())):
        raise SystemExit(f"vila_7b: launches {launches}, want {want}; plain "
                         f"calls {plain}")
    eager = Engine(vparams, vcfg, qcfg, batch=1, max_len=2048, device=dev,
                   cuda_graphs=False)
    want_toks = eager.generate_device(ids, g, n_tokens=n_predict,
                                      input_embeds=embeds)[0].tolist()
    del eager
    m["graph_eq_eager"] = got == want_toks
    m["generate_with_image_eq"] = res.tokens[0] == want_toks
    if not (m["graph_eq_eager"] and m["generate_with_image_eq"]):
        raise SystemExit("vila_7b: generate_with_image, the captured graphs "
                         "and the eager Engine part")

    def rate_s(n):
        sync()
        t = time.perf_counter()
        eng.generate_device(ids, g, n_tokens=n, input_embeds=embeds).cpu()
        return time.perf_counter() - t
    t1 = float(np.median([rate_s(1) for _ in range(3)]))
    tn = float(np.median([rate_s(n_predict) for _ in range(3)]))
    m["decode_tok_s"] = (n_predict - 1) / (tn - t1)
    cache = eng.new_cache()

    def ttft_s(img):
        cache.length = 0
        sync()
        t = time.perf_counter()
        e = encode(img)
        i, x = vlm.build_multimodal_inputs(tok, vparams.embed, prompt, e)
        logits, _ = eng.prefill(i, cache, input_embeds=x)
        int(logits.argmax(-1)[0])
        return time.perf_counter() - t
    ttft_s(img_a)
    m["image_ttft_ms"] = float(np.median([ttft_s(img_a)
                                          for _ in range(3)])) * 1e3

    _, emb_b = vlm.build_multimodal_inputs(tok, vparams.embed, prompt,
                                           encode(img_b))
    other = eng.generate_device(ids, g, n_tokens=n_predict,
                                input_embeds=emb_b)[0].tolist()
    m["second_image_differs"] = other != got
    if other == got:
        raise SystemExit("vila_7b: a second image gave the same tokens")
    srv = ServingEngine(vparams, vcfg, qcfg, slots=1, max_len=2048, gcfg=g,
                        device=dev)
    r = srv.submit(ids[0], n_predict=n_predict, input_embeds=embeds[0])
    srv.run()
    m["serving_eq_engine"] = r.output_ids == got
    if r.output_ids != got:
        raise SystemExit("vila_7b: the ServingEngine's embeds request parts "
                         "from the Engine")
    del srv, eng, cache

    # 2-layer cuts at full width, the card against the CPU's plain path:
    # the decoder on the prompt's first 64 rows (8 text, 56 image) then two
    # decode steps; the tower's embeddings at bf16 and its hidden states
    # at f32
    errs = {}
    with torch.inference_mode():
        cut = dataclasses.replace(vcfg, num_layers=2)
        outs = {}
        n = min(64, ids.shape[1])
        for where in (dev, "cpu"):
            p = cut_params(vparams, 2, where)
            c = kvc.init_cache(2, 1, 128, cut.num_kv_heads, cut.head_dim,
                               device=where)
            seq = [llama.forward(p, cut, torch.as_tensor(ids[:, :n],
                                                         device=where),
                                 c, 0, input_embeds=embeds[:, :n].to(where)
                                 )[0].float().cpu()]
            for step, t in enumerate((11, 22)):
                seq.append(llama.forward(p, cut, torch.tensor(
                    [[t]], device=where), c, n + step)[0].float().cpu())
            outs[where] = seq
        errs["decoder"] = max(float((a - b).abs().max() / b.abs().max())
                              for a, b in zip(outs[dev], outs["cpu"]))
        ccut = dataclasses.replace(ccfg, num_layers=2)
        px = clip.preprocess_image(img_a, ccfg.image_size, device=dev)[None]
        for fn, key in ((clip.encode_image, "tower bf16"),
                        (clip.encode_hidden, "tower f32")):
            y = [fn(cut_params(cparams, 2, where), ccut, px.to(where),
                    dtype=torch.bfloat16 if fn is clip.encode_image
                    else torch.float32).float().cpu()
                 for where in (dev, "cpu")]
            errs[key] = float((y[0] - y[1]).abs().max() / y[1].abs().max())
    m["cut_err"] = errs
    log("vila_7b / clip_vit_large 2-layer cuts, card vs CPU plain, max |diff|"
        f" / max |ref|: {json.dumps(errs)} (tol {CUT_TOL}, tower f32 "
        f"{CLIP_F32_CUT_TOL})")
    if not (errs["decoder"] <= CUT_TOL and errs["tower bf16"] <= CUT_TOL
            and errs["tower f32"] <= CLIP_F32_CUT_TOL):
        raise SystemExit("a VLM 2-layer cut disagrees with the plain path")
    m["tokens"] = got
    log("vila_7b vlm path:", json.dumps({k: v for k, v in m.items()
                                          if k != "tokens"}))
    del vparams, cparams
    if dev == "cuda":
        torch.cuda.empty_cache()
    return launches, m


def real_weights_serving(dev="cuda"):
    """Phase 6b: the bytellama_5m goldens through ServingEngine (2 slots),
    dense and paged, fp and w4a8, on its captured ticks and then with
    ``cuda_graphs=False``: the two must give identical tokens. Returns
    {config: tokens matched}."""
    from tinychatengine_tpu_torch.core.config import (GenerationConfig,
                                                      QuantConfig,
                                                      get_model_config)
    from tinychatengine_tpu_torch.ops import _build
    from tinychatengine_tpu_torch.runtime.serving import ServingEngine
    from tinychatengine_tpu_torch.tokenizers.byte_fallback import ByteTokenizer
    from tinychatengine_tpu_torch.tools.checkpoint import load_checkpoint
    from tinychatengine_tpu_torch.tools.convert import requantize_llama

    cfg = get_model_config("bytellama_5m")
    fp, _ = load_checkpoint(str(ROOT / "assets" / "bytellama_5m"), cfg,
                            device=dev)
    golds = [json.loads((ROOT / "tests/golden/bytellama_greedy.json").read_text())]
    golds += json.loads((ROOT / "tests/golden/bytellama_goldens.json").read_text())
    tok = ByteTokenizer()
    g = GenerationConfig(temp=0.0, n_predict=48, repeat_penalty=1.0,
                         repeat_last_n=1)
    outs, matched = {}, {}
    for scheme in ("fp", "w4a8"):
        qcfg = QuantConfig(scheme=scheme, group_size=128)
        params = fp if scheme == "fp" else requantize_llama(fp, qcfg)
        for mode in ("dense", "paged"):
            srv = ServingEngine(params, cfg, qcfg, slots=2, max_len=cfg.max_sqlen,
                                gcfg=g, paged=mode == "paged", page_size=16,
                                device=dev)
            with plain_calls() as plain:
                _build.reset_launches()
                reqs = [srv.submit(tok.encode(gd["prompt"])) for gd in golds]
                srv.run()
                launches = dict(_build.LAUNCHES)
            key = f"{scheme} {mode}"
            outs[key] = [r.output_ids for r in reqs]
            eager = ServingEngine(params, cfg, qcfg, slots=2,
                                  max_len=cfg.max_sqlen, gcfg=g,
                                  paged=mode == "paged", page_size=16,
                                  device=dev, cuda_graphs=False)
            ereqs = [eager.submit(tok.encode(gd["prompt"])) for gd in golds]
            eager.run()
            same = outs[key] == [r.output_ids for r in ereqs]
            log(f"bytellama_5m serving {key}: graph ticks "
                f"({srv.graphs.captures if srv.graphs else 0} captures, "
                f"{json.dumps(srv.tick_stats)}) vs eager ticks: tokens "
                f"{'identical' if same else 'differ'}")
            if not same:
                raise SystemExit(f"bytellama_5m serving {key}: graph and "
                                 "eager serving tokens differ")
            matched[key] = [next((i for i, (a, b) in enumerate(
                zip(r.output_ids, gd["token_ids"])) if a != b), len(gd["token_ids"]))
                for r, gd in zip(reqs, golds)]
            log(f"bytellama_5m serving {key}: golden tokens matched "
                f"{matched[key]}; launches {json.dumps(launches)}")
            if dev == "cuda" and (any(plain.values()) or (
                    mode == "paged") != (launches["flash_decode_paged"] > 0)):
                raise SystemExit(f"bytellama_5m serving {key}: plain calls "
                                 f"{plain}, launches {launches}")
            if scheme == "fp" and min(matched[key]) < 16:
                raise SystemExit(f"bytellama_5m serving {key} diverged from "
                                 "a golden within 16 tokens")
    if outs["w4a8 paged"] != outs["w4a8 dense"]:
        raise SystemExit("bytellama_5m w4a8: paged serving differs from dense")
    return matched


def fused_real_weights(dev="cuda"):
    """Phase 6c: bytellama_5m requantized to W4A16 at group 32 (at 128,
    K = 256 has K/G = 2 and fails the fused gate; at 32 every layer linear
    passes it), 32 greedy tokens of each golden prompt through Engine,
    unfused and then with the fused decode: >= 16 must agree per prompt.
    Returns {"agree": [...], "launches": {...}}."""
    from tinychatengine_tpu_torch.core.config import (GenerationConfig,
                                                      QuantConfig,
                                                      get_model_config)
    from tinychatengine_tpu_torch.generation.engine import Engine
    from tinychatengine_tpu_torch.models import llama
    from tinychatengine_tpu_torch.ops import _build
    from tinychatengine_tpu_torch.tokenizers.byte_fallback import ByteTokenizer
    from tinychatengine_tpu_torch.tools.checkpoint import load_checkpoint
    from tinychatengine_tpu_torch.tools.convert import requantize_llama

    cfg = get_model_config("bytellama_5m")
    fp, _ = load_checkpoint(str(ROOT / "assets" / "bytellama_5m"), cfg,
                            device=dev)
    qcfg = QuantConfig(scheme="w4a16", group_size=32)
    qp = requantize_llama(fp, qcfg)
    with fused_decode(True):
        if llama.fused_group_size(qp.layers, cfg, 1) != 32:
            raise SystemExit("bytellama_5m at group 32 fails the fused gate")
    golden = ROOT / "tests" / "golden"
    golds = [json.loads((golden / "bytellama_greedy.json").read_text())]
    golds += json.loads((golden / "bytellama_goldens.json").read_text())
    tok = ByteTokenizer()
    prompts = [np.asarray(tok.encode(gd["prompt"]), np.int64) for gd in golds]
    g = GenerationConfig(temp=0.0, n_predict=32, repeat_penalty=1.0,
                         repeat_last_n=1)
    eng = Engine(qp, cfg, qcfg, max_len=cfg.max_sqlen, device=dev)
    toks, launches = {}, {}
    for fused in (False, True):
        with fused_decode(fused), plain_calls() as plain:
            _build.reset_launches()
            toks[fused] = [eng.generate(x[None], g).tokens[0] for x in prompts]
            launches[fused] = {k: v for k, v in _build.LAUNCHES.items() if v}
        if dev == "cuda" and (any(plain.values()) or fused != bool(
                launches[fused].get("int4_matmul_fused"))):
            raise SystemExit(f"bytellama_5m w4a16 g32 fused={fused}: plain "
                             f"calls {plain}, launches {launches[fused]}")
    agree = [next((i for i, (a, b) in enumerate(zip(u, f)) if a != b),
                  min(len(u), len(f)))
             for u, f in zip(toks[False], toks[True])]
    out = {"agree": agree, "launches": {"unfused": launches[False],
                                        "fused": launches[True]}}
    log("bytellama_5m w4a16 g32, fused vs unfused greedy tokens agreeing "
        f"(of 32): {agree}; launches {json.dumps(out['launches'])}")
    if min(agree) < 16:
        raise SystemExit("bytellama_5m: fused decode diverged from unfused "
                         "within 16 tokens")
    return out


def device_ms_by_kernel(prof) -> dict:
    """Device time (ms) by kernel name from a torch.profiler run."""
    from torch.autograd import DeviceType
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = re.split(r"[<(]", e.name.replace(
                "(anonymous namespace)::", "").replace("void ", ""))[0][:60]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    return by_name


def device_busy_ms(prof) -> float:
    """Device time (ms) with at least one kernel or copy running in a
    torch.profiler run: the union of their intervals, so kernels that
    overlap (programmatic dependent launch) count once."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(b - max(a, end), 0.0)
        end = max(end, b)
    return busy / 1e3


# the kernels int4_matmul_fused launches (csrc/int4_matmul_fused.cu: the
# norm, the tensor-core contraction of csrc/int4_mma.cuh, the epilogue), by
# their names in device_ms_by_kernel
FUSED_KERNEL_NAMES = ("fused_norm_kernel", "tce::mma4::mma_band_kernel",
                      "fused_epilogue_kernel")
# the kernels int4_matmul_a8 launches (csrc/int4_matmul_a8.cu: the
# quantizer, the int8 tensor-core contraction)
A8_KERNEL_NAMES = ("a8_quant_kernel", "a8_mma_kernel")


def burst_profile(srv, cfg, n_ticks: int = 16) -> dict:
    """One decode burst of ``n_ticks`` ticks over 8 busy slots: wall and
    device time per tick (torch.profiler), timed once without and once
    with the profiler, and the device time per tick of
    ``int4_matmul_fused``'s kernels (0 where the fused decode is off) and of
    ``int4_matmul_a8``'s (0 where the model is not W4A8). Returns {"burst":
    {...}}."""
    from torch.profiler import ProfilerActivity, profile
    # each request: its first token, a burst in the admitting step, then
    # the timed burst and the profiled burst
    serving_load(srv, cfg, srv.n_slots, 3 * n_ticks + 8, seed=2)
    while srv.queue or srv._pending is not None:
        srv.step()  # admissions (and the bursts that follow them)

    def burst():
        torch.cuda.synchronize()
        ticks0 = srv.tick_stats["burst_ticks"]
        t = time.perf_counter()
        srv.step()
        torch.cuda.synchronize()
        return time.perf_counter() - t, srv.tick_stats["burst_ticks"] - ticks0

    wall, ticks = burst()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, ticks_p = burst()
    srv.run()
    srv.done.clear()
    by_name = device_ms_by_kernel(prof)
    busy = device_busy_ms(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    if ticks != n_ticks or ticks_p != n_ticks or busy == 0.0:
        return {"burst": {"ticks": [ticks, ticks_p], "device_ms": busy,
                          "note": "not measured"}}
    return {"burst": dict(
        ticks=ticks, tick_wall_ms=wall * 1e3 / ticks,
        tick_device_ms=busy / ticks_p,
        tick_kernel_sum_ms=sum(by_name.values()) / ticks_p,
        busy_share=busy / ticks_p / (wall * 1e3 / ticks),
        fused_device_ms_per_tick=sum(by_name.get(k, 0.0)
                                     for k in FUSED_KERNEL_NAMES) / ticks_p,
        a8_device_ms_per_tick=sum(by_name.get(k, 0.0)
                                  for k in A8_KERNEL_NAMES) / ticks_p,
        top_kernels_ms_per_tick={k: v / ticks_p for k, v in top})}


def decode_profile(eng, step_ms: float, steps: int = 16) -> dict:
    """The captured decode step of ``eng``'s last ``generate_device``,
    replayed ``steps`` more times: its device ms by CUDA events over the
    back-to-back replays (and the host's ms to issue one replay), then by
    kernel from a torch.profiler trace, with
    the graph nodes a step (the kernels and copies traced per replay); the
    device ms is the traced time with a kernel running (``device_busy_ms``;
    the kernels' summed times beside it), the busy share that over the
    unprofiled step time ``step_ms`` of the timed run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step = next(st for key, st in reversed(eng.graphs.steps.items())
                if key[0] == "decode")
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0, t1 = _events()
        t0.record()
        host = time.perf_counter()
        for _ in range(steps):
            step.replay()
        host = time.perf_counter() - host
        t1.record()
        torch.cuda.synchronize()
        replay_ms = t0.elapsed_time(t1) / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step.replay()
            torch.cuda.synchronize()
    by_name = device_ms_by_kernel(prof)
    busy_ms = device_busy_ms(prof) / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    for name, ms in top:
        log(f"  decode step device time {ms / steps:8.4f} ms  {name}")
    out = dict(decode_replay_ms_per_step=replay_ms,
               decode_host_ms_per_replay=host * 1e3 / steps)
    if busy_ms == 0.0:
        log("  decode profile: no device time traced in the replays (not "
            "measured)")
        return out
    ops = sum(e.device_type == DeviceType.CUDA for e in prof.events())
    out.update(decode_device_ms_per_step=busy_ms,
               decode_kernel_sum_ms_per_step=sum(by_name.values()) / steps,
               decode_busy_share=busy_ms / step_ms,
               decode_graph_nodes_per_step=ops / steps)
    return out


def real_weights(dev="cuda"):
    """Phase 6: bytellama_5m goldens and perplexity budgets on the card."""
    from tinychatengine_tpu_torch.core.config import (GenerationConfig,
                                                      QuantConfig,
                                                      get_model_config)
    from tinychatengine_tpu_torch.generation.engine import Engine
    from tinychatengine_tpu_torch.models import llama
    from tinychatengine_tpu_torch.ops import _build
    from tinychatengine_tpu_torch.tokenizers.byte_fallback import ByteTokenizer
    from tinychatengine_tpu_torch.tools.checkpoint import load_checkpoint
    from tinychatengine_tpu_torch.tools.convert import requantize_llama
    from tinychatengine_tpu_torch.tools.perplexity import perplexity

    ckpt = ROOT / "assets" / "bytellama_5m"
    cfg = get_model_config("bytellama_5m")
    params, qcfg = load_checkpoint(str(ckpt), cfg, device=dev)
    tok = ByteTokenizer()
    eng = Engine(params, cfg, QuantConfig(scheme="fp"), batch=1,
                 max_len=cfg.max_sqlen, device=dev)
    golds = [json.loads((ROOT / "tests/golden/bytellama_greedy.json").read_text())]
    golds += json.loads((ROOT / "tests/golden/bytellama_goldens.json").read_text())
    for gold in golds:
        g = GenerationConfig(temp=0.0, n_predict=gold["n_predict"],
                             repeat_penalty=1.0, repeat_last_n=1)
        got = eng.generate(np.asarray(tok.encode(gold["prompt"]))[None], g).tokens[0]
        want = gold["token_ids"]
        match = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                     min(len(got), len(want)))
        log(f"golden {gold['prompt'][:24]!r}: {match}/{len(want)} tokens match")
        if match < 16:
            raise SystemExit("golden transcript diverged within 16 tokens")

    ids = np.asarray(tok.encode((ckpt / "eval_sample.txt").read_text(
        encoding="utf-8")), np.int64)[:6144]
    ppl = {"fp": perplexity(llama.forward, params, cfg, ids, 512, 256)}
    for scheme in ("w4a16", "w4a8"):
        qp = requantize_llama(params, QuantConfig(scheme=scheme, group_size=128))
        ppl[scheme] = perplexity(llama.forward, qp, cfg, ids, 512, 256)
    # 512-token windows put M above A8_MAX_ROWS, so the w4a8 model ran the
    # W4A16 kernel there (as in the JAX package); 64-token windows keep
    # M <= 100 and score it through the W4A8 kernel
    ppl["fp_w64"] = perplexity(llama.forward, params, cfg, ids, 64, 32)
    _build.reset_launches()
    ppl["w4a8_w64"] = perplexity(llama.forward, qp, cfg, ids, 64, 32)
    a8 = dict(_build.LAUNCHES)
    # the int8 KV cache (its prefill kernel at D = 64)
    _build.reset_launches()
    for scheme in ("w4a16", "w4a8"):
        qp = requantize_llama(params, QuantConfig(scheme=scheme, group_size=128))
        ppl[f"{scheme}_int8kv"] = perplexity(llama.forward, qp, cfg, ids, 512,
                                             256, quantized_kv=True)
    kv8 = dict(_build.LAUNCHES)
    # int4_matmul's tile route (every window's prefill here) computes on
    # bf16((q - 8) d); the same windows at the band route's (and the TPU
    # kernel's) cast point, exact codes times f32 scales, in plain PyTorch
    with exact_int4():
        qp = requantize_llama(params, QuantConfig(scheme="w4a16",
                                                  group_size=128))
        ppl["w4a16_exact"] = perplexity(llama.forward, qp, cfg, ids, 512, 256)
    log("bytellama_5m ppl on 6144 tokens:", json.dumps(ppl))
    log("w4a16 ppl, tile route minus exact codes:",
        ppl["w4a16"] - ppl["w4a16_exact"])
    log("w4a8 64-token windows, launches:", json.dumps(a8))
    log("int8 KV, launches:", json.dumps(kv8))
    if dev == "cuda" and not (a8["int4_matmul_a8"] > 0
                              and a8["int4_matmul"] == 0):
        raise SystemExit("w4a8 64-token windows did not run the W4A8 kernel")
    if dev == "cuda" and not (kv8["flash_prefill_int8"] > 0
                              and kv8["flash_prefill"] == 0):
        raise SystemExit("the int8 KV cache did not run flash_prefill_int8")
    if not (ppl["fp"] < 3.5 and ppl["w4a16"] <= ppl["fp"] * 1.03
            and ppl["w4a16_exact"] <= ppl["fp"] * 1.03
            and ppl["w4a8"] <= ppl["fp"] * 1.04
            and ppl["w4a8_w64"] <= ppl["fp_w64"] * 1.04
            and ppl["w4a16_int8kv"] <= ppl["fp"] * 1.04
            and ppl["w4a8_int8kv"] <= ppl["fp"] * 1.04):
        raise SystemExit("perplexity outside the ACCURACY.md budgets")
    return ppl


OPT_CKPT = ROOT / "assets" / "byteopt_4m"
# byteopt_4m's calibration text: a fixed source file of the port, never the
# held-out eval sample
OPT_CALIB = ROOT / "tinychatengine_tpu_torch" / "quant" / "numerics.py"


def byteopt_calib_ids() -> np.ndarray:
    """The first 512 byte tokens of ``OPT_CALIB``, [1, 512]."""
    from tinychatengine_tpu_torch.tokenizers.byte_fallback import ByteTokenizer
    text = OPT_CALIB.read_text(encoding="utf-8")
    return np.asarray(ByteTokenizer().encode(text), np.int64)[:512][None]


def opt_real_weights(dev="cuda"):
    """Phase 9: ``assets/byteopt_4m`` calibrated to W8A8 by the port's
    ``quantize_opt_w8a8`` (smooth_alpha 0.5, ``byteopt_calib_ids``); ppl
    budgets on 6144 eval tokens (fp < 3.5, W8A8 <= +1 %); 32 greedy tokens
    of each golden prompt through Engine on the card against the same
    parameters on the CPU, fp (``flash_decode``) and W8A8
    (``int8_decode``), then W8A8 through ServingEngine (2 slots) on the
    card against Engine on the card: >= 16 tokens must agree. Returns a
    summary."""
    from tinychatengine_tpu_torch.core.config import (GenerationConfig,
                                                      QuantConfig,
                                                      get_model_config)
    from tinychatengine_tpu_torch.generation.engine import Engine
    from tinychatengine_tpu_torch.models import opt
    from tinychatengine_tpu_torch.ops import _build
    from tinychatengine_tpu_torch.runtime.serving import ServingEngine
    from tinychatengine_tpu_torch.tokenizers.byte_fallback import ByteTokenizer
    from tinychatengine_tpu_torch.tools.calibrate_opt import quantize_opt_w8a8
    from tinychatengine_tpu_torch.tools.checkpoint import load_checkpoint
    from tinychatengine_tpu_torch.tools.perplexity import perplexity

    cfg = get_model_config("byteopt_4m")
    fp, _ = load_checkpoint(str(OPT_CKPT), cfg, device=dev)
    qp = quantize_opt_w8a8(fp, cfg, byteopt_calib_ids(), 0.5, device=dev)
    tok = ByteTokenizer()
    ids = np.asarray(tok.encode((OPT_CKPT / "eval_sample.txt").read_text(
        encoding="utf-8")), np.int64)[:6144]
    ppl = {name: perplexity(opt.forward, p, cfg, ids, 512, 256)
           for name, p in (("fp", fp), ("w8a8", qp))}
    log("byteopt_4m ppl on 6144 tokens:", json.dumps(ppl))
    if not (ppl["fp"] < 3.5 and ppl["w8a8"] <= ppl["fp"] * 1.01):
        raise SystemExit("byteopt_4m perplexity outside the ACCURACY.md "
                         "budgets (fp < 3.5, w8a8 <= +1 %)")

    golden = ROOT / "tests" / "golden"
    golds = [json.loads((golden / "bytellama_greedy.json").read_text())]
    golds += json.loads((golden / "bytellama_goldens.json").read_text())
    prompts = [np.asarray(tok.encode(gd["prompt"]), np.int64) for gd in golds]
    g = GenerationConfig(temp=0.0, n_predict=32, repeat_penalty=1.0,
                         repeat_last_n=1)

    def agree(a, b):
        return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                    min(len(a), len(b)))
    out = dict(ppl=ppl)
    # fp decodes through flash_decode, W8A8 through int8_decode; W8A8 also
    # through ServingEngine's int8 slot cache
    for scheme, p in (("fp", fp), ("w8a8", qp)):
        qcfg = QuantConfig(scheme=scheme)
        card = Engine(p, cfg, qcfg, max_len=cfg.max_sqlen, device=dev)
        host = Engine(tree_map(p, lambda t: t.to("cpu")), cfg, qcfg,
                      max_len=cfg.max_sqlen, device="cpu")
        with plain_calls() as plain:
            _build.reset_launches()
            want = [card.generate(x[None], g).tokens[0] for x in prompts]
            if scheme == "w8a8":
                srv = ServingEngine(p, cfg, qcfg, slots=2,
                                    max_len=cfg.max_sqlen, gcfg=g,
                                    forward_fn=opt.forward, device=dev)
                reqs = [srv.submit(x) for x in prompts]
                srv.run()
            launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        got_cpu = [host.generate(x[None], g).tokens[0] for x in prompts]
        out[f"{scheme} card_vs_cpu"] = [agree(a, b)
                                        for a, b in zip(want, got_cpu)]
        out[f"{scheme} launches"] = launches
        if dev == "cuda" and (any(plain.values()) or not launches.get(
                "int8_decode" if scheme == "w8a8" else "flash_decode")):
            raise SystemExit(f"byteopt_4m {scheme}: plain calls {plain}, "
                             f"launches {launches}")
        if min(out[f"{scheme} card_vs_cpu"]) < 16:
            raise SystemExit(f"byteopt_4m {scheme}: the card and the CPU "
                             "diverged within 16 tokens")
    out["w8a8 serving_vs_engine"] = [agree(r.output_ids, w)
                                     for r, w in zip(reqs, want)]
    for x, w, r, n in zip(prompts, want, reqs, out["w8a8 serving_vs_engine"]):
        if n < len(w):  # the gap between the top two logits where they part
            logits, _ = card.prefill(np.asarray([list(x) + w[:n]]),
                                     card.new_cache())
            top = torch.topk(logits[0].float(), 2).values
            log(f"byteopt_4m serving parts from Engine at step {n}: "
                f"{r.output_ids[n]} vs {w[n]}, top-2 logit gap "
                f"{float(top[0] - top[1]):.4g}")
    log("byteopt_4m tokens agreeing:", json.dumps(out))
    if min(out["w8a8 serving_vs_engine"]) < 16:
        raise SystemExit("byteopt_4m w8a8: ServingEngine diverged from "
                         "Engine within 16 tokens")
    return out


SUMMARY = {  # kernel -> (source, TPU kernel it replaces, summary case)
    "int4_matmul": ("tinychatengine_tpu_torch/csrc/int4_matmul.cu",
                    "tinychatengine_tpu/ops/int4_matmul.py:409",
                    "gate_up M=2048 K=4096 N=28672"),
    "int4_matmul_a8": ("tinychatengine_tpu_torch/csrc/int4_matmul_a8.cu",
                       "tinychatengine_tpu/ops/int4_matmul.py:930",
                       "gate_up M=1 K=4096 N=28672"),
    "flash_decode": ("tinychatengine_tpu_torch/csrc/flash_decode.cu",
                     "tinychatengine_tpu/ops/attention.py:204",
                     "B=1 Hq=32 Hkv=8 D=128 length=320"),
    "flash_prefill": ("tinychatengine_tpu_torch/csrc/flash_prefill.cu",
                      "tinychatengine_tpu/ops/attention.py:549",
                      "B=1 S=2048 start=0 Hq=32 Hkv=8 D=128"),
    "flash_decode_paged": ("tinychatengine_tpu_torch/csrc/flash_decode_paged.cu",
                           "tinychatengine_tpu/ops/attention.py:375",
                           "B=8 Hq=32 Hkv=8 D=128 P=128 ragged"),
    "int8_decode": ("tinychatengine_tpu_torch/csrc/int8_decode.cu",
                    "tinychatengine_tpu/ops/attention.py:718",
                    "B=1 H=32 D=128 length=320"),
    "int4_matmul_fused": ("tinychatengine_tpu_torch/csrc/int4_matmul_fused.cu",
                          "tinychatengine_tpu/ops/int4_matmul.py:700",
                          "starcoder fc_out M=1 K=24576 N=6144"),
    "flash_decode_int8": ("tinychatengine_tpu_torch/csrc/flash_decode.cu",
                          "tinychatengine_tpu/ops/attention.py:204",
                          "B=1 Hq=32 Hkv=8 D=128 length=4095"),
    "flash_prefill_int8": ("tinychatengine_tpu_torch/csrc/flash_prefill.cu",
                           "tinychatengine_tpu/ops/attention.py:549",
                           "B=1 S=2048 start=0 Hq=32 Hkv=8 D=128"),
    "flash_decode_paged_int8": (
        "tinychatengine_tpu_torch/csrc/flash_decode_paged.cu",
        "tinychatengine_tpu/ops/attention.py:375",
        "B=8 Hq=32 Hkv=8 D=128 P=128 ragged 1..4607"),
    "int4_matmul_kouter": (
        "tinychatengine_tpu_torch/csrc/int4_matmul_kouter.cu",
        "tinychatengine_tpu/ops/int4_matmul.py:358",
        "gate_up M=1 K=4096 N=28672"),
    "int4_matmul_glu": ("tinychatengine_tpu_torch/csrc/int4_matmul_kouter.cu",
                        "tinychatengine_tpu/ops/int4_matmul.py:805",
                        "down M=1 F=14336 N=4096"),
    "mlp_fused": ("tinychatengine_tpu_torch/csrc/mlp_fused.cu",
                  "tinychatengine_tpu/ops/mlp_fused.py:183",
                  "llama3_8b M=1 E=4096 F=14336"),
    "int3_matmul": ("tinychatengine_tpu_torch/csrc/int3_matmul.cu",
                    "tinychatengine_tpu/ops/int3_matmul.py:134",
                    "gate_up M=1 K=4096 N=28672"),
}
# the run each kernel's launches count comes from: phase 4's Engine path,
# phase 5's paged serving run for the paged kernel, phase 7's OPT Engine
# path for int8_decode, phase 10's fused StarCoder Engine path for
# int4_matmul_fused, phase 4c's int8-KV Engine path for the int8 dense
# kernels and phase 4d's int8 paged run for the int8 paged one; per decode
# step from the same Engine path; per tick from phase 5's paged run, phase
# 8's OPT run for int8_decode, phase 11's paged StarCoder run for
# int4_matmul_fused and phase 4d's int8 runs (dense, paged) for the int8
# kernels; phase 4f's K-outer Engine path for int4_matmul_kouter, and phase
# 3's calls for the three kernels no path of the JAX package runs (the GLU
# down projection, the fused MLP, int3)
HOME_RUN = {"flash_decode_paged": "serving_paged", "int8_decode": "opt_engine",
            "int4_matmul_fused": "starcoder_fused",
            "flash_decode_int8": "llama_int8kv_engine",
            "flash_prefill_int8": "llama_int8kv_engine",
            "flash_decode_paged_int8": "long_int8_paged",
            "int4_matmul_kouter": "llama_w4a16_kouter",
            "int4_matmul_glu": "kernels", "mlp_fused": "kernels",
            "int3_matmul": "kernels"}


def sass_count(lib: Path, opcode: str) -> int:
    """Instructions of ``opcode`` in the SASS of a built library
    (``cuobjdump -sass``, beside nvcc in the CUDA toolkit)."""
    from tinychatengine_tpu_torch.ops import _build
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    return sum(opcode in line for line in sass.splitlines())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (no main path)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from tinychatengine_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    hgmma = sass_count(libs["int4_matmul"], "HGMMA")
    log(f"int4_matmul SASS (cuobjdump -sass): {hgmma} HGMMA instructions")
    if not hgmma:
        raise SystemExit("int4_matmul's tile route has no HGMMA in its SASS")
    mma = {op: sass_count(libs["flash_prefill"], op) for op in ("HMMA", "HGMMA")}
    log(f"flash_prefill SASS (cuobjdump -sass): {mma['HMMA']} HMMA, "
        f"{mma['HGMMA']} HGMMA instructions")
    if not any(mma.values()):
        raise SystemExit("flash_prefill runs no product on the tensor cores "
                         "(no HMMA or HGMMA in its SASS)")
    for lib, ops in (("int4_matmul_kouter", ("HMMA", "HGMMA")),
                     ("int4_matmul_fused", ("HMMA", "HGMMA")),
                     ("mlp_fused", ("HMMA", "HGMMA")),
                     ("int3_matmul", ("HMMA", "HGMMA")),
                     ("int4_matmul_a8", ("IMMA", "IGMMA"))):
        mma = {op: sass_count(libs[lib], op) for op in ops}
        log(f"{lib} SASS (cuobjdump -sass): "
            + ", ".join(f"{n} {op}" for op, n in mma.items())
            + " instructions")
        if not any(mma.values()):
            raise SystemExit(f"{lib} runs no product on the tensor cores (no "
                             f"{' or '.join(ops)} in its SASS)")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    phase_s = {"build": time.perf_counter() - t0}

    def phase(name, fn, *a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        phase_s[name] = time.perf_counter() - t
        log(f"phase {name}: {phase_s[name]:.1f} s")
        return out
    _build.reset_launches()
    cases = phase("kernels", check_kernels, gen)
    kernel_launches = dict(_build.LAUNCHES)
    linears = phase("w8a8 linears", w8a8_linear_times, gen)
    if args.kernels_only:
        return 0
    from tinychatengine_tpu_torch.core.config import (QuantConfig,
                                                      get_model_config)
    llama = random_model(get_model_config("llama3_8b"), "cuda")
    launches, per_step, metrics = phase("llama main path", main_path,
                                        model_params=llama, eager_rate=True)
    w4a16 = (as_w4a16(llama[0]), QuantConfig(scheme="w4a16"))
    llama_ab = phase("llama w4a16 fused decode", fused_ab, "llama3_8b",
                     model_params=w4a16, n_predict=SHORT_DECODE)
    kouter = phase("llama w4a16 K-outer decode", kouter_engine, "llama3_8b",
                   w4a16, unfused_tokens=llama_ab["unfused"][2]["tokens"])
    del w4a16
    kv8 = phase("llama int8 KV", int8_kv_engine, "llama3_8b", llama)
    long_ctx = phase("llama long-context serving", long_serving, "llama3_8b",
                     llama)
    pfx = phase("llama int8-KV prefix cache", prefix_serving, "llama3_8b",
                llama)
    spec = phase("llama logprobs and speculation", spec_logprobs_serving,
                 "llama3_8b", llama)
    del llama
    torch.cuda.empty_cache()
    serving = phase("llama serving", serving_path, n_predict=64)
    phase("bytellama real weights", real_weights)
    phase("bytellama serving", real_weights_serving)
    phase("bytellama g32 fused decode", fused_real_weights)
    opt_launches, opt_step, opt_metrics = phase("opt main path", main_path,
                                                "opt_6.7b", n_predict=128)
    opt_serving = phase("opt serving", serving_path, "opt_6.7b",
                        n_requests=16, n_predict=64)["dense"]
    phase("byteopt real weights", opt_real_weights)
    sc_ab = phase("starcoder main path", fused_ab, "starcoder_15.5b",
                  n_predict=SHORT_DECODE)
    sc_serving = phase("starcoder serving", serving_path, "starcoder_15.5b",
                       n_requests=16, n_predict=64, fused=True)
    vlm_launches, vlm = phase("vila vlm path", vlm_path)

    runs = {"engine": launches,  # path -> launches over its run
            "kernels": kernel_launches,
            "llama_w4a16_kouter": kouter["run"][0],
            "serving_dense": serving["dense"]["launches"],
            "serving_paged": serving["paged"]["launches"],
            "llama_w4a16_unfused": llama_ab["unfused"][0],
            "llama_w4a16_fused": llama_ab["fused"][0],
            "opt_engine": opt_launches, "opt_serving": opt_serving["launches"],
            "starcoder_unfused": sc_ab["unfused"][0],
            "starcoder_fused": sc_ab["fused"][0],
            "starcoder_serving_dense": sc_serving["dense"]["launches"],
            "starcoder_serving_paged": sc_serving["paged"]["launches"],
            "llama_int8kv_engine": kv8[0],
            **{"long_" + k.replace(" ", "_"): m["launches"]
               for k, m in long_ctx.items()},
            **{"prefix_" + k.replace(" ", "_"): m["launches"]
               for k, m in pfx.items() if k != "tokens_equal_uncached"},
            "logprobs_dense": spec["dense"]["launches"],
            "logprobs_paged": spec["paged"]["launches"],
            "spec_serving": spec["speculative"]["speculative"]["launches"],
            "vlm_engine": vlm_launches}
    step_of = {"int8_decode": opt_step, "int4_matmul_fused": sc_ab["fused"][1],
               "int4_matmul_kouter": kouter["run"][1],
               **dict.fromkeys(INT8_KV.values(), kv8[1])}
    tick_of = {"int8_decode": opt_serving,
               "int4_matmul_fused": sc_serving["paged"],
               "flash_decode_int8": long_ctx["int8 dense"],
               "flash_prefill_int8": long_ctx["int8 dense"],
               "flash_decode_paged_int8": long_ctx["int8 paged"]}
    rows = []
    for name in _build.KERNELS:
        source, replaces, case = SUMMARY[name]
        mine = [c for c in cases if c["kernel"] == name]
        row = next(c for c in mine if c["case"] == case
                   or c["case"].startswith(case + " "))
        tick_run = tick_of.get(name, serving["paged"])
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=runs[HOME_RUN.get(name, "engine")][name],
            launches_by_path={path: n[name] for path, n in runs.items()},
            launches_per_decode_step=step_of.get(name, per_step)[name],
            launches_per_serving_tick=tick_run["launches"][name]
            / tick_run["decode_ticks"],
            max_abs_err=max(c["max_abs_err"] for c in mine), case=row["case"],
            ms=row["ms"], eager_ms=row["eager_ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"]))
    engine_runs = [("llama3_8b w4a8", metrics),
                   ("llama3_8b w4a8 int8 KV", kv8[2]),
                   ("llama3_8b w4a16 K-outer", kouter["run"][2]),
                   ("opt_6.7b w8a8", opt_metrics)]
    for model, ab in (("llama3_8b w4a16", llama_ab),
                      ("starcoder_15.5b w4a16", sc_ab)):
        engine_runs += [(f"{model} {mode}", ab[mode][2])
                        for mode in ("unfused", "fused")]
        log(f"{model} first decode step, fused vs unfused:",
            json.dumps(ab["first_step"]))
    for model, m in engine_runs:
        log(f"{model} main path (CUDA graphs) on {smi}: decode "
            f"{m['decode_tok_s']:.2f} tok/s, TTFT {m['ttft_ms']:.1f} ms, "
            f"prefill {m['prefill_tok_s']:.1f} tok/s, replayed step "
            f"{m.get('decode_replay_ms_per_step', 'not measured')} ms, "
            f"device {m.get('decode_device_ms_per_step', 'not measured')} "
            f"ms per step, busy share "
            f"{m.get('decode_busy_share', 'not measured')}, graph nodes per "
            f"step {m.get('decode_graph_nodes_per_step', 'not measured')} "
            f"(kernel sum "
            f"{m.get('decode_kernel_sum_ms_per_step', 'not measured')} ms), "
            f"{m.get('graph_captures')} captures in "
            f"{m.get('graph_capture_s')} s; tokens equal to the eager "
            f"loop's: {m['graph_eq_eager']}")
    log(f"llama3_8b w4a8 decode on {smi}: CUDA graphs "
        f"{metrics['decode_tok_s']:.2f} tok/s, eager loop "
        f"{metrics['eager_decode_tok_s']:.2f} tok/s")
    log("llama3_8b first decode step, int8 vs bf16 KV:",
        json.dumps(kv8[2]["first_step_vs_bf16_kv"]))
    log("llama3_8b first decode step, K-outer vs int4_matmul:",
        json.dumps(kouter["first_step"]), "greedy tokens agreeing with the "
        f"unfused run: {kouter['tokens_agreeing']} of {SHORT_DECODE}")
    for mode, m in (("llama3_8b dense", serving["dense"]),
                    ("llama3_8b paged", serving["paged"]),
                    *((f"llama3_8b long-context {k}", v)
                      for k, v in long_ctx.items()),
                    *((f"llama3_8b int8-KV prefix {k}", v)
                      for k, v in pfx.items()
                      if k != "tokens_equal_uncached"),
                    ("opt_6.7b dense", opt_serving),
                    ("starcoder_15.5b fused dense", sc_serving["dense"]),
                    ("starcoder_15.5b fused paged", sc_serving["paged"])):
        log(f"serving {mode} on {smi}: {m['tok_s']:.1f} tok/s, TTFT p50 "
            f"{m['ttft_p50_s']:.3f} s p95 {m['ttft_p95_s']:.3f} s, "
            f"ticks {json.dumps(m['tick_stats'])}"
            + (f", prefix {json.dumps(m['prefix_stats'])}"
               if m.get("prefix_stats") else ""))
    for mode in ("dense", "paged"):
        m = sc_serving[mode]
        log(f"starcoder_15.5b fused serving {mode} on {smi}: "
            f"int4_matmul_fused "
            f"{m['burst'].get('fused_device_ms_per_tick', 'not measured')} "
            f"device ms per tick of "
            f"{m['burst'].get('tick_device_ms', 'not measured')}, "
            f"{m['launches']['int4_matmul_fused'] / m['decode_ticks']} "
            f"launches per tick")
    for mode in ("dense", "paged"):
        b = serving[mode]["burst"]
        log(f"llama3_8b w4a8 serving {mode} on {smi}: int4_matmul_a8 "
            f"{b.get('a8_device_ms_per_tick', 'not measured')} device ms per "
            f"tick of {b.get('tick_device_ms', 'not measured')}, "
            f"{serving[mode]['launches']['int4_matmul_a8']} launches over "
            f"{serving[mode]['decode_ticks']} ticks")
    for mode in ("dense", "dense without logprobs", "paged", "dense eager"):
        m = spec[mode]
        log(f"llama3_8b w4a8 logprobs serving {mode} on {smi}: "
            f"{m['tok_s']:.1f} tok/s, TTFT p50 {m['ttft_p50_s']:.3f} s, "
            f"ticks {json.dumps(m['tick_stats'])}")
    sp = spec["speculative"]
    log(f"llama3_8b w4a8 speculative serving on {smi}: "
        f"{sp['speculative']['tok_s']:.1f} tok/s with speculation "
        f"({sp['speculative']['tokens_per_spec_tick']:.2f} tokens per spec "
        f"tick, {json.dumps(sp['speculative']['spec_stats'])}), "
        f"{sp['plain']['tok_s']:.1f} tok/s without; partings from plain "
        f"greedy: {json.dumps(sp['partings'])}")
    log(f"llama3_8b w4a8 generate_pld on {smi}: {json.dumps(spec['pld'])}")
    log(f"vila_7b w4a8 + clip_vit_large on {smi}: CLIP encode "
        f"{vlm['encode_ms']:.2f} ms (bf16, CUDA events), image TTFT "
        f"{vlm['image_ttft_ms']:.1f} ms, decode {vlm['decode_tok_s']:.2f} "
        f"tok/s (CUDA graphs), weights by count {vlm['decoder_gb']:.3f} + "
        f"{vlm['tower_gb']:.3f} GB")
    log("w8a8 linears at M = 1:", json.dumps(linears))
    log("phase seconds:", json.dumps(phase_s))
    log(smi)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
