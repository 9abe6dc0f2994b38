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
3e. the expert layer (``check_experts``) at Mellum2-12B-A2.5B's widths
   (64 experts, top-8, E 2304, F 896 stored at K 1024): its five kernels
   (route, plan, the grouped int4 matmul, act, combine) against their
   plain versions at a 32-slot tick and a 512-row chunk (x 8 pairs), one
   expert given no row; the grouped matmul timed beside its bound over
   the experts read and ``torch.matmul`` an expert at a time, and held
   within ``MOE_BOUND_X`` of the bound; then mellum2_12b_a2.5b W4A16 at
   full width and depth served (8 slots) and one step counted from zeroed
   counters: per tick each expert kernel once a layer (``int4_moe``
   twice), ``flash_decode`` once a layer, ``int4_matmul`` twice a layer
   and once for the head, nothing else, no plain version, and 8 pairs a
   slot's row a layer in the expert counters;
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
   image, one ServingEngine request with the embeds, the same image and
   prompt as an ``image_url`` chat request (a PNG data URL) to the REST
   server over that engine, 2-layer cuts of the decoder and the tower
   against the CPU;
14. the text front end and the REST server (``http_serving``) on phase
   4's llama3_8b W4A8 weights: a synthetic 128000-rank Llama-3
   ``tokenizer.model`` through ``load_tokenizer``; ``InferenceServer``
   over phase 5's ServingEngine, dense then paged, under
   scripts/bench_serving.py main_http's load (24 concurrent clients, 64
   tokens each after a 2-request warm-up): HTTP tok/s, ``engine.step()``
   seconds against the wall, TTFT, the tick mix; served tokens equal to
   the same requests submitted in-process; SSE equal to the non-streamed
   text, a stop string truncating and freeing the slot, ``logprobs=5``
   equal to the engine's, embeddings within ``EMB_CARD_TOL`` of an eager
   forward, ``/metrics``' tokens equal to the usage fields, the kernels
   of the mode and 0 plain calls; chat.py's ``repl`` (two greedy turns)
   against ``Engine.generate``; serve.py as a subprocess on bytellama_5m
   against ``Engine.generate``, ended by SIGINT without a traceback.
15. the conversion toolchain (``convert_path``): llama3_8b at full width
   cut to ``CONVERT_LAYERS`` layers, written as two HF safetensors shards
   of seeded bf16 tensors with AWQ's motif (salient channels: norm weights
   x20, their weight rows x0.05); ``convert_hf_llama`` to W4A8 (layer 0's
   and the lm_head's packed bytes and scales equal to numpy's quantizer
   and packer on the source weights); to fp, then
   ``awq_scale_llama`` over 16 x 512 seeded ids (``flash_prefill`` once a
   layer and no other kernel, no plain version; every chosen loss at most
   RTN's, qkv and gate_up alpha > 0 at most ``AWQ_RTN_SHARE`` of it; layer
   0's wo search against numpy's on the host, the card's int4 round trip
   against numpy's, the folded model's logits within ``FOLD_TOL``);
   requantized, saved, loaded, through ``Engine.generate_device`` (graph
   == eager, the W4A8 path's kernels, no plain version), its first decode
   step against the CPU's plain forward of the checkpoint (``CUT_TOL``),
   and the same scaled tree requantized to W4A16, its prefill and first
   step held to the CPU's plain forward (``CUT_TOL``); bytellama_5m
   exported to HF and converted by the CLI with and without
   ``--awq-calib`` (the card's corpus, 16 x 512), fp / RTN / AWQ
   perplexity (AWQ's Delta at most RTN's + ``AWQ_PPL_SLACK`` points); the
   native library (``read_file``, the Llama-3 tokenizer's C++ merge
   against its Python merge under ``TINYCHAT_NO_NATIVE``). Phase 3 holds
   ``flash_prefill`` at the calibration's shape. A faulted fold (layer
   0's input norm left undivided) must read above ``FOLD_TOL``.
16. the byte models trained on the card (``train_path``):
   ``tools/train_tiny.main`` trains bytellama_5m and byteopt_4m at full
   width (``TRAIN_STEPS``, batch 16 x 512 on ``TRAIN_CORPUS_MB`` MB of
   local source) and scores them on ``TRAIN_EVAL_TOKENS`` held-out tokens;
   the training steps launch no kernel (llama's attention calls
   ``flash_prefill_plain`` while autograd records, OPT's its dense
   attention), the evaluation launches ``int4_matmul``, ``flash_prefill``
   and ``flash_prefill_int8``; the first step's loss and every scheme's
   ppl within ``TRAIN_RTOL`` of the CPU's; ``TWIN_STEPS`` steps on the
   card and on the CPU from one init and one set of offsets, every loss
   within ``TWIN_RTOL`` and every tensor within ``TWIN_SHARE`` of its
   change (``train_twin``); the loss falls
   below ``TRAIN_LOSS_SHARE`` of the first step's, the fp ppl below
   ``TRAIN_PPL_SHARE`` of the untrained init's; the trained bytellama
   through ``load_checkpoint`` and ``Engine``, fp and W4A8, against the
   CPU (phase 9's rule); byteopt's prefill from ``input_embeds`` equal to
   its prefill from ids bit for bit (phase 10 checks StarCoder's);
   ``bench_op`` on phase 3's ``int4_matmul_a8`` qkv case at M = 1, less
   the same chain on the identity op (the feed), within ``BENCH_OP_RTOL``
   of its time there; ``device_trace`` of one W4A8
   decode step naming its kernels;
17. tensor, sequence and pipeline parallelism, the ranks processes that
   time-share the one card over gloo (``parallel/``; no figure of this
   phase is a scaling figure): (a) ``shard_shape_cases``, in this process:
   ``int4_matmul_a8`` at TP = 2's five shard shapes (``TP2_SHAPES``) at
   M = 1, 4 and 64, ``int4_matmul``'s tile route at 1024 rows (an SP
   rank's half of a 2048-token prompt), ``flash_decode`` /
   ``flash_prefill`` at Hq 16 over Hkv 4 and ``flash_decode_paged`` there
   over 4 ragged slots, each held to its plain version; (b)-(e)
   ``parallel_path``: ``why_this_model`` (printed), the one-process runs
   of llama3_8b W4A8 (full width and depth, random centred weights of
   scale ``PAR_STD`` from one seed) here, then 2 ranks (``par_rank``):
   (b) TP = 2 through ``Engine`` and ``make_tp_forward`` (64-token
   prompt, 32 greedy tokens, eager), teacher-forced step logits within
   ``PAR_STEP_TOL`` of the one-process run's, as one process with TP's
   rounding (``split_rows``) must be, while rank 1 taking rank 0's wo
   rows in one layer, and another prompt, must read above it; tokens
   equal up to a parting at a tie (``partings``), per step tok/s,
   all-reduces, all-gathers and host ms inside collectives, launches per
   step; (c) 4 requests x 32 tokens through a paged ``ServingEngine`` on
   the TP forward against one process's; (d) a 2048-token prompt through
   ``make_sp_prefill`` over 2 seq ranks, ``sp_cache_into`` and 8 decode
   steps, the last-token logits and every layer's spliced K/V against
   the one-process prefill, a ring hop that hands each rank its own
   block reading above the limit; (e) 2 rows of 64 tokens through
   ``make_pp_forward`` (2 stages x 16 layers, 2 microbatches) and 8
   decode steps; each part's kernels must launch on both ranks, the same
   counts on each, no plain version on the card; (f) ``tools/scaling.py``
   ``--configs 1x1,1x2`` (4 layers, W4A8, 8 tokens).

The Engine and the server run their captured CUDA graphs
(``generation/cuda_graph.py``): in phases 4, 4b, 4c, 4f, 7 and 10 the
prompt chunks and the decode step of ``generate_device`` replay graphs
(TTFT and the 2048-token prefill replay their prompt graphs, each timed
once captured), and an eager Engine (``cuda_graphs=False``) on the same
weights must choose the same greedy token at every step; phase 4 also
times the eager loop's decode rate (over ``EAGER_RATE_TOKENS``-token
trials). ``decode_profile`` replays the
captured step: its device ms by CUDA events and by kernel, busy share and
graph nodes a step. The serving phases replay the captured tick (bursts
and single ticks; admission stays eager); phase 6b runs each server again
with ``cuda_graphs=False`` and needs identical tokens, dense and paged.
Launch counts and plain-version counts are per replay
(``_build.record_launches``), so every exact count keeps its meaning.

The line before the last is ``{"kernels": [...]}`` (``int4_matmul``'s row
adds the tile route's launches by token-tile width in phase 3, which must
run each width, and in the timed runs of phases 5 and 11); the last line is
``{"ok": true, "device": {...}}``. ``--kernels-only`` stops after phase
3e; ``--experts-only`` builds, then runs phase 3e alone.
Each phase prints its seconds.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import functools
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
# phase 15 (the conversion toolchain): llama3_8b at full width cut to
# CONVERT_LAYERS layers; the AWQ calibration of the convert CLI's default,
# AWQ_WINDOWS windows of AWQ_WINDOW tokens; AWQ_MOTIF salient channels a
# layer in the synthetic source; qkv and gate_up must choose a loss at most
# AWQ_RTN_SHARE of the alpha = 0 (RTN) loss; layer 0's wo search held to
# numpy's over AWQ_HOST_ROWS rows within AWQ_HOST_RTOL, which must lie
# between the sound search's loss gap (the card's and the host's f32
# y_ref sum in other orders) and the gaps of the faulted searches
# (FAULTED_SEARCHES) read in the same run (PERF.md, section 6);
# the folded model's logits within
# FOLD_TOL of max |logit| (tests/test_awq.py's bound), which a faulted fold
# read in the same run must exceed; bytellama_5m's AWQ
# Delta ppl at most AWQ_PPL_SLACK percentage points above RTN's
CONVERT_LAYERS = 4
AWQ_WINDOWS, AWQ_WINDOW = 16, 512
AWQ_MOTIF = 16
AWQ_RTN_SHARE = 0.9
AWQ_HOST_ROWS = 256
AWQ_HOST_RTOL = 1e-7
FOLD_TOL = 3e-2
AWQ_PPL_SLACK = 0.05
# ACCURACY.md "AWQ vs round-to-nearest": the JAX package on a CPU, 32768
# eval tokens (scripts/measure_awq.py); another machine's corpus draws other
# calibration windows
ACCURACY_CPU_PPL = {"fp": 2.6092, "rtn_w4a16": 2.6374, "awq_w4a16": 2.6334}


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


# starcoder_15.5b's linears: (K, N)
STARCODER_LINEARS = {"c_attn": (6144, 6400), "c_proj": (6144, 6144),
                     "fc_in": (6144, 24576), "fc_out": (24576, 6144),
                     "lm_head": (6144, 49152)}


def check_kernels(gen):
    """Phase 3: every kernel against its plain version at the main path's
    shapes, timed. Returns one row per case."""
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
    # the tile route at StarCoder-15.5B W4A16's widths: the five linears
    # of a 16-row decode tick (16 paged slots with FUSED_DECODE off; K
    # split 4 at c_attn, c_proj and fc_out) and the layer's four at a
    # 512-row admission chunk (two 256-row tiles); the 32- and 128-row
    # tiles at a ragged 24-row tick and a 100-row batch
    for name, (k, n) in STARCODER_LINEARS.items():
        w4 = (16,) if name == "lm_head" else (16, 512)
        int4_cases(gen, add, name, k, n, (),
                   w4 + {"c_attn": (24,), "fc_out": (100,)}.get(name, ()),
                   label="starcoder ")

    # ---- attention over a 32-layer stacked cache (B=1, Hkv=8, S=2048)
    # (and StarCoder's MQA: 48 query heads on one KV head, 6 blocks a row)
    L, S = 32, 2048
    for d, hq, hkv in ((128, 32, 8), (64, 32, 8), (128, 48, 1)):
        ck = torch.randn((L, 1, hkv, S, d), device=dev, generator=gen).to(torch.bfloat16)
        cv = torch.randn((L, 1, hkv, S, d), device=dev, generator=gen).to(torch.bfloat16)
        lengths = {(128, 32): (1, 65, 320, 2047), (64, 32): (65, 2047),
                   (128, 48): (320, 2047)}[(d, hq)]
        for length in lengths:
            decode_case(gen, add, ck, cv, hq, length)
        for s, start in ((2048, 0), (64, S - 64)):
            if (d == 64 or hkv == 1) and s == 64:
                continue
            prefill_case(gen, add, ck, cv, hq, s, start)
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


def decode_case(gen, add, ck, cv, hq: int, length: int, label: str = ""):
    """``flash_decode`` of one random query row [1, hq, D] over ``length``
    keys of the B = 1 stacked cache ``ck``/``cv`` [L, 1, Hkv, S, D] at its
    first and last layers, held to its plain version and timed."""
    from tinychatengine_tpu_torch.ops import attention as att
    L, _, hkv, _, d = ck.shape
    dev = ck.device
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
    plain_ms = time_ms(lambda: att.flash_decode_plain(q, ck, cv, 0, length),
                       10)
    g = hq // hkv
    kr = ck[0, :, :, :length].repeat_interleave(g, dim=1)
    vr = cv[0, :, :, :length].repeat_interleave(g, dim=1)
    add("flash_decode", f"{label}B=1 Hq={hq} Hkv={hkv} D={d} length={length}",
        err, share, ATTN_TOL_TEXT, run, 64, plain_ms,
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], kr, vr),
        2 * hq * d * 2 + 2 * hkv * length * d * 2, 4.0 * hq * length * d,
        BF16_FLOP_S)


def prefill_case(gen, add, ck, cv, hq: int, s: int, start: int,
                 label: str = ""):
    """``flash_prefill`` of a random [1, s, hq, D] chunk at ``start`` over
    the B = 1 stacked cache at its first and last layers, held to its
    plain version and timed beside masked SDPA (and causal SDPA at start
    0)."""
    from tinychatengine_tpu_torch.ops import attention as att
    L, _, hkv, _, d = ck.shape
    dev = ck.device
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
    g = hq // hkv
    kr = ck[0, :, :, :length].repeat_interleave(g, dim=1)
    vr = cv[0, :, :, :length].repeat_interleave(g, dim=1)
    qt = q.transpose(1, 2)
    mask = (torch.arange(length, device=dev)[None, :]
            <= start + torch.arange(s, device=dev)[:, None])
    pairs = sum(min(start + r + 1, length) for r in range(s))
    add("flash_prefill", f"{label}B=1 S={s} start={start} Hq={hq} Hkv={hkv} "
        f"D={d}", err, share, ATTN_TOL_TEXT, run, it, plain_ms,
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kr, vr, attn_mask=mask),
        2 * s * hq * d * 2 + 2 * hkv * length * d * 2,
        4.0 * hq * pairs * d, BF16_FLOP_S,
        library_causal_ms=causal_ms(qt, kr, vr, it) if start == 0 else None)


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
    """``flash_prefill`` at three more main-path shapes (llama3_8b: Hq 32,
    Hkv 8, D 128, bf16, 32 layers cycled): phase 5's batched admission (8
    rows at start 0 with ragged lengths from its prompt mix, in the 512-row
    bucket, rows past a length attending to its whole prefix), a 512-row
    chunk of a long-context prompt at start 3072 (phase 4d's admission, a
    4608-key cache) and phase 15's AWQ calibration forward (16 windows of
    512 at start 0, scalar start and length). Library: SDPA with the same
    mask; causal: SDPA with ``is_causal`` over each batch's full 512-row
    squares."""
    from tinychatengine_tpu_torch.ops import attention as att
    dev = torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    L, hq, hkv, d = 32, 32, 8, 128
    lens = admission_lengths(8, model_config("llama3_8b").vocab_size)
    calib = (AWQ_WINDOWS, AWQ_WINDOW)  # phase 15's calibration forward
    for b, s, smax, start, lengths in ((8, 512, 512, 0, lens),
                                       (1, 512, 4608, 3072, (3584,)),
                                       (*calib, calib[1], 0,
                                        (calib[1],) * calib[0])):
        ck = torch.randn((L, b, hkv, smax, d), device=dev, generator=gen).to(torch.bfloat16)
        cv = torch.randn((L, b, hkv, smax, d), device=dev, generator=gen).to(torch.bfloat16)
        q = torch.randn((b, s, hq, d), device=dev, generator=gen).to(torch.bfloat16)
        # the calibration forward's scalar start and length
        scalar = b == 1 or len(set(lengths)) == 1
        length = (lengths[0] if scalar else
                  torch.tensor(lengths, dtype=torch.int32, device=dev))
        st = start if scalar else torch.zeros(b, dtype=torch.int32,
                                               device=dev)
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
        if b > 1 and scalar:
            case = f"B={b} S={s} start=0 Hq={hq} Hkv={hkv} D={d} " \
                   "AWQ calibration"
        elif b > 1:
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


# (layers, D, Hq, Hkv, page, windows): llama3_8b (GQA, page 128 and a
# window), bytellama's D = 64 at page 16, StarCoder's MQA (one KV head: 64
# layers so the cycled keys leave L2)
SERVING_SHAPES = ((32, 128, 32, 8, 128, (None, 256)),
                  (32, 64, 32, 8, 16, (None,)),
                  (64, 128, 48, 1, 128, (None,)))


def check_serving_kernels(gen, add, shapes=SERVING_SHAPES,
                          serving_lengths=SERVING_LENGTHS, label=""):
    """Decode attention at the serving shapes: 8 slots with ragged lengths,
    dense (``flash_decode``) and paged (``flash_decode_paged``, a shuffled
    page table), on the same keys, over a 32-layer stack (or ``shapes``
    over ``serving_lengths``, case names prefixed by ``label``)."""
    from tinychatengine_tpu_torch.ops import attention as att
    dev = torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    S, B = 2048, len(serving_lengths)
    lengths = torch.tensor(serving_lengths, dtype=torch.int32, device=dev)
    for L, d, hq, hkv, p, windows in shapes:
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
            kept = [min(n, window or n) for n in serving_lengths]
            kv_bytes = 2 * hkv * sum(kept) * d * 2
            io_bytes = 2 * B * hq * d * 2 + 4 * B
            ops = 4.0 * hq * sum(kept) * d
            col = torch.arange(S, device=dev)
            lo = (lengths - window).clamp(min=0) if window else 0 * lengths
            mask = ((col[None] < lengths[:, None]) & (col[None] >= lo[:, None])
                    )[:, None, None, :]
            tag = (f"{label}B={B} Hq={hq} Hkv={hkv} D={d} ragged"
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
                    extra = 4 * sum(-(-n // p) for n in serving_lengths)
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


# phase 3e: Mellum2-12B-A2.5B's expert layer (64 experts, top-8, E 2304, F
# 896 stored at K 1024) at a decode tick of 32 slots and a 512-row chunk;
# no row is routed to expert MOE_EMPTY
MOE_LAYERS, MOE_EXPERTS, MOE_TOPK = 28, 64, 8
MOE_E, MOE_F, MOE_FP = 2304, 896, 1024
MOE_ROWS = (32, 512)
MOE_EMPTY = 17
# the grouped kernel must run within this many times its bound (it ran at
# 1.9-2.9x on H100 80GB HBM3 at 700 W)
MOE_BOUND_X = 4.0


def check_expert_kernels(gen) -> list:
    """Phase 3e: the five kernels of the expert layer (``ops/int4_moe.py``)
    against their plain versions on the card at Mellum's widths, for rows
    x 8 pairs at each of ``MOE_ROWS``, expert ``MOE_EMPTY`` given no row:
    route (ids equal, weights within 1e-6 relative), plan (bit for bit,
    the counters too), grouped gate | up and down (``mat_err`` within
    MAT_TOL, layer 27's experts), act (within MAT_TOL) and combine (bit
    for bit). The grouped kernel is timed by graph replay cycling through
    the 28 layers' stacks (no layer's weights in L2 from the launch
    before), beside its bound over the experts the routing read
    (``bound``; the down projection at its true K 896) and bf16
    ``torch.matmul`` an expert at a time on the layer's dequantized
    weights; it must run within ``MOE_BOUND_X`` of its bound. Returns the
    rows printed."""
    from tinychatengine_tpu_torch.ops import int4_moe as mo
    from tinychatengine_tpu_torch.ops.ref import dequantize_int4
    ne, k, sets = MOE_EXPERTS, MOE_TOPK, MOE_LAYERS * MOE_EXPERTS
    stacks = {"gate_up": int4_stack(gen, MOE_E, 2 * MOE_F, n_layers=sets),
              "down": int4_stack(gen, MOE_FP, MOE_E, n_layers=sets)}
    last = (MOE_LAYERS - 1) * ne
    rows_out = []

    def fail(what):
        raise SystemExit(f"phase 3e: {what}")
    for rows in MOE_ROWS:
        logits = torch.randn((rows, ne), device="cuda", generator=gen)
        logits[:, MOE_EMPTY] = -1e4
        ids, w = mo.route(logits, k)
        pid, pw = mo.route_plain(logits, k, True)
        if not torch.equal(ids, pid) or not torch.allclose(
                w, pw, rtol=1e-6, atol=0):
            fail(f"route at {rows} rows differs from route_plain")
        t = mo.tile_rows(rows * k, ne)
        got_n = torch.zeros(2, dtype=torch.int64, device="cuda")
        want_n = torch.zeros(2, dtype=torch.int64, device="cuda")
        got = mo.plan(ids, ne, t, got_n)
        want = mo.plan_plain(ids, ne, t, want_n)
        if not all(torch.equal(a, b) for a, b in zip(got, want)) \
                or not torch.equal(got_n, want_n):
            fail(f"plan at {rows} rows differs from plan_plain")
        src, slot_of, offsets, tiles = got
        if int(offsets[MOE_EMPTY]) != int(offsets[MOE_EMPTY + 1]):
            fail(f"expert {MOE_EMPTY} was given rows")
        read, pairs = (int(v) for v in got_n)
        x = (torch.randn((rows, MOE_E), device="cuda", generator=gen)
             ).to(torch.bfloat16)
        xs = x.index_select(0, src)
        ins = {}

        def grouped(name, inp, e0):
            pk, sc = stacks[name]
            return mo.grouped_int4_matmul(inp, pk, sc, 128, e0, offsets,
                                          tiles, ne, t)
        errs = {}
        ins["gate_up"] = xs
        gu = grouped("gate_up", xs, last)
        errs["gate_up"] = mat_err(gu, mo.grouped_int4_matmul_plain(
            xs, *stacks["gate_up"], 128, last, offsets, ne))
        act = mo.expert_act(gu, MOE_FP)
        errs["act"] = mat_err(act, mo.expert_act_plain(gu, MOE_FP))
        ins["down"] = act
        yd = grouped("down", act, last)
        errs["down"] = mat_err(yd, mo.grouped_int4_matmul_plain(
            act, *stacks["down"], 128, last, offsets, ne))
        if not torch.equal(mo.combine(yd, slot_of, w, x),
                           mo.combine_plain(yd, slot_of, w, x)):
            fail(f"combine at {rows} rows differs from combine_plain")
        off = offsets.tolist()
        for name, kk, n in (("gate_up", MOE_E, 2 * MOE_F),
                            ("down", MOE_F, MOE_E)):
            inp = ins[name]
            pk, sc = stacks[name]
            step = itertools.count()

            def run():
                return grouped(name, inp, (next(step) % MOE_LAYERS) * ne)
            ms = graph_ms(run, 4 * MOE_LAYERS)
            eager_ms = time_ms(run, 4 * MOE_LAYERS)
            plain_ms = time_ms(lambda: mo.grouped_int4_matmul_plain(
                inp, pk, sc, 128, last, offsets, ne), 2, warmup=1)
            wd = [dequantize_int4(pk[last + e], sc[last + e], 128)
                  for e in range(ne)]

            def lib():
                for e in range(ne):
                    if off[e + 1] > off[e]:
                        torch.matmul(inp[off[e]:off[e + 1]], wd[e])
            lib_ms = time_ms(lib, 8)
            del wd
            wbytes = kk * n / 2 + (kk // 128) * n * 2
            bms, by = bound(read * wbytes + pairs * (kk + n) * 2,
                            2.0 * pairs * kk * n, BF16_FLOP_S)
            row = dict(kernel="int4_moe", case=f"{name} rows={rows}",
                       pairs=pairs, experts_read=read, tile_rows=t,
                       max_abs_err=errs[name][0], err_share=errs[name][1],
                       act_err_share=errs["act"][1], ms=ms,
                       eager_ms=eager_ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bms, bound_by=by,
                       roofline_pct=100.0 * bms / ms)
            log(json.dumps(row))
            rows_out.append(row)
            if not max(errs[name][1], errs["act"][1]) <= 1.0:
                fail(f"{name} at {rows} rows: error share "
                     f"{errs[name][1]:.3f}, act {errs['act'][1]:.3f}")
            if ms > MOE_BOUND_X * bms:
                fail(f"{name} at {rows} rows ran {ms / bms:.2f}x its bound")
    del stacks
    torch.cuda.empty_cache()
    return rows_out


def mellum_tick(model="mellum2_12b_a2.5b", dev="cuda", slots=8,
                n_predict=48, max_len=2048) -> dict:
    """Phase 3e's served tick: ``model`` (a registry name or a
    ``ModelConfig``; mellum2_12b_a2.5b W4A16 at full width and depth,
    random int4 weights from a seed) through ``ServingEngine`` (dense,
    ``slots`` slots, phase 5's load); once every request is admitted, the
    launch counters, the tick counts and the expert counters are zeroed
    and one ``step()`` runs: every slot's row routes k pairs a layer a
    tick, and on the card each tick must launch each expert kernel once a
    layer (``int4_moe`` twice), ``flash_decode`` once a layer,
    ``int4_matmul`` for qkv and wo a layer and the head, nothing else and
    no plain version. Returns the step's counts. The arguments shrink the
    run for a rehearsal on the CPU (tests)."""
    from tinychatengine_tpu_torch.core.config import (GenerationConfig,
                                                      QuantConfig)
    from tinychatengine_tpu_torch.models import llama, moe
    from tinychatengine_tpu_torch.ops import _build
    from tinychatengine_tpu_torch.runtime.serving import ServingEngine
    cfg = model_config(model)
    qcfg = QuantConfig(scheme="w4a16", group_size=128)
    params = llama.init_random_params(cfg, qcfg, seed=0, max_pos=max_len,
                                      fast=True, device=dev)
    srv = ServingEngine(params, cfg, qcfg, slots=slots, max_len=max_len,
                        gcfg=GenerationConfig(temp=0.0, n_predict=n_predict,
                                              seed=0),
                        admission_chunk=512, tick_batch=16, device=dev)
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    serving_load(srv, cfg, slots, n_predict, seed=1)
    srv.run()  # captures the ticks the counted step replays
    reqs = serving_load(srv, cfg, slots, n_predict)
    while srv.queue or srv._pending is not None:
        srv.step()
    with plain_calls() as plain:
        sync()
        for key in srv.tick_stats:
            srv.tick_stats[key] = 0
        _build.reset_launches()
        stats0 = moe.stats(dev).clone()
        t0 = time.perf_counter()
        srv.step()
        sync()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        counted = (moe.stats(dev) - stats0).tolist()
        ticks = srv.tick_stats["burst_ticks"] + srv.tick_stats["single_ticks"]
    srv.run()
    check_lengths(reqs, n_predict, "mellum serving")
    nl = cfg.num_layers
    ran = {n: v for n, v in launches.items() if v}
    out = dict(ticks=ticks, tick_ms=1e3 * wall / max(ticks, 1),
               launches=launches, plain_calls=dict(plain),
               expert_sets=counted[0], expert_pairs=counted[1])
    log("mellum served tick:", json.dumps(dict(out, launches=ran)))
    if not ticks or counted[1] != nl * slots * cfg.experts_per_tok * ticks \
            or not 0 < counted[0] <= nl * cfg.num_experts * ticks:
        raise SystemExit(f"mellum tick: expert counters {counted} over "
                         f"{ticks} ticks")
    if dev == "cuda":  # the CPU rehearsal runs the plain versions
        want = {"int4_moe": 2 * nl, "moe_route": nl, "moe_plan": nl,
                "moe_act": nl, "moe_combine": nl, "flash_decode": nl,
                "int4_matmul": 2 * nl + 1}
        if ran != {n: v * ticks for n, v in want.items()}:
            raise SystemExit(f"mellum tick: launches {ran} over {ticks} "
                             f"ticks, want {want} a tick")
        if any(plain.values()):
            raise SystemExit(f"mellum tick: plain versions ran: {plain}")
    del srv, params
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def check_experts(gen) -> dict:
    """Phase 3e: ``check_expert_kernels``, then ``mellum_tick``."""
    return dict(kernels=check_expert_kernels(gen), tick=mellum_tick())


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
    from tinychatengine_tpu_torch.ops import int4_moe as mo
    from tinychatengine_tpu_torch.ops import mlp_fused as mf
    names = [(att, "flash_decode_plain"), (att, "flash_prefill_plain"),
             (att, "flash_decode_paged_plain"), (att, "int8_decode_plain"),
             (im, "int4_matmul_plain"), (im, "int4_matmul_a8_plain"),
             (im, "int4_matmul_fused_plain"), (im, "int4_matmul_kouter_plain"),
             (im, "int4_matmul_glu_plain"), (mf, "mlp_fused_plain"),
             (i3, "int3_matmul_plain"), (mo, "route_plain"),
             (mo, "plan_plain"), (mo, "grouped_int4_matmul_plain"),
             (mo, "expert_act_plain"), (mo, "combine_plain")]
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


def random_model(cfg, dev, max_pos=None, **llama_init):
    """The random full-width model of a phase, made on ``dev`` from a
    seeded generator: llama W4A8 or GPTBigCode W4A16 (packed int4) or opt
    W8A8 (int8). llama_init: more of ``llama.init_random_params``'s
    options (``centered``, ``std``). Returns (params, qcfg)."""
    from tinychatengine_tpu_torch.core.config import QuantConfig
    from tinychatengine_tpu_torch.models import gptbigcode, llama, opt
    t0 = time.perf_counter()
    if cfg.family == "llama":
        qcfg = QuantConfig(scheme="w4a8", group_size=128)
        params = llama.init_random_params(cfg, qcfg, seed=0, max_pos=max_pos,
                                          fast=True, device=dev, **llama_init)
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
EAGER_RATE_TOKENS = 64  # phase 4's eager decode rate: tokens a trial


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
    from tinychatengine_tpu_torch.utils import tracing

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    fused, kouter = im.FUSED_DECODE, bool(im.DECODE_KOUTER)
    forward = forward_for_family(cfg.family)
    params, qcfg = model_params or random_model(cfg, dev)
    int8_kv = qcfg.kv_cache_dtype == "int8" and cfg.family != "opt"
    label = (f"{cfg.name} {qcfg.scheme}" + (" fused" if fused else "")
             + (" K-outer" if kouter else "")
             + (" int8 KV" if int8_kv else ""))
    t_made = time.perf_counter_ns()
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
    if eager_rate:  # over EAGER_RATE_TOKENS (the loop runs ~25 tok/s)
        eager.generate_device(prompt, gcfg, n_tokens=2)
        eager_tok_s = decode_rate(eager, prompt, gcfg, EAGER_RATE_TOKENS,
                                  sync)[0]
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
                       graph_capture_s=1e-9 * sum(
                           s.end - s.start for s in tracing.snapshot(t_made)
                           if s.name == "graph.capture"))
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
    if cfg.family == "gptbigcode":  # phase 16's input_embeds check
        out["embeds_prefill_equal"] = embeds_prefill_equal(params, cfg, dev)
    log(f"{cfg.name} first decode step, fused vs unfused: max |diff| / "
        f"max |logit| = {out['first_step']['rel_diff']:.3e} (tol "
        f"{FUSED_STEP_TOL}), same argmax {out['first_step']['same_argmax']}")
    if not out["first_step"]["rel_diff"] <= FUSED_STEP_TOL:
        raise SystemExit(f"{cfg.name}: fused decode disagrees with unfused")
    del params
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def embeds_prefill_equal(params, cfg, dev, n: int = 16) -> bool:
    """An OPT or GPTBigCode prefill of ``n`` seeded ids into a fresh cache
    from the ids and from ``input_embeds`` (the rows the ids give, with
    their positions): whether the logits, and the cache, are equal bit for
    bit."""
    from tinychatengine_tpu_torch.generation import kv_cache as kvc
    from tinychatengine_tpu_torch.generation.engine import forward_for_family
    from tinychatengine_tpu_torch.models.opt import POS_OFFSET
    ids = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, n)), device=dev)
    pos = torch.arange(n, device=dev)
    if cfg.family == "opt":
        embeds = (params.embed_tokens[ids].float()
                  + params.embed_positions[pos + POS_OFFSET].float())
    else:
        embeds = params.wte[ids] + params.wpe[pos]
    forward = forward_for_family(cfg.family)
    outs = []
    with torch.inference_mode():
        for kw in ({}, {"input_embeds": embeds}):
            cache = kvc.init_cache(cfg.num_layers, 1, n, cfg.num_kv_heads,
                                   cfg.head_dim, device=dev)
            logits, cache = forward(params, cfg, ids, cache, 0,
                                    full_logits=True, **kw)
            outs.append((logits, cache.k, cache.v))
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    log(f"{cfg.name} prefill of {n} ids from input_embeds equal to the ids' "
        f"bit for bit: {same}")
    return same


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
    (first token - submit), decode ticks, the tick mix, kernel launches
    (and the tile route's by token-tile width), and the plain-version
    calls of both (the warm-up captures the ticks
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
        tile = dict(_build.TILE_LAUNCHES)
    ttft = sorted(r.first_token_t - r.submit_t for r in reqs)
    total = sum(len(r.output_ids) for r in reqs)
    ticks = srv.tick_stats["burst_ticks"] + srv.tick_stats["single_ticks"]
    m = dict(tok_s=total / wall, wall_s=wall, tokens=total,
             ttft_p50_s=ttft[len(ttft) // 2],
             ttft_p95_s=ttft[int(len(ttft) * 0.95)],
             decode_ticks=ticks, tick_stats=dict(srv.tick_stats),
             launches=launches, tile_launches_by_width=tile,
             plain_calls=dict(plain))
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
    log("greedy tokens part from the plain run:", json.dumps(row))
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
    served, usage = http_image_tokens(srv, cparams, ccfg, img_a, n_predict)
    m["http_image_eq_serving"] = served == got and \
        usage["prompt_tokens"] == ids.shape[1]
    log(f"vila_7b image_url chat over HTTP: {len(served)} tokens, "
        f"{usage}; equal to the ServingEngine request's: "
        f"{m['http_image_eq_serving']}")
    if not m["http_image_eq_serving"]:
        raise SystemExit("vila_7b: the image_url chat request over HTTP "
                         "parts from the ServingEngine request")
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


# ---- phase 14: the text front end and the REST server ----------------------

# scripts/bench_serving.py main_http's three sampling variants, in turn
HTTP_VARIANTS = (
    {},
    {"temperature": 1.0, "top_p": 0.9, "seed": 11},
    {"temperature": 0.7, "top_k": 40, "seed": 12, "repetition_penalty": 1.0,
     "repeat_last_n": 1})
# phase 14's embeddings against an eager forward of the unpadded ids,
# pooled and normalised in f32 (unit vectors)
EMB_CARD_TOL = 1e-3
HTTP_TIMEOUT = 600.0


def http_image_tokens(srv, cparams, ccfg, image, n_predict: int):
    """Phase 13's prompt as an OpenAI chat request, the image a PNG data
    URL of ``image`` between its two text parts, to an InferenceServer
    over ``srv`` with the vision tower (the template passes the text
    through): (the served tokens, the usage)."""
    import base64
    import io

    from PIL import Image

    from tinychatengine_tpu_torch.generation.chat_templates import \
        ChatTemplate
    from tinychatengine_tpu_torch.runtime.server import InferenceServer
    from tinychatengine_tpu_torch.tokenizers.byte_fallback import \
        ByteTokenizer
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="PNG")
    url = "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()
    server = InferenceServer(srv, ByteTokenizer(), model_name="vila_7b",
                             template=ChatTemplate("{input}", "{input}"),
                             request_timeout=HTTP_TIMEOUT,
                             clip_params=cparams, clip_cfg=ccfg)
    server.start(port=0)
    try:
        out = http_ok(server.port, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": [
                {"type": "text", "text": "Image: "},
                {"type": "image_url", "image_url": {"url": url}},
                {"type": "text", "text": " What is in this image?\n"}]}],
            "max_tokens": n_predict, "ignore_eos": True})
    finally:
        server.close()
    return list(srv.done[-1].output_ids), out["usage"]


def llama3_tokenizer(path: Path, n_ranks: int = 128000, seed: int = 0):
    """Writes a tiktoken-format ``tokenizer.model`` of ``n_ranks`` distinct
    byte strings into the directory ``path``: the 256 bytes, then the
    65536 byte pairs in an order drawn from ``default_rng(seed)``, then
    distinct random byte triples (Llama-3's rank count; the 256 specials
    above them are named by ``Llama3BPE.load``). Returns the file."""
    import base64
    rng = np.random.default_rng(seed)
    toks = [bytes([b]) for b in range(256)]
    toks += [int(p).to_bytes(2, "big") for p in rng.permutation(1 << 16)]
    toks += [int(t).to_bytes(3, "big") for t in rng.choice(
        1 << 24, size=max(n_ranks - len(toks), 0), replace=False)]
    toks = toks[:n_ranks]
    f = path / "tokenizer.model"
    f.write_text("\n".join(f"{base64.b64encode(t).decode()} {r}"
                           for r, t in enumerate(toks)) + "\n")
    return f


def http_call(port: int, path: str, body=None, timeout=HTTP_TIMEOUT):
    """One request to a local server: (status, parsed JSON or text)."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    if body is None:
        conn.request("GET", path)
    else:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read().decode()
    conn.close()
    ctype = resp.getheader("Content-Type") or ""
    return resp.status, (json.loads(data) if "json" in ctype else data)


def http_ok(port: int, path: str, body=None):
    """``http_call`` that fails the run on any status but 200."""
    st, out = http_call(port, path, body)
    if st != 200:
        raise SystemExit(f"{path}: HTTP {st}: {str(out)[:400]}")
    return out


def http_stream(port: int, path: str, body) -> list:
    """A stream=true request's SSE payloads (which must end with [DONE])."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=HTTP_TIMEOUT)
    conn.request("POST", path, json.dumps({**body, "stream": True}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read().decode()
    conn.close()
    if resp.status != 200 or not raw.rstrip().endswith("data: [DONE]"):
        raise SystemExit(f"{path} stream: HTTP {resp.status}: {raw[-300:]}")
    return [json.loads(line[len("data: "):]) for line in raw.split("\n\n")
            if line.startswith("data: ") and line != "data: [DONE]"]


def http_load(server, bodies) -> tuple:
    """``bodies`` posted to /v1/completions by as many concurrent clients,
    as scripts/bench_serving.py main_http posts them; the scheduler admits
    nothing until every request is queued (a scheduler command waits for
    them), so the run's schedule is a function of the order they arrived
    in. Returns (responses, wall seconds); any failure fails the run."""
    import threading
    n = len(bodies)

    def all_queued():
        deadline = time.monotonic() + 60.0
        while server._intake.qsize() < n and time.monotonic() < deadline:
            time.sleep(0.0005)
    outs, errors = [None] * n, []

    def client(i):
        try:
            outs[i] = http_call(server.port, "/v1/completions", bodies[i])
        except Exception as exc:
            errors.append((i, repr(exc)))
    gate = threading.Thread(target=server.run_on_scheduler,
                            args=(all_queued,))
    t0 = time.perf_counter()
    gate.start()
    time.sleep(0.01)  # the wait is the scheduler's next command
    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads + [gate]:
        t.join(timeout=HTTP_TIMEOUT)
    wall = time.perf_counter() - t0
    bad = [(i, o) for i, o in enumerate(outs) if o is None or o[0] != 200]
    if errors or bad:
        raise SystemExit(f"HTTP load: errors {errors[:3]}, non-200 "
                         f"{[(i, str(o)[:200]) for i, o in bad[:3]]}")
    return [o[1] for o in outs], wall


def http_bodies(cfg, n: int, n_predict: int, seed: int = 0) -> list:
    """main_http's pre-tokenized prompts (16-320 tokens from
    ``default_rng(seed)``) with its sampling variants in turn."""
    rng = np.random.default_rng(seed)
    bodies = []
    for i in range(n):
        ids = rng.integers(100, cfg.vocab_size - 100,
                           int(rng.integers(16, 320)))
        bodies.append({"prompt": [int(t) for t in ids],
                       "max_tokens": n_predict, "ignore_eos": True,
                       **HTTP_VARIANTS[i % len(HTTP_VARIANTS)]})
    return bodies


def metrics_of(port: int) -> dict:
    """/metrics as {sample name: value}."""
    text = http_ok(port, "/metrics")
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, val = line.rsplit(" ", 1)
            out[name] = float(val)
    return out


def replay_in_process(srv, reqs, alone: bool = False) -> list:
    """The server's requests ``reqs`` submitted straight to its engine in
    the order it received them (same prompts, budgets, stop ids, sampling
    and logprobs), all queued before the first step, or each ``alone``
    (run to its end before the next): the requests as the server should
    have answered them."""
    mine = []
    for r in sorted(reqs, key=lambda r: r.request_id):
        mine.append(srv.submit(r.prompt_ids, n_predict=r.n_predict,
                               stop_token_ids=r.stop_token_ids, gcfg=r.gcfg,
                               logprobs=r.logprobs))
        if alone:
            srv.run()
    srv.run()
    return mine


def pooled_embedding(params, cfg, ids, dev) -> torch.Tensor:
    """An eager ``llama.forward(return_hidden=True)`` over exactly ``ids``
    (no bucket), mean-pooled and L2-normalised in f32."""
    from tinychatengine_tpu_torch.generation import kv_cache as kvc
    from tinychatengine_tpu_torch.models import llama
    cache = kvc.init_cache(cfg.num_layers, 1, len(ids), cfg.num_kv_heads,
                           cfg.head_dim, device=dev)
    with torch.inference_mode():
        hidden, _ = llama.forward(params, cfg, torch.as_tensor(
            [ids], device=dev), cache, 0, return_hidden=True)
    pooled = hidden[0].float().mean(dim=0)
    return (pooled / pooled.norm()).cpu()


def http_serving(model, model_params, dev="cuda", n_requests=24,
                 n_predict=64, max_len=2048, n_ranks=128000):
    """Phase 14 on phase 4's llama3_8b W4A8 weights (``model_params``):
    a synthetic Llama-3 ``tokenizer.model`` (``llama3_tokenizer``) loaded
    by ``tools.checkpoint.load_tokenizer``; the REST server
    (``InferenceServer`` over phase 5's ServingEngine: 8 slots, max_len
    2048, admission chunk 512, tick batch 16) dense, then paged, each
    under main_http's load (``n_requests`` concurrent clients, 16-320
    token pre-tokenized prompts, ``n_predict`` tokens with ``ignore_eos``)
    after a 2-request warm-up: HTTP tok/s, ``engine.step()`` seconds
    against the wall, the tick mix, TTFT; the served tokens equal to the
    same requests submitted in-process (all of them, the greedy third
    required), ``/metrics``' token count equal to the usage fields, the
    launches (``int4_matmul_a8``, ``int4_matmul`` and ``flash_prefill`` in
    both runs, the mode's decode kernel only) and 0 plain calls. On the
    dense server also: a streamed chat completion equal to the
    non-streamed one, a stop string from a greedy text truncating there
    and freeing the slot, four ``logprobs=5`` requests equal to the
    engine's, and /v1/embeddings within ``EMB_CARD_TOL`` of
    ``pooled_embedding``. Then chat.py's ``repl`` (two greedy turns of 32
    tokens from a StringIO) against ``Engine.generate``, and serve.py as a
    subprocess on bytellama_5m against ``Engine.generate``. The arguments
    shrink the run for a rehearsal on the CPU (tests)."""
    import tempfile

    from tinychatengine_tpu_torch.core.config import GenerationConfig
    from tinychatengine_tpu_torch.runtime.server import InferenceServer
    from tinychatengine_tpu_torch.runtime.serving import ServingEngine
    from tinychatengine_tpu_torch.tools.checkpoint import load_tokenizer
    cfg, (params, qcfg) = model_config(model), model_params
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        llama3_tokenizer(Path(tmp), n_ranks)
        tok = load_tokenizer(tmp, cfg)
        out["tokenizer_s"] = time.perf_counter() - t0
    specials = {n: tok.special.get(n) for n in (
        "<|begin_of_text|>", "<|end_of_text|>", "<|eot_id|>")}
    log(f"phase 14 tokenizer: {type(tok).__name__}, {tok.vocab_size} ranks, "
        f"{len(tok.pair_ranks)} pair rules, specials {json.dumps(specials)}, "
        f"{out['tokenizer_s']:.1f} s to write and load")
    if type(tok).__name__ != "Llama3BPE" or tok.vocab_size != n_ranks or \
            list(specials.values()) != [n_ranks, n_ranks + 1, n_ranks + 9]:
        raise SystemExit("phase 14: the synthetic tokenizer did not load as "
                         "Llama-3's")
    gcfg = GenerationConfig(temp=0.0, n_predict=n_predict, repeat_penalty=1.1,
                            repeat_last_n=64, seed=0)
    bodies = http_bodies(cfg, n_requests, n_predict)
    warm = http_bodies(cfg, 2, n_predict, seed=1)
    for mode in ("dense", "paged"):
        srv = ServingEngine(params, cfg, qcfg, slots=8, max_len=max_len,
                            gcfg=gcfg, admission_chunk=512, tick_batch=16,
                            paged=mode == "paged", device=dev)
        server = InferenceServer(srv, tok, model_name=cfg.name,
                                 request_timeout=HTTP_TIMEOUT)
        server.start(port=0)
        try:
            m, checks = _http_run(server, srv, bodies, warm, sync, dev,
                                  extra=mode == "dense")
        finally:
            server.close()
        same = replay_in_process(srv, m.pop("reqs"))
        greedy = [(a.output_ids, b.output_ids) for a, b in
                  zip(sorted(checks.pop("load_reqs"),
                             key=lambda r: r.request_id), same)
                  if a.gcfg is None]
        m["greedy_eq_in_process"] = [sum(a == b for a, b in greedy),
                                     len(greedy)]
        m["all_eq_in_process"] = [
            sum(a.output_ids == b.output_ids for a, b in zip(
                sorted(checks.pop("all_reqs"), key=lambda r: r.request_id),
                same)), len(same)]
        if "lp" in checks:
            mine = replay_in_process(srv, checks.pop("lp_reqs"), alone=True)
            served = checks.pop("lp")
            m["logprobs_eq"] = all(
                s["token_logprobs"] == r.output_logprobs[:len(
                    s["token_logprobs"])] and s["token_logprobs"]
                for s, r in zip(served, mine))
        if "emb" in checks:
            errs = [float((torch.tensor(e) - pooled_embedding(
                params, cfg, ids, dev)).abs().max())
                for e, ids in checks.pop("emb")]
            m["embedding_err"] = max(errs)
        m.update(checks)
        log(f"phase 14 {mode}:", json.dumps({k: v for k, v in m.items()
                                              if k not in ("launches",)}))
        log(f"phase 14 {mode} launches:", json.dumps(m["launches"]))
        bad = [k for k in ("sse_eq", "stop_truncates", "stop_frees_slot",
                           "logprobs_eq", "metrics_tokens_eq")
               if k in m and not m[k]]
        if m["greedy_eq_in_process"][0] != len(greedy) or bad:
            raise SystemExit(f"phase 14 {mode}: served tokens part from the "
                             f"in-process engine's "
                             f"{m['greedy_eq_in_process']} or failed {bad}")
        if m.get("embedding_err", 0.0) > EMB_CARD_TOL:
            raise SystemExit(f"phase 14: embeddings {m['embedding_err']} "
                             f"from the eager forward (tol {EMB_CARD_TOL})")
        if dev == "cuda":
            ran, idle = (("flash_decode_paged", "flash_decode")
                         if mode == "paged"
                         else ("flash_decode", "flash_decode_paged"))
            launches = m["launches"]
            if any(m["plain_calls"].values()) or launches[idle] or not all(
                    launches[k] > 0 for k in ("int4_matmul_a8", "int4_matmul",
                                              "flash_prefill", ran)):
                raise SystemExit(f"phase 14 {mode}: launches {launches}, "
                                 f"plain calls {m['plain_calls']}")
        out[mode] = m
        del srv, server
        if dev == "cuda":
            torch.cuda.empty_cache()
    out["chat"] = chat_repl_check(params, cfg, qcfg, tok, dev, max_len)
    out["serve_cli"] = serve_cli_check(dev)
    return out


def _http_run(server, srv, bodies, warm, sync, dev, extra: bool):
    """One server's warm-up and timed load (``http_load``), its metrics
    and, with ``extra``, the dense server's further checks. Returns
    (metrics, checks)."""
    from tinychatengine_tpu_torch.ops import _build
    port = server.port
    checks = {}
    acc = [0.0, 0]
    step = srv.step

    def timed_step():
        t = time.perf_counter()
        step()
        acc[0] += time.perf_counter() - t
        acc[1] += 1
    with plain_calls() as plain:
        outs_w, _ = http_load(server, warm)
        for k in srv.tick_stats:
            srv.tick_stats[k] = 0
        sync()
        _build.reset_launches()
        n_done = len(srv.done)
        srv.step = timed_step
        try:
            outs, wall = http_load(server, bodies)
        finally:
            del srv.step
        sync()
        launches = dict(_build.LAUNCHES)
    reqs = srv.done[n_done:]
    usage = sum(o["usage"]["completion_tokens"] for o in outs + outs_w)
    met = metrics_of(port)
    ttft = sorted(r.first_token_t - r.submit_t for r in reqs)
    total = sum(o["usage"]["completion_tokens"] for o in outs)
    m = dict(http_tok_s=total / wall, wall_s=wall, tokens=total,
             step_s=acc[0], step_calls=acc[1], step_share=acc[0] / wall,
             ttft_p50_s=ttft[len(ttft) // 2],
             ttft_p95_s=ttft[int(len(ttft) * 0.95)],
             metrics_ttft_mean_s=met["tce_ttft_seconds_sum"]
             / met["tce_ttft_seconds_count"],
             tick_stats=dict(srv.tick_stats), launches=launches,
             plain_calls=dict(plain),
             metrics_tokens_eq=met["tce_generation_tokens_total"] == usage,
             reqs=list(reqs))
    checks["load_reqs"] = checks["all_reqs"] = list(reqs)
    if dev == "cuda":
        m["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if not extra:
        return m, checks
    tok = server.tok
    # SSE: a chat completion streamed equals the same one not streamed
    chat = {"messages": [{"role": "user", "content": "Tell me a story."}],
            "max_tokens": 32}
    want = http_ok(port, "/v1/chat/completions", chat)
    events = http_stream(port, "/v1/chat/completions", chat)
    streamed = "".join(e["choices"][0]["delta"].get("content", "")
                       for e in events[1:])
    checks["sse_eq"] = streamed == want["choices"][0]["message"]["content"]
    checks["sse_chunks"] = len(events)
    # a stop string from a greedy request's own text, posted alone
    body = {**bodies[0], "max_tokens": 64}
    full = http_ok(port, "/v1/completions", body)["choices"][0]["text"]
    printable = [c for c in full if c.isascii() and c.isprintable()
                 and c != " "]
    if len(set(full)) < 2 or not printable:
        raise SystemExit(f"phase 14: no stop character in {full!r}")
    stop = printable[len(printable) // 2]
    cut = http_ok(port, "/v1/completions", {**body, "stop": stop})
    c = cut["choices"][0]
    checks["stop"] = stop
    checks["stop_truncates"] = (c["text"] == full[:full.index(stop)]
                                and c["finish_reason"] == "stop")
    deadline = time.monotonic() + 30.0
    while srv.n_active and time.monotonic() < deadline:
        time.sleep(0.01)
    checks["stop_frees_slot"] = srv.n_active == 0
    # logprobs=5 on four greedy requests, one at a time
    greedy = [b for b in bodies if not b.keys() - {"prompt", "max_tokens",
                                                    "ignore_eos"}][:4]
    n_lp = len(srv.done)
    checks["lp"] = [http_ok(port, "/v1/completions", {
        **b, "max_tokens": 16, "logprobs": 5})["choices"][0]["logprobs"]
        for b in greedy]
    checks["lp_reqs"] = srv.done[n_lp:]
    # /v1/embeddings on two inputs
    texts = ["The quick brown fox", "jumps over the lazy dog"]
    emb = http_ok(port, "/v1/embeddings", {"input": texts})
    checks["emb"] = [(d["embedding"], tok.encode(t, bos=True))
                     for d, t in zip(emb["data"], texts)]
    return m, checks


def chat_repl_check(params, cfg, qcfg, tok, dev, max_len: int,
                    n_predict: int = 32) -> dict:
    """chat.py's ``repl`` on phase 14's model and tokenizer: two greedy
    turns of ``n_predict`` tokens from a StringIO; each turn's ids are the
    template-rendered text and its tokens ``Engine.generate``'s on them
    (the second turn continuing the first's cache)."""
    import io

    from tinychatengine_tpu_torch import chat
    from tinychatengine_tpu_torch.core.config import GenerationConfig
    from tinychatengine_tpu_torch.generation.engine import Engine
    g = GenerationConfig(temp=0.0, n_predict=n_predict, repeat_penalty=1.0,
                         repeat_last_n=1)
    eng = Engine(params, cfg, qcfg, batch=1, max_len=max_len, device=dev)
    turns = ["Hello! Who are you?", "Tell me more."]
    seen = []
    generate = eng.generate

    def spy(ids, gc, **kw):
        res = generate(ids, gc, **kw)
        seen.append((np.asarray(ids).tolist(), kw, res.tokens[0]))
        return res
    eng.generate = spy
    stdin, stdout, stderr = sys.stdin, io.StringIO(), io.StringIO()
    sys.stdin = io.StringIO("".join(t + "\n" for t in turns))
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(stdout), \
                contextlib.redirect_stderr(stderr):
            chat.repl(eng, tok, cfg, g)
    finally:
        sys.stdin = stdin
        del eng.generate
    wall = time.perf_counter() - t0
    tmpl = chat.template_for(cfg.name)
    cache, start, ok = eng.new_cache(), 0, len(seen) == len(turns)
    for i, (text, (ids, kw, toks)) in enumerate(zip(turns, seen)):
        wrap = tmpl.first if i == 0 else tmpl.next
        want_ids = tok.encode(wrap.replace("{image}", "").format(input=text),
                              bos=i == 0)
        res = eng.generate(np.asarray([want_ids], np.int32), g,
                           stop_token_ids=kw["stop_token_ids"], cache=cache,
                           start=start)
        ok = ok and ids == [want_ids] and kw["start"] == start and \
            res.tokens[0] == toks
        cache, start = res.cache, start + len(want_ids) + len(toks)
    m = dict(turns=len(seen), tokens=[len(s[2]) for s in seen],
             eq_engine=ok, wall_s=wall,
             printed=stdout.getvalue().count("ASSISTANT: "))
    log("phase 14 chat.py repl:", json.dumps(m))
    if not ok or m["printed"] != len(turns):
        raise SystemExit("phase 14: chat.py's repl parts from "
                         "Engine.generate")
    del eng
    return m


def serve_cli_check(dev) -> dict:
    """``python3 -m tinychatengine_tpu_torch.serve --model bytellama_5m
    --checkpoint assets/bytellama_5m --port 0`` as a subprocess (on the
    card; ``--device cpu`` in a rehearsal): the bound port read from its
    banner, one greedy completion equal to ``Engine.generate`` in-process
    on the same checkpoint, then SIGINT, which must end it with exit code
    0 and no traceback."""
    import dataclasses as dc
    import signal
    import threading

    from tinychatengine_tpu_torch.core.config import (GenerationConfig,
                                                      get_model_config)
    from tinychatengine_tpu_torch.generation.engine import Engine
    from tinychatengine_tpu_torch.tools.checkpoint import (load_checkpoint,
                                                           load_tokenizer)
    ckpt = ROOT / "assets" / "bytellama_5m"
    cmd = [sys.executable, "-m", "tinychatengine_tpu_torch.serve", "--model",
           "bytellama_5m", "--checkpoint", str(ckpt), "--port", "0"]
    if dev != "cuda":
        cmd += ["--device", dev]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    lines, banner = [], threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving ") and not banner.is_set():
                lines.insert(0, line)  # the banner, first
                banner.set()
    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        if not banner.wait(180):
            raise SystemExit(f"serve.py printed no banner: {lines} "
                             f"{proc.stderr.read() if proc.poll() else ''}")
        up_s = time.perf_counter() - t0
        port = int(re.search(r":(\d+) \(", lines[0]).group(1))
        body = {"prompt": "def fibonacci(n):", "max_tokens": 32,
                "temperature": 0.0}
        got = http_ok(port, "/v1/completions", body)
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            _, err = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
    cfg = get_model_config("bytellama_5m")
    params, qcfg = load_checkpoint(str(ckpt), cfg, device=dev)
    tok = load_tokenizer(str(ckpt), cfg)
    g = dc.replace(GenerationConfig(), temp=0.0, n_predict=32)
    eng = Engine(params, cfg, qcfg, batch=1, device=dev)
    toks = eng.generate(np.asarray([tok.encode(body["prompt"], bos=True)],
                                   np.int32), g,
                        stop_token_ids=[tok.eos_id]).tokens[0]
    want = tok.decode([t for t in toks if t != tok.eos_id])
    m = dict(banner=lines[0].strip(), up_s=up_s, tokens=len(toks),
             eq_engine=got["choices"][0]["text"] == want,
             exit_code=proc.returncode, traceback="Traceback" in err)
    log("phase 14 serve.py:", json.dumps(m))
    if not m["eq_engine"] or m["exit_code"] != 0 or m["traceback"]:
        raise SystemExit(f"phase 14: serve.py {m}; stderr {err[-2000:]}")
    return m


def hf_llama_specs(cfg) -> list:
    """(name, shape) of an HF llama state dict, in the order it is drawn
    and written: the embedding, each layer's norms and linears ([OC, IC]),
    the final norm, then a separate lm_head."""
    e, f, v = cfg.embed_dim, cfg.hidden_dim, cfg.vocab_size
    kv = cfg.num_kv_heads * cfg.head_dim
    specs = [("model.embed_tokens.weight", (v, e))]
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        specs += [(p + "input_layernorm.weight", (e,)),
                  (p + "post_attention_layernorm.weight", (e,)),
                  (p + "self_attn.q_proj.weight", (e, e)),
                  (p + "self_attn.k_proj.weight", (kv, e)),
                  (p + "self_attn.v_proj.weight", (kv, e)),
                  (p + "self_attn.o_proj.weight", (e, e)),
                  (p + "mlp.gate_proj.weight", (f, e)),
                  (p + "mlp.up_proj.weight", (f, e)),
                  (p + "mlp.down_proj.weight", (e, f))]
    return specs + [("model.norm.weight", (e,)), ("lm_head.weight", (v, e))]


def write_safetensors(path: Path, tensors: dict) -> None:
    """``tensors`` (name -> CPU tensor) as one ``*.safetensors`` file: with
    the ``safetensors`` package where it is installed, else by this writer
    (an 8-byte little-endian header length, a JSON header padded with
    spaces to 8 bytes, then each tensor's raw little-endian bytes)."""
    try:
        from safetensors.torch import save_file
    except ImportError:
        save_file = None
    if save_file is not None:
        save_file({k: v.contiguous() for k, v in tensors.items()}, str(path))
        return
    names = {torch.bfloat16: "BF16", torch.float32: "F32",
             torch.float16: "F16"}
    header, off = {}, 0
    for k, t in tensors.items():
        n = t.numel() * t.element_size()
        header[k] = {"dtype": names[t.dtype], "shape": list(t.shape),
                     "data_offsets": [off, off + n]}
        off += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    import struct
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for t in tensors.values():
            f.write(memoryview(t.contiguous().view(torch.uint8).numpy()))


def synthetic_hf_llama(cfg, root: Path, dev, seed: int = 0, keep=()):
    """Writes ``cfg``'s HF llama into ``root`` as two ``*.safetensors``
    shards of bf16 tensors drawn on ``dev`` from a seeded generator:
    linears and embeddings N(0, 0.02), norms 1 + N(0, 0.05), and AWQ's
    motif (tests/test_awq.py): in each layer AWQ_MOTIF channels whose two
    norm weights are x20 and whose rows of q/k/v and gate/up (input
    channels, the columns of HF's [OC, IC]) are x0.05. Returns the ``keep``
    tensors as the reader widens them (f32 numpy)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    specs = hf_llama_specs(cfg)
    split = next(i for i, (n, _) in enumerate(specs)
                 if n.startswith(f"model.layers.{cfg.num_layers // 2}."))
    kept, motif = {}, None
    for j, part in enumerate((specs[:split], specs[split:])):
        tensors = {}
        for name, shape in part:
            if name.endswith("input_layernorm.weight"):  # a layer's first
                motif = torch.randperm(cfg.embed_dim, generator=gen,
                                       device=dev)[:AWQ_MOTIF]
            if name.endswith("norm.weight"):
                t = 1 + 0.05 * torch.randn(shape, generator=gen, device=dev)
                if "layers." in name:
                    t[motif] *= 20.0
            else:
                t = 0.02 * torch.randn(shape, generator=gen, device=dev)
                if any(k in name for k in ("q_proj", "k_proj", "v_proj",
                                           "gate_proj", "up_proj")):
                    t[:, motif] *= 0.05
            t = t.to(torch.bfloat16).cpu()
            tensors[name] = t
            if name in keep:
                kept[name] = t.float().numpy()
        write_safetensors(root / f"model-{j + 1:05d}-of-00002.safetensors",
                          tensors)
        del tensors
    return kept


@contextlib.contextmanager
def timed_calls(module, name: str, sync):
    """Wraps ``module.name`` while open; yields a list of (args, seconds)
    per call."""
    fn, calls = getattr(module, name), []

    def timed(*a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        sync()
        calls.append((a, time.perf_counter() - t))
        return out
    setattr(module, name, timed)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def same_int4(lin, want, what: str) -> None:
    """Fails unless the int4 linear ``lin`` holds the packed bytes and
    scales of ``want`` (quantized in numpy on the host)."""
    for field in ("packed", "scales"):
        a = getattr(lin, field).cpu()
        b = getattr(want, field)
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            raise SystemExit(f"phase 15: {what} {field} differs from "
                             "numpy's quantizer on the source weights")


def rtn_import_check(params, kept, cfg, qcfg):
    """Every packed and scale array of layer 0 and of the lm_head equals
    numpy's quantizer and packer on the host (``quantize_groupwise_int4``,
    ``int4_linear_from_codes``: the bytes ``quantize_linear`` gives) on
    the source weights, byte for byte: the fused qkv and gate_up as their
    parts side by side, the lm_head padded to ``lmhead_padded``."""
    from tinychatengine_tpu_torch.models import llama
    from tinychatengine_tpu_torch.ops.linear import (fuse_linears,
                                                     int4_linear_from_codes)
    from tinychatengine_tpu_torch.quant.numerics import \
        quantize_groupwise_int4
    from concurrent.futures import ThreadPoolExecutor

    def numpy_int4(w):
        q, s = quantize_groupwise_int4(w, qcfg.group_size)
        return int4_linear_from_codes(q, s, qcfg.group_size, qcfg.scale_dtype,
                                      a8=qcfg.scheme == "w4a8")
    p = "model.layers.0."
    head = kept["lm_head.weight"]
    pad = llama.lmhead_padded(cfg.vocab_size) - cfg.vocab_size
    names = [p + f"self_attn.{x}_proj.weight" for x in "qkvo"] + [
        p + f"mlp.{x}_proj.weight" for x in ("gate", "up", "down")]
    srcs = [kept[n] for n in names] + [np.concatenate(
        [head, np.zeros((pad, head.shape[1]), np.float32)])]
    with ThreadPoolExecutor(8) as ex:  # numpy's loops release the GIL
        host = list(ex.map(numpy_int4, srcs))
    want = {"wqkv": fuse_linears(host[0:3]), "wo": host[3],
            "wgate_up": fuse_linears(host[4:6]), "down": host[6]}
    lyr = params.layers
    for name, lin in want.items():
        got = getattr(lyr, name)
        got = type(got)(packed=got.packed[0], scales=got.scales[0])
        same_int4(got, lin, f"layer 0 {name}")
    same_int4(params.lm_head, host[7], "lm_head")


def boundary_weight(n_groups: int = 32, seed: int = 0) -> np.ndarray:
    """[n_groups, 128] f32 groups whose first element is the group's
    largest |w| = m (so d = m / -8) and whose others lie within 3 f32 ulps
    of the code boundaries x / d + 8.5 = k: where dividing by d, or one
    fused multiply-add, would move codes (tests/test_torch_awq.py)."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_groups):
        m = np.float32(rng.uniform(0.1, 1.0))
        inv = np.float32(1.0) / (m / np.float32(-8.0))
        x = ((rng.integers(1, 16, 127) - 8.5) / np.float64(inv)).astype(
            np.float32)
        x = (x.view(np.int32) + rng.integers(-3, 4, 127).astype(np.int32)
             ).view(np.float32)
        rows.append(np.concatenate([[m], np.clip(x, -0.999 * m, 0.999 * m)]))
    return np.asarray(rows, np.float32)


def faulted_rtn(form: str):
    """The search's int4 round trip (``awq.rtn_kn``) with one cast point
    changed, for FAULTED_SEARCHES: ``"div"`` divides by d where numpy
    multiplies by 1 / d; ``"fma"`` rounds g * (1 / d) + 8.5 once, as a fused
    multiply-add would."""
    def rtn(w_kn, group_size):
        k, n = w_kn.shape
        g = w_kn.float().reshape(k // group_size, group_size, n)
        d = torch.gather(g, 1, g.abs().argmax(1, keepdim=True)) / -8.0
        x = g / d if form == "div" else g.double() * (1.0 / d).double()
        q = torch.clamp((x + 8.5).float(), 0.0, 15.0)
        q = torch.where(d == 0.0, torch.full_like(q, 8.0), q).to(torch.uint8)
        return ((q.float() - 8.0) * d).reshape(k, n)
    return rtn


def s32_grid(grid):
    """``awq._grid`` with each s rounded to f32 (numpy 1.x's promotion,
    where the search's normalisation would stay in f32)."""
    def faulted(s_base, n_grid):
        for alpha, s in grid(s_base, n_grid):
            yield alpha, s.astype(np.float32).astype(np.float64)
    return faulted


# the faulted searches whose loss gaps AWQ_HOST_RTOL must lie below:
# form -> (the awq attribute it replaces, its maker from the sound one)
FAULTED_SEARCHES = {"div": ("rtn_kn", lambda _: faulted_rtn("div")),
                    "fma": ("rtn_kn", lambda _: faulted_rtn("fma")),
                    "s32": ("_grid", s32_grid)}


def awq_checks(fp, scaled, info, cfg, calib, dev):
    """Phase 15's AWQ checks on the card: each chosen loss at most its
    alpha = 0 (RTN) loss; qkv and gate_up choose alpha > 0 in every layer
    at most AWQ_RTN_SHARE of RTN's; layer 0's wo search on AWQ_HOST_ROWS
    rows against numpy's on the host (alphas equal, s bit-equal, losses
    within AWQ_HOST_RTOL, which the FAULTED_SEARCHES' gaps exceed); the
    card's int4 round trip equal to numpy's on layer 0's folded wo and on
    code-boundary weights; the folded model's logits on 64 tokens within
    FOLD_TOL of the unfolded model's, with the same argmax where the top
    two lie apart, and a faulted fold's (layer 0's input norm undivided)
    beyond it. Returns what it read."""
    from tinychatengine_tpu_torch.generation import kv_cache as kvc
    from tinychatengine_tpu_torch.models import llama
    from tinychatengine_tpu_torch.quant import awq
    out = {"alpha": info["alpha"], "loss_vs_rtn": {}}
    for site, per in info["losses"].items():
        per = [per] if site == "lm_head" else per
        alphas = info["alpha"][site]
        alphas = [alphas] if site == "lm_head" else alphas
        shares = []
        for i, (losses, a) in enumerate(zip(per, alphas)):
            chosen = losses[round(a * len(losses))]
            shares.append(chosen / losses[0])
            log(f"awq {site} layer {i}: alpha {a}, loss {chosen:.6e}, "
                f"RTN {losses[0]:.6e} ({chosen / losses[0]:.4f} of it)")
            if not chosen <= losses[0]:
                raise SystemExit(f"awq {site} layer {i}: chosen loss above "
                                 "RTN's")
            if site in ("qkv", "gate_up") and dev != "cpu" and not (
                    a > 0 and chosen <= AWQ_RTN_SHARE * losses[0]):
                raise SystemExit(f"awq {site} layer {i}: alpha {a}, "
                                 f"{chosen / losses[0]:.4f} of RTN's loss")
        out["loss_vs_rtn"][site] = shares

    x_wo = next(awq.calibration_layers(fp, cfg, calib))["wo"]
    x_wo = x_wo[::max(1, x_wo.shape[0] // AWQ_HOST_ROWS)][:AWQ_HOST_ROWS]
    w_wo = fp.layers.wo.weight[0].float()
    ratio = cfg.num_heads // cfg.num_kv_heads
    mag = np.mean(np.abs(x_wo.cpu().numpy()), axis=0).reshape(
        -1, ratio, cfg.head_dim).mean(1)
    s_base = np.repeat(mag[:, None, :], ratio, 1).reshape(-1)
    t = time.perf_counter()
    s_dev, a_dev, l_dev = awq.search_scale(x_wo, w_wo, 128, s_base=s_base,
                                           device=dev)
    t_dev = time.perf_counter() - t
    t = time.perf_counter()
    s_host, a_host, l_host = awq.search_scale(
        x_wo.cpu().numpy(), w_wo.cpu().numpy(), 128, s_base=s_base,
        device="cpu")
    t_host = time.perf_counter() - t
    l_host = np.asarray(l_host)

    def gap(losses):  # the largest relative loss gap to numpy's
        return float(np.max(np.abs(np.asarray(losses) - l_host) / l_host))
    faulted = {}
    for form, (attr, make) in FAULTED_SEARCHES.items():
        sound = getattr(awq, attr)
        setattr(awq, attr, make(sound))
        try:
            faulted[form] = gap(awq.search_scale(
                x_wo, w_wo, 128, s_base=s_base, device=dev)[2])
        finally:
            setattr(awq, attr, sound)
    rel = gap(l_dev)
    out["wo_host"] = dict(alpha=a_dev, alpha_host=a_host, loss_rel=rel,
                          faulted_loss_rel=faulted,
                          s_equal=bool(np.array_equal(s_dev, s_host)),
                          card_s=t_dev, host_s=t_host)
    log(f"awq layer 0 wo on {x_wo.shape[0]} rows, card vs numpy "
        f"(tol {AWQ_HOST_RTOL}):", json.dumps(out["wo_host"]))
    if not (a_dev == a_host and np.array_equal(s_dev, s_host)
            and rel <= AWQ_HOST_RTOL):
        raise SystemExit("awq: the card's wo search parts from numpy's")
    if dev != "cpu" and not min(faulted.values()) > AWQ_HOST_RTOL:
        raise SystemExit("awq: a faulted search's losses lie within "
                         "AWQ_HOST_RTOL of numpy's")

    folded = scaled.layers.wo.weight[0].float()
    bw = boundary_weight()
    for what, w_kn in (("folded wo", folded),
                       ("code boundaries", torch.from_numpy(bw.T.copy()))):
        got = awq.rtn_kn(w_kn.to(dev), 128).cpu().numpy()
        if not np.array_equal(got, awq._rtn(w_kn.cpu().numpy(), 128)):
            raise SystemExit(f"awq: the card's int4 round trip of {what} "
                             "differs from numpy's")
    ids = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 64)), device=dev)
    # a faulted fold beside the sound one: layer 0's qkv rows carry AWQ's
    # scales but its input norm is left undivided
    faulted = dataclasses.replace(scaled, layers=dataclasses.replace(
        scaled.layers, input_norm=torch.cat([fp.layers.input_norm[:1],
                                             scaled.layers.input_norm[1:]])))
    logits = []
    with torch.inference_mode():
        for p in (fp, scaled, faulted):
            cache = kvc.init_cache(cfg.num_layers, 1, 64, cfg.num_kv_heads,
                                   cfg.head_dim, device=dev)
            logits.append(llama.forward(p, cfg, ids, cache, 0,
                                        full_logits=True)[0][0].float().cpu())
    a, b, c = logits
    tol = FOLD_TOL * float(a.abs().max())
    top2 = a.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * tol
    out["fold_err"] = float((a - b).abs().max() / a.abs().max())
    out["faulted_fold_err"] = float((a - c).abs().max() / a.abs().max())
    out["fold_argmax_clear"] = int(clear.sum())
    log(f"awq folded vs unfolded fp logits: max |diff| / max |logit| = "
        f"{out['fold_err']:.3e}, faulted fold (layer 0's input norm "
        f"undivided) {out['faulted_fold_err']:.3e} (tol {FOLD_TOL}), "
        f"{int(clear.sum())} of 64 positions with a clear argmax")
    if not (out["fold_err"] <= FOLD_TOL and torch.equal(
            a.argmax(-1)[clear], b.argmax(-1)[clear])):
        raise SystemExit("awq: the folded model is not the unfolded one")
    if not out["faulted_fold_err"] > FOLD_TOL:
        raise SystemExit("awq: a faulted fold lies within FOLD_TOL of the "
                         "unfolded model")
    return out


def run_convert_cli(args: list, dev) -> None:
    """``python -m tinychatengine_tpu_torch.tools.convert`` as a user runs
    it: a subprocess on the card, in process for a CPU rehearsal."""
    if dev == "cpu":
        from tinychatengine_tpu_torch.tools import convert
        convert.main(args + ["--device", "cpu"])
        return
    r = subprocess.run([sys.executable, "-m",
                        "tinychatengine_tpu_torch.tools.convert", *args],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    for line in r.stdout.splitlines():
        log(f"  convert: {line}")
    if r.returncode != 0:
        raise SystemExit(f"convert CLI failed ({r.returncode}):\n{r.stderr}")


def bytellama_hf(root: Path) -> None:
    """``assets/bytellama_5m`` (fp, bf16 leaves) exported as an HF llama
    directory: one ``model.safetensors`` of bf16 [OC, IC] tensors."""
    from tinychatengine_tpu_torch.core.config import get_model_config
    from tinychatengine_tpu_torch.tools.checkpoint import load_checkpoint
    cfg = get_model_config("bytellama_5m")
    p, _ = load_checkpoint(str(ROOT / "assets" / "bytellama_5m"), cfg,
                           device="cpu")
    d, lyr = cfg.head_dim, p.layers
    q, kv = cfg.num_heads * d, cfg.num_kv_heads * d
    t = {"model.embed_tokens.weight": p.embed,
         "model.norm.weight": p.final_norm,
         "lm_head.weight": p.lm_head.weight[:, :cfg.vocab_size].T}
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        wqkv, gu = lyr.wqkv.weight[i], lyr.wgate_up.weight[i]
        f = gu.shape[1] // 2
        t.update({pre + "input_layernorm.weight": lyr.input_norm[i],
                  pre + "post_attention_layernorm.weight": lyr.post_norm[i],
                  pre + "self_attn.q_proj.weight": wqkv[:, :q].T,
                  pre + "self_attn.k_proj.weight": wqkv[:, q:q + kv].T,
                  pre + "self_attn.v_proj.weight": wqkv[:, q + kv:].T,
                  pre + "self_attn.o_proj.weight": lyr.wo.weight[i].T,
                  pre + "mlp.gate_proj.weight": gu[:, :f].T,
                  pre + "mlp.up_proj.weight": gu[:, f:].T,
                  pre + "mlp.down_proj.weight": lyr.down.weight[i].T})
    root.mkdir(parents=True, exist_ok=True)
    write_safetensors(root / "model.safetensors",
                      {k: v.contiguous() for k, v in t.items()})


def awq_calib_windows(n: int, window: int) -> np.ndarray:
    """``scripts/measure_awq.py``'s calibration: ``n`` windows of ``window``
    byte tokens from this machine's ``tools/corpus.py`` train split (8 MB
    corpus), offsets from ``default_rng(0)``."""
    from tinychatengine_tpu_torch.tools import corpus
    blob = corpus.build_corpus(max_bytes=8 << 20)
    train, _ = corpus.train_eval_split(blob)
    rng = np.random.default_rng(0)
    return np.stack([np.frombuffer(train[o:o + window], np.uint8).astype(
        np.int32) for o in rng.integers(0, len(train) - window, n)])


def bytellama_cli(work: Path, dev, n_windows: int, eval_tokens: int):
    """bytellama_5m exported to HF, converted to W4A16 by the CLI with and
    without ``--awq-calib``; fp, RTN and AWQ perplexity on the held-out
    sample (window 512, stride 256) through the kernels. The RTN
    checkpoint must equal ``requantize_llama`` of the fp checkpoint, and
    on the card AWQ's Delta ppl must be at most RTN's + AWQ_PPL_SLACK
    points."""
    from tinychatengine_tpu_torch.core.config import (QuantConfig,
                                                      get_model_config)
    from tinychatengine_tpu_torch.models import llama
    from tinychatengine_tpu_torch.tokenizers.byte_fallback import ByteTokenizer
    from tinychatengine_tpu_torch.tools.checkpoint import (flatten,
                                                           load_checkpoint)
    from tinychatengine_tpu_torch.tools.convert import requantize_llama
    from tinychatengine_tpu_torch.tools.perplexity import perplexity
    cfg = get_model_config("bytellama_5m")
    ckpt = ROOT / "assets" / "bytellama_5m"
    t = time.perf_counter()
    bytellama_hf(work / "bytellama_hf")
    calib = awq_calib_windows(n_windows, AWQ_WINDOW)
    np.save(work / "calib.npy", calib)
    base = ["--model", "bytellama_5m", "--src", str(work / "bytellama_hf"),
            "--scheme", "w4a16"]
    run_convert_cli(base + ["--out", str(work / "rtn")], dev)
    run_convert_cli(base + ["--out", str(work / "awq"), "--awq-calib",
                            str(work / "calib.npy"), "--awq-windows",
                            str(n_windows)], dev)
    cli_s = time.perf_counter() - t
    fp, _ = load_checkpoint(str(ckpt), cfg, device=dev)
    rtn, q_rtn = load_checkpoint(str(work / "rtn"), cfg, device=dev)
    awq_p, q_awq = load_checkpoint(str(work / "awq"), cfg, device=dev)
    if (q_rtn.scheme, q_awq.scheme) != ("w4a16", "w4a16"):
        raise SystemExit("the CLI wrote another scheme")
    # the asset's lm_head pads its N with trained columns, the export and
    # the CLI with zeros: the vocabulary's columns are compared there
    want = flatten(requantize_llama(fp, QuantConfig(scheme="w4a16")))
    got = flatten(rtn)

    def cols(k, a):
        return a[..., :cfg.vocab_size] if k.startswith("lm_head") else a
    if sorted(got) != sorted(want) or not all(
            torch.equal(cols(k, got[k].cpu()), cols(k, want[k].cpu()))
            for k in want if not k.startswith("rope")):
        raise SystemExit("the CLI's RTN checkpoint differs from "
                         "requantize_llama of the checkpoint it came from")
    ids = np.asarray(ByteTokenizer().encode((ckpt / "eval_sample.txt")
                                            .read_text(encoding="utf-8")),
                     np.int64)[:eval_tokens]
    ppl = {name: perplexity(llama.forward, p, cfg, ids, 512, 256)
           for name, p in (("fp", fp), ("rtn_w4a16", rtn),
                           ("awq_w4a16", awq_p))}
    d_rtn = 100 * (ppl["rtn_w4a16"] / ppl["fp"] - 1)
    d_awq = 100 * (ppl["awq_w4a16"] / ppl["fp"] - 1)
    out = dict(ppl=ppl, dppl_rtn_pct=d_rtn, dppl_awq_pct=d_awq,
               eval_tokens=len(ids), calib=list(calib.shape), cli_s=cli_s,
               cpu_accuracy_md=ACCURACY_CPU_PPL)
    log(f"bytellama_5m through the convert CLI ({dev}) beside ACCURACY.md's "
        "CPU run (JAX package, another machine's corpus):", json.dumps(out))
    if dev != "cpu" and not d_awq <= d_rtn + AWQ_PPL_SLACK:
        raise SystemExit(f"AWQ Delta ppl {d_awq:.3f} % above RTN's "
                         f"{d_rtn:.3f} % + {AWQ_PPL_SLACK}")
    return out


def native_checks(shard: Path, dev) -> dict:
    """The native library on this machine: built, ``read_file`` of a
    safetensors shard equal to ``np.fromfile``, and phase 14's synthetic
    Llama-3 tokenizer (128000 ranks) encoding through the C++ merger with
    the ids of its Python merge (``TINYCHAT_NO_NATIVE=1`` in a second
    process)."""
    import os
    import tempfile
    from tinychatengine_tpu_torch import native
    from tinychatengine_tpu_torch.tokenizers import Llama3BPE
    if not native.available():
        raise SystemExit("the native library did not build")
    if not np.array_equal(native.read_file(str(shard), np.uint8),
                          np.fromfile(shard, np.uint8)):
        raise SystemExit("native.read_file differs from np.fromfile")
    text = (ROOT / "assets" / "bytellama_5m" / "eval_sample.txt").read_text(
        encoding="utf-8")[:8192]
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = llama3_tokenizer(Path(tmp), 128000 if dev != "cpu" else 4096)
        tok = Llama3BPE.load(str(path))
        if tok._native_merger() is None:
            raise SystemExit("Llama3BPE did not take the C++ merger")
        ids = tok.encode(text)
        code = ("import json, sys\n"
                "from tinychatengine_tpu_torch.tokenizers import Llama3BPE\n"
                f"tok = Llama3BPE.load({str(path)!r})\n"
                "assert tok._native_merger() is None\n"
                "print(json.dumps(tok.encode(sys.stdin.read())))\n")
        r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                           input=text, capture_output=True, timeout=300,
                           env={**os.environ, "TINYCHAT_NO_NATIVE": "1"})
        if r.returncode != 0:
            raise SystemExit(f"the Python-merge tokenizer failed:\n{r.stderr}")
        py_ids = json.loads(r.stdout)
    out = dict(library=str(native._target().relative_to(ROOT)),
               shard_bytes=shard.stat().st_size, text_chars=len(text),
               ids=len(ids), ids_equal=ids == py_ids)
    log("native:", json.dumps(out))
    if ids != py_ids:
        raise SystemExit("the C++ merger's ids differ from the Python "
                         "merge's")
    return out


def convert_path(dev="cuda", model="llama3_8b", n_layers=CONVERT_LAYERS,
                 n_windows=AWQ_WINDOWS, window=AWQ_WINDOW,
                 eval_tokens=32768, n_predict=32):
    """Phase 15: the conversion toolchain on the card.

    llama3_8b at full width cut to ``n_layers`` layers, written as two HF
    safetensors shards of seeded bf16 tensors with AWQ's motif; converted to
    W4A8 (layer 0 and the lm_head held byte for byte to ``quantize_linear``
    in numpy on the source weights); converted to fp and scaled by
    ``awq_scale_llama`` over ``n_windows`` x ``window`` seeded ids
    (``flash_prefill`` once a layer, no plain version; ``awq_checks``);
    requantized to W4A8, saved, loaded and run through
    ``Engine.generate_device`` (64-token prompt, ``n_predict`` greedy
    tokens, graph == eager, a 512-token prefill for the tile route; the
    W4A8 path's kernels launch, no plain version runs; the first decode
    step within CUT_TOL of the CPU's plain forward of the same checkpoint,
    the prefill's distance printed; the same scaled tree in W4A16, its
    prefill and first step within CUT_TOL of the CPU's); bytellama_5m
    through the convert CLI (``bytellama_cli``); the native library
    (``native_checks``). The
    arguments shrink the run for a rehearsal on the CPU (tests). Returns
    the phase's numbers, its seconds split by step."""
    import tempfile
    from tinychatengine_tpu_torch.core.config import QuantConfig
    from tinychatengine_tpu_torch.generation.engine import Engine
    from tinychatengine_tpu_torch.generation import kv_cache as kvc
    from tinychatengine_tpu_torch.models import llama
    from tinychatengine_tpu_torch.ops import _build
    from tinychatengine_tpu_torch.quant import awq
    from tinychatengine_tpu_torch.tools import convert as cv
    from tinychatengine_tpu_torch.tools.checkpoint import (load_checkpoint,
                                                           save_checkpoint)
    cfg = dataclasses.replace(model_config(model), num_layers=n_layers)
    sync = torch.cuda.synchronize if dev != "cpu" else (lambda: None)
    secs, out = {}, {"layers": n_layers}
    w4a8 = QuantConfig(scheme="w4a8", group_size=128)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        work = Path(tmp)
        hf = work / "hf"
        hf.mkdir()
        t = time.perf_counter()
        keep = [n for n, _ in hf_llama_specs(cfg)
                if n.startswith("model.layers.0.") and "proj" in n]
        kept = synthetic_hf_llama(cfg, hf, dev, keep=keep + ["lm_head.weight"])
        secs["write"] = time.perf_counter() - t

        # RTN import, timed by its reads and quantizations
        t = time.perf_counter()
        with timed_calls(cv, "quantize_linear", sync) as quants:
            loader = cv._hf_state_dict_loader
            reads = []

            def timed_loader(src):
                get = loader(src)

                def timed_get(name):
                    t0 = time.perf_counter()
                    a = get(name)
                    reads.append((name, time.perf_counter() - t0))
                    return a
                return timed_get
            cv._hf_state_dict_loader = timed_loader
            try:
                params = cv.convert_hf_llama(str(hf), cfg, w4a8, device=dev)
                sync()
            finally:
                cv._hf_state_dict_loader = loader
        secs["convert_w4a8"] = time.perf_counter() - t
        secs["read"] = sum(s for _, s in reads)
        # the lm_head is read and quantized last
        head = sum(s for n, s in reads if n == "lm_head.weight") \
            + quants[-1][1]
        embed = sum(s for n, s in reads if n == "model.embed_tokens.weight")
        secs["convert_per_layer"] = (secs["convert_w4a8"] - head
                                     - embed) / n_layers
        secs["convert_lm_head"] = head
        t = time.perf_counter()
        rtn_import_check(params, kept, cfg, w4a8)
        secs["rtn_import_check"] = time.perf_counter() - t
        del params, kept

        # AWQ on the fp import
        t = time.perf_counter()
        fp = cv.convert_hf_llama(str(hf), cfg, QuantConfig(scheme="fp"),
                                 device=dev)
        sync()
        secs["convert_fp"] = time.perf_counter() - t
        calib = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                  (n_windows, window))
        t = time.perf_counter()
        with plain_calls() as plain, \
                timed_calls(awq, "search_scale", sync) as searches:
            _build.reset_launches()
            scaled, info = awq.awq_scale_llama(fp, cfg, calib, 128)
            sync()
            out["awq_launches"] = dict(_build.LAUNCHES)
        awq_launches = {k: v for k, v in out["awq_launches"].items() if v}
        secs["awq"] = time.perf_counter() - t
        secs["awq_search"] = sum(s for _, s in searches)
        secs["awq_calibration"] = secs["awq"] - secs["awq_search"]
        log(f"awq on {n_windows} x {window} ids, launches:",
            json.dumps(awq_launches), "plain calls:", json.dumps(plain))
        if dev != "cpu" and (awq_launches != {"flash_prefill": n_layers}
                             or any(plain.values())):
            raise SystemExit("awq's calibration forward did not run "
                             "flash_prefill once a layer, and only it")
        t = time.perf_counter()
        out.update(awq_checks(fp, scaled, info, cfg, calib, dev))
        secs["awq_checks"] = time.perf_counter() - t
        del fp

        # round trip through the checkpoint and the Engine; the same
        # scaled tree in W4A16 for the comparison with the CPU below
        t = time.perf_counter()
        w4a16 = QuantConfig(scheme="w4a16", group_size=128)
        for name, q in (("ckpt", w4a8), ("ckpt_w4a16", w4a16)):
            save_checkpoint(str(work / name), cv.requantize_llama(scaled, q),
                            cfg, q, extra_meta={"family": "llama"})
        del scaled
        params, qcfg = load_checkpoint(str(work / "ckpt"), cfg, device=dev)
        sync()
        secs["requantize_save_load"] = time.perf_counter() - t
        t = time.perf_counter()
        rng = np.random.default_rng(2)
        prompt = rng.integers(0, cfg.vocab_size, (1, 64))
        long_prompt = rng.integers(0, cfg.vocab_size, (1, 512))
        gcfg = greedy_config(n_predict)
        with plain_calls() as plain:
            _build.reset_launches()
            eng = Engine(params, cfg, qcfg, batch=1, max_len=640, device=dev)
            toks = eng.generate_device(prompt, gcfg, n_tokens=n_predict).cpu()
            eng.prefill(long_prompt, eng.new_cache())
            sync()
            out["engine_launches"] = dict(_build.LAUNCHES)
        launches = {k: v for k, v in out["engine_launches"].items() if v}
        eager = Engine(params, cfg, qcfg, batch=1, max_len=640, device=dev,
                       cuda_graphs=False).generate_device(
            prompt, gcfg, n_tokens=n_predict).cpu()
        out["graph_eq_eager"] = bool(torch.equal(toks, eager))
        log(f"converted {cfg.name} ({n_layers} layers) w4a8 Engine launches:",
            json.dumps(launches), "plain calls:", json.dumps(plain),
            "graph == eager:", out["graph_eq_eager"])
        if not out["graph_eq_eager"]:
            raise SystemExit("converted model: graph tokens part from eager")
        if dev != "cpu" and (any(plain.values()) or not all(
                launches.get(k, 0) > 0 for k in ENGINE_KERNELS)):
            raise SystemExit("converted model: a W4A8 kernel did not launch "
                             "or a plain version ran")
        # the prefill and first decode step against the CPU's plain forward
        # of the same checkpoint: held in W4A16; in W4A8 the first step is
        # held and the prefill printed, since on this source the W4A8
        # model's plain path alone parts by 4.5e-2 of max |logit| between
        # the card and the CPU at the prefill (int8 activation codes
        # flipping at .5 boundaries; PERF.md, section 6)

        def vs_cpu(p, ckpt):  # max |diff| / max |ref| at prefill, step
            steps = {}
            with torch.inference_mode():
                for where, pp in ((dev, p), ("cpu", load_checkpoint(
                        str(ckpt), cfg, device="cpu")[0])):
                    cache = kvc.init_cache(cfg.num_layers, 1, 128,
                                           cfg.num_kv_heads, cfg.head_dim,
                                           device=where)
                    first = llama.forward(pp, cfg, torch.as_tensor(
                        prompt, device=where), cache, 0)[0]
                    step = llama.forward(pp, cfg, torch.tensor(
                        [[int(toks[0, 0])]], device=where), cache, 64)[0]
                    steps[where] = (first.float().cpu(), step.float().cpu())
            return [float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(steps[dev], steps["cpu"])]
        errs = vs_cpu(params, work / "ckpt")
        errs16 = vs_cpu(load_checkpoint(str(work / "ckpt_w4a16"), cfg,
                                        device=dev)[0], work / "ckpt_w4a16")
        out["prefill_vs_cpu"], out["first_step_vs_cpu"] = errs
        out["w4a16_prefill_vs_cpu"], out["w4a16_first_step_vs_cpu"] = errs16
        log(f"converted model vs the CPU's plain forward: max |diff| / max "
            f"|ref| = W4A8 {errs[0]:.3e} at the prefill (printed), "
            f"{errs[1]:.3e} at the first decode step; W4A16 {errs16[0]:.3e} "
            f"and {errs16[1]:.3e} (tol {CUT_TOL})")
        if not (errs[1] <= CUT_TOL and max(errs16) <= CUT_TOL):
            raise SystemExit("converted model: the card's logits disagree "
                             "with the CPU's plain forward")
        secs["engine"] = time.perf_counter() - t
        del params, eng
        if dev != "cpu":
            torch.cuda.empty_cache()

        t = time.perf_counter()
        out["bytellama"] = bytellama_cli(work, dev, n_windows, eval_tokens)
        secs["bytellama_cli_ppl"] = time.perf_counter() - t
        t = time.perf_counter()
        out["native"] = native_checks(next(hf.glob("*.safetensors")), dev)
        secs["native"] = time.perf_counter() - t
    out["seconds"] = secs
    log(f"phase 15 seconds ({cfg.name} cut to {n_layers} layers):",
        json.dumps(secs))
    return out


# ---- phase 16: the byte models trained on the card -------------------------

# phase 16: train_tiny.main for bytellama_5m (TRAIN_STEPS["llama"]) and
# byteopt_4m (TRAIN_STEPS["opt"]) at full width, batch 16 x window 512, on
# TRAIN_CORPUS_MB MB of local source, scored on TRAIN_EVAL_TOKENS held-out
# tokens; the first step's loss and every scheme's ppl within TRAIN_RTOL of
# the CPU's (the bytellama ppl tolerance of the CPU twins); a second,
# TWIN_STEPS-long training on the card and on the CPU from the same init
# and offsets (``train_twin``): every step's loss within TWIN_RTOL and
# every trained tensor within TWIN_SHARE of its change (the limits of
# tests/test_torch_train.py's twin against JAX; read on an NVIDIA H100
# 80GB HBM3 at 700.00 W: 5.8e-5 and 0.029 for bytellama_5m, 2.1e-5 and
# 0.037 for byteopt_4m); the mean of the last 16 losses below
# TRAIN_LOSS_SHARE of the first; the trained fp ppl below TRAIN_PPL_SHARE
# of the untrained init's; bench_op, net of the same chain on the identity
# op (its feed), within BENCH_OP_RTOL of the kernel phase's time for the
# same case
TRAIN_STEPS = {"llama": 300, "opt": 200}
TRAIN_CORPUS_MB = 4
TRAIN_EVAL_TOKENS = 4096
TRAIN_RTOL = 2e-3
TWIN_STEPS = 4
TWIN_RTOL = 5e-4
TWIN_SHARE = 0.1
TRAIN_LOSS_SHARE = 0.5
TRAIN_PPL_SHARE = 0.1
BENCH_OP_RTOL = 0.2
# the kernels one W4A8 decode step launches (int4_matmul_a8, flash_decode),
# by a part of their names in the device trace
DECODE_TRACE_NAMES = ("a8_quant_kernel", "a8_mma_kernel", "split_kernel",
                      "combine_kernel")


def golden_prompts() -> list:
    """The byte tokens of the bytellama golden prompts."""
    from tinychatengine_tpu_torch.tokenizers.byte_fallback import ByteTokenizer
    golden = ROOT / "tests" / "golden"
    golds = [json.loads((golden / "bytellama_greedy.json").read_text())]
    golds += json.loads((golden / "bytellama_goldens.json").read_text())
    tok = ByteTokenizer()
    return [np.asarray(tok.encode(g["prompt"]), np.int64) for g in golds]


def leading_agreement(a, b) -> int:
    """How many leading tokens two sequences share."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def train_model(model, steps, work: Path, dev, corpus_mb, eval_tokens, batch,
                window) -> dict:
    """``train_tiny.main`` for one model on ``dev`` (training, checkpoint,
    eval sample, ppl.json), with the launches and plain-version calls of
    the training steps and of the evaluation counted apart; the first
    step's loss against the CPU's on the same init and ids; ``train_twin``;
    the ppl of the untrained init and of the checkpoint scored on the CPU
    beside the card's rows. Returns what it read."""
    from tinychatengine_tpu_torch.ops import _build
    from tinychatengine_tpu_torch.tokenizers.byte_fallback import ByteTokenizer
    from tinychatengine_tpu_torch.tools import train_tiny as tt
    from tinychatengine_tpu_torch.tools.checkpoint import load_checkpoint
    from tinychatengine_tpu_torch.tools.perplexity import perplexity
    cfg = model_config(model)
    sync = torch.cuda.synchronize if dev != "cpu" else (lambda: None)
    first, counts = {}, {}
    real_train, real_loss = tt.train, tt.batch_loss

    def recording_loss(forward_fn, params, cfg_, ids):
        if not first:  # the init's compute view and the first step's ids
            first["params"] = tree_map(params, lambda t: t.detach().cpu())
            first["ids"] = ids.cpu()
        return real_loss(forward_fn, params, cfg_, ids)

    def counted_train(*a, **kw):
        _build.reset_launches()
        with plain_calls() as plain:
            out = real_train(*a, **kw)
            sync()
        counts["train"] = dict(launches=dict(_build.LAUNCHES),
                               plain={k: v for k, v in plain.items() if v})
        _build.reset_launches()
        return out
    out_dir = work / model
    tt.train, tt.batch_loss = counted_train, recording_loss
    try:
        res = tt.main(["--out", str(out_dir), "--model", model, "--steps",
                       str(steps), "--batch", str(batch), "--window",
                       str(window), "--corpus-mb", str(corpus_mb),
                       "--eval-tokens", str(eval_tokens), "--device", dev])
        sync()
    finally:
        tt.train, tt.batch_loss = real_train, real_loss
    counts["eval"] = {k: v for k, v in _build.LAUNCHES.items() if v}
    losses = res["losses"]
    forward = tt._hooks(cfg.family)[1]
    with torch.no_grad():
        cpu_loss = float(real_loss(forward, first["params"], cfg,
                                   first["ids"]))
    text = (out_dir / "eval_sample.txt").read_text(encoding="utf-8")
    ids = np.asarray(ByteTokenizer().encode(text), np.int64)[:eval_tokens]
    init = tree_map(first["params"], lambda t: t.to(dev))
    init_ppl = perplexity(forward, init, cfg, ids, 512, 256)
    del init
    train_b, _ = tt.corpus_split(corpus_mb)
    twin = train_twin(cfg, train_b, dev, TWIN_STEPS, batch, window)
    cpu_params, _ = load_checkpoint(str(out_dir), cfg, device="cpu")
    cpu_rows = tt.score(cpu_params, cfg, train_b, ids, log=lambda *a: None)
    rows = {label: (p, cpu) for (label, p), (_, cpu) in zip(res["rows"],
                                                           cpu_rows)}
    m = dict(model=model, steps=steps, first_loss=losses[0],
             first_loss_cpu=cpu_loss,
             first_loss_rel=abs(losses[0] - cpu_loss) / cpu_loss,
             last16_loss=float(np.mean(losses[-16:])),
             losses_every_25=losses[::25], train_s=res["train_s"],
             train_tok_s=res["train_tok_s"], init_fp_ppl=init_ppl,
             ppl_card_cpu=rows,
             ppl_rel=max(abs(a - b) / b for a, b in rows.values()),
             train_counts=counts["train"], eval_launches=counts["eval"],
             twin=twin)
    log(f"phase 16 {model}:", json.dumps(m))
    fp_ppl = res["rows"][0][1]
    if m["first_loss_rel"] > TRAIN_RTOL:
        raise SystemExit(f"phase 16 {model}: the first step's loss on {dev} "
                         f"parts from the CPU's by {m['first_loss_rel']:.3e}")
    if m["ppl_rel"] > TRAIN_RTOL:
        raise SystemExit(f"phase 16 {model}: a scheme's ppl on {dev} parts "
                         f"from the CPU's: {rows}")
    if twin["loss_rel"] > TWIN_RTOL or twin["share"] > TWIN_SHARE \
            or not twin["bias_ok"]:
        raise SystemExit(f"phase 16 {model}: {TWIN_STEPS} steps on {dev} "
                         f"part from the CPU's: {twin}")
    train_launches = {k: v for k, v in counts["train"]["launches"].items()
                      if v}
    # llama's forward calls flash_prefill_plain while autograd records,
    # OPT's its dense attention (models.llama.records)
    if train_launches or (cfg.family == "llama" and not counts["train"][
            "plain"].get("flash_prefill_plain")):
        raise SystemExit(f"phase 16 {model}: the training steps launched "
                         f"{train_launches}, plain versions "
                         f"{counts['train']['plain']}")
    want = (("int4_matmul", "flash_prefill", "flash_prefill_int8")
            if cfg.family == "llama" else ("flash_prefill",))
    if dev != "cpu" and not all(counts["eval"].get(k) for k in want):
        raise SystemExit(f"phase 16 {model}: the evaluation launched "
                         f"{counts['eval']}, not all of {want}")
    if dev != "cpu" and not (m["last16_loss"]
                             < TRAIN_LOSS_SHARE * losses[0]
                             and fp_ppl < TRAIN_PPL_SHARE * init_ppl):
        raise SystemExit(f"phase 16 {model}: the loss fell from "
                         f"{losses[0]:.4f} to {m['last16_loss']:.4f}, fp ppl "
                         f"{fp_ppl:.4f} against the init's {init_ppl:.4f}")
    m["ckpt"] = out_dir
    return m


def train_twin(cfg, corpus: bytes, dev, steps: int, batch: int,
               window: int) -> dict:
    """``train_tiny.train`` for ``steps`` steps on ``dev``, then on the
    CPU from the same init (drawn with numpy) on the offsets the first run
    drew: the worst step's loss gap (relative) and the worst trained
    tensor's ||w_dev - w_cpu|| / ||w_cpu - w_init|| over the returned bf16
    trees; OPT's k_proj bias, whose true gradient is zero, element by
    element within twice the summed step sizes, as
    tests/test_torch_train.py holds it against JAX."""
    from tinychatengine_tpu_torch.core.config import QuantConfig
    from tinychatengine_tpu_torch.tools import train_tiny as tt
    from tinychatengine_tpu_torch.tools.checkpoint import flatten
    real_draw, offsets = tt.draw_offsets, []

    def recorded(gen, b, n, w):
        offsets.append(real_draw(gen, b, n, w))
        return offsets[-1]
    replay = iter(offsets)
    losses, trees = {}, {}
    try:
        for key, where, draw in (
                ("dev", dev, recorded),
                ("cpu", "cpu", lambda gen, b, n, w: next(replay).cpu())):
            tt.draw_offsets = draw
            losses[key] = []
            trees[key] = flatten(tt.train(
                cfg, corpus, steps=steps, batch=batch, window=window,
                log=lambda *a: None, device=where, history=losses[key]))
    finally:
        tt.draw_offsets = real_draw
    init = flatten(tt._hooks(cfg.family)[0](cfg, QuantConfig(scheme="fp"),
                                            0, "cpu"))
    lr_sum = sum(tt.lr_schedule(i, steps, 3e-3) for i in range(steps))
    shares, bias_ok = {}, True
    for k, w in trees["cpu"].items():
        if k.startswith("rope_"):
            continue
        g, w, w0 = trees["dev"][k].cpu().float(), w.float(), init[k].float()
        if k == "layers/k_proj/bias":
            bias_ok = float((g - w).abs().max()) <= 2 * lr_sum
            continue
        shares[k] = float(torch.linalg.norm(g - w)
                          / torch.linalg.norm(w - w0))
    worst = max(shares, key=shares.get)
    out = dict(steps=steps, losses_dev=losses["dev"],
               losses_cpu=losses["cpu"],
               loss_rel=max(abs(a - b) / b for a, b in zip(losses["dev"],
                                                         losses["cpu"])),
               share=shares[worst], worst_tensor=worst, bias_ok=bias_ok)
    log(f"phase 16 {cfg.name}, {steps} steps on {dev} against the CPU:",
        json.dumps(out))
    return out


def trained_engine_check(ckpt: Path, cfg, dev, n_predict: int) -> dict:
    """The trained bytellama checkpoint through ``load_checkpoint`` and
    ``Engine``: ``n_predict`` greedy tokens of each golden prompt on the
    card against the same parameters on the CPU, fp and W4A8 (phase 9's
    rule: at least 16 leading tokens agree)."""
    from tinychatengine_tpu_torch.core.config import (GenerationConfig,
                                                      QuantConfig)
    from tinychatengine_tpu_torch.generation.engine import Engine
    from tinychatengine_tpu_torch.tools.checkpoint import load_checkpoint
    from tinychatengine_tpu_torch.tools.convert import requantize_llama
    g = GenerationConfig(temp=0.0, n_predict=n_predict, repeat_penalty=1.0,
                         repeat_last_n=1)
    prompts = golden_prompts()
    out = {}
    for scheme in ("fp", "w4a8"):
        qcfg = QuantConfig(scheme=scheme, group_size=128)
        toks = []
        for where in (dev, "cpu"):
            params = load_checkpoint(str(ckpt), cfg, device=where)[0]
            eng = Engine(requantize_llama(params, qcfg), cfg, qcfg,
                         max_len=cfg.max_sqlen, device=where)
            toks.append([eng.generate(x[None], g).tokens[0]
                         for x in prompts])
        out[scheme] = [leading_agreement(a, b) for a, b in zip(*toks)]
    log(f"phase 16 trained {cfg.name}, greedy tokens agreeing card vs "
        "CPU:", json.dumps(out))
    if min(min(v) for v in out.values()) < min(16, n_predict):
        raise SystemExit("phase 16: the trained model's greedy tokens on "
                         "the card part from the CPU's within 16 tokens")
    return out


def bench_op_check(dev, kernel_cases, k: int = 4096, n: int = 6144) -> dict:
    """``utils.benchmark.bench_op`` on ``int4_matmul_a8`` at llama3_8b's
    qkv shape (K, N) with M = 1, its weights stacked and cycled as the
    kernel phase's case (``int4_cases``), against that case's time
    (``kernel_cases``; none on the CPU), net of the chain's feed (the
    same chain on the identity op, printed beside); the case timed again
    as phase 3 times it is printed beside too."""
    from tinychatengine_tpu_torch.ops import int4_matmul as im
    from tinychatengine_tpu_torch.utils.benchmark import bench_op
    gen = torch.Generator(device=dev).manual_seed(16)
    n_layers = max(2, -(-200_000_000 // (k * n // 2))) if dev != "cpu" else 2
    packed = torch.randint(0, 256, (n_layers, k // 2, n), dtype=torch.uint8,
                           device=dev, generator=gen)
    scales = ((torch.rand((n_layers, k // 128, n), device=dev, generator=gen)
               + 0.5) * 0.005).to(torch.bfloat16)
    x = torch.randn((1, k), device=dev, generator=gen).to(torch.bfloat16)
    state = {"li": 0}

    def op(x, packed, scales):
        state["li"] = (state["li"] + 1) % n_layers
        return im.int4_matmul_a8(x, packed, scales, 128,
                                 layer_idx=state["li"])
    with torch.inference_mode():
        ms = bench_op(op, x, packed, scales, iters=100, trials=3) * 1e3
        # the chain's feed alone: the same chain on the identity op
        feed = bench_op(lambda x, *w: x, x, packed, scales, iters=100,
                        trials=3) * 1e3
        # the same case as phase 3 times it, now (printed beside)
        now = graph_ms(lambda: op(x, packed, scales), 50) \
            if dev != "cpu" else None
    case = f"qkv M=1 K={k} N={n}"
    row = next((c for c in kernel_cases or ()
                if c["kernel"] == "int4_matmul_a8" and c["case"] == case),
               None)
    out = dict(case=case, bench_op_ms=ms, feed_ms=feed, net_ms=ms - feed,
               kernel_phase_ms=row["ms"] if row else None,
               graph_ms_now=now)
    if row:
        out["rel"] = (ms - feed) / row["ms"] - 1.0
    log("phase 16 bench_op:", json.dumps(out))
    if dev != "cpu" and not abs(out["rel"]) <= BENCH_OP_RTOL:
        raise SystemExit(f"phase 16: bench_op reads {ms:.4f} ms, its feed "
                         f"{feed:.4f} ms, the kernel phase {row['ms']:.4f} "
                         f"ms for {case}")
    return out


def decode_trace(ckpt: Path, cfg, dev, logdir: Path) -> dict:
    """``utils.profiler.device_trace`` over one W4A8 decode step of the
    trained bytellama (after a golden prompt's prefill): whether its
    Chrome trace names the step's kernels (``DECODE_TRACE_NAMES``; on the
    CPU an ``aten::`` op) and its top five device operations."""
    from tinychatengine_tpu_torch.core.config import QuantConfig
    from tinychatengine_tpu_torch.generation import kv_cache as kvc
    from tinychatengine_tpu_torch.models import llama
    from tinychatengine_tpu_torch.tools.checkpoint import load_checkpoint
    from tinychatengine_tpu_torch.tools.convert import requantize_llama
    from tinychatengine_tpu_torch.utils.profiler import device_trace
    params = requantize_llama(load_checkpoint(str(ckpt), cfg, device=dev)[0],
                              QuantConfig(scheme="w4a8", group_size=128))
    prompt = torch.as_tensor(golden_prompts()[0][None], device=dev)
    cache = kvc.init_cache(cfg.num_layers, 1, 128, cfg.num_kv_heads,
                           cfg.head_dim, device=dev)
    with torch.inference_mode():
        logits, cache = llama.forward(params, cfg, prompt, cache, 0)
        tok = logits.argmax(-1)[:, None]
        with device_trace(str(logdir), device=dev) as prof:
            llama.forward(params, cfg, tok, cache, cache.length)
    text = (logdir / "trace.json").read_text()
    names = DECODE_TRACE_NAMES if dev != "cpu" else ("aten::",)
    top = sorted(device_ms_by_kernel(prof).items(), key=lambda kv: -kv[1])[:5]
    out = dict(named={k: k in text for k in names},
               top5_device_ms=dict(top) if top else "not measured")
    log("phase 16 device_trace of one W4A8 decode step:", json.dumps(out))
    if not all(out["named"].values()):
        raise SystemExit("phase 16: the decode step's trace does not name "
                         f"its kernels: {out['named']}")
    return out


def train_path(dev="cuda", models=("bytellama_5m", "byteopt_4m"),
               steps=None, corpus_mb=TRAIN_CORPUS_MB,
               eval_tokens=TRAIN_EVAL_TOKENS, batch=16, window=512,
               n_predict=32, kernel_cases=None, bench_shape=(4096, 6144)):
    """Phase 16: the byte models trained on the card (``train_model``:
    llama, then OPT, through ``train_tiny.main``), the trained llama
    through ``Engine`` against the CPU (``trained_engine_check``), the
    trained OPT's prefill from ``input_embeds`` against its prefill from
    ids (``embeds_prefill_equal``), ``bench_op`` (``bench_op_check``) and
    ``device_trace`` (``decode_trace``). The arguments shrink the run for a
    rehearsal on the CPU (tests). Returns the phase's numbers."""
    import tempfile
    from tinychatengine_tpu_torch.tools.checkpoint import load_checkpoint
    steps = steps or TRAIN_STEPS
    (ROOT / "build").mkdir(exist_ok=True)
    out, secs = {}, {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        work = Path(tmp)
        cfgs = {}
        for model in models:
            t = time.perf_counter()
            cfg = model_config(model)
            cfgs[cfg.family] = cfg
            out[cfg.family] = train_model(model, steps[cfg.family], work, dev,
                                          corpus_mb, eval_tokens, batch,
                                          window)
            secs[cfg.family] = time.perf_counter() - t
        t = time.perf_counter()
        out["engine"] = trained_engine_check(out["llama"]["ckpt"],
                                             cfgs["llama"], dev, n_predict)
        opt_params = load_checkpoint(str(out["opt"]["ckpt"]), cfgs["opt"],
                                     device=dev)[0]
        out["opt_embeds_equal"] = embeds_prefill_equal(opt_params,
                                                       cfgs["opt"], dev)
        del opt_params
        if not out["opt_embeds_equal"]:
            raise SystemExit("phase 16: byteopt's prefill from input_embeds "
                             "differs from its prefill from ids")
        out["bench_op"] = bench_op_check(dev, kernel_cases, *bench_shape)
        out["decode_trace"] = decode_trace(out["llama"]["ckpt"],
                                           cfgs["llama"], dev, work / "trace")
        secs["checks"] = time.perf_counter() - t
    for fam in ("llama", "opt"):
        out[fam]["ckpt"] = str(out[fam]["ckpt"].relative_to(work))
    out["seconds"] = secs
    log("phase 16 seconds:", json.dumps(secs))
    return out


# ---- phase 17: tensor, sequence and pipeline parallelism -----------------
# The ranks are processes time-sharing the one card over gloo (every
# collective through pinned host buffers): the collectives are real, the
# kernels run at per-shard shapes, and no figure of the phase is a scaling
# figure. The phase's model: llama3_8b W4A8 at full width with codes
# centred on the zero point and weight scale PAR_STD, chosen by what the
# phase prints as ``why_this_model``. Phase 4's uniform bytes put a common
# offset into every output, so another prompt's logits sit within the
# limit below of the first prompt's: no fault could show there. At the
# init's 0.02 (each linear multiplies its input's RMS by about 1.4) a
# 32-layer model is chaotic: one process that sums two bf16-rounded halves
# of K in wo and down (``split_rows``: TP's rounding without TP) reads
# 0.1-0.2 from one process, as TP = 2 does, and so a fault reads no
# further. At 0.005 the logits depend on the prompt, TP's rounding stays
# near 0.02 at 32 layers, and a planted fault reads ten times that.
PAR_STD = 0.005
# A step of a parallel run against the one-process run of the same
# weights, max |diff| / max |logit| (``step_gap``); also each layer of the
# SP splice's K and V. The row-parallel partials are each rounded to bf16
# before their sum, which 32 layers carry as phase 4f's two cast points
# (KOUTER_STEP_TOL). Every run also shows a planted fault (rank 1 taking
# rank 0's wo rows in one layer; a ring hop that hands each rank its own
# block) reading above it, and one process with TP's rounding
# (``split_rows``) within it. Greedy tokens may part only where the
# one-process run's top-2 margin is within SPEC_TIE_TOL of max |logit|
# (``partings``).
PAR_STEP_TOL = KOUTER_STEP_TOL
# (b)'s teacher-forced logits: the prompt's and 4 steps'
PAR_FORCED = 5
# the phase's sizes: (b) a 64-token prompt and 32 greedy tokens, (c) 4
# requests x 32 tokens paged, (d) a 2048-token SP prompt and 8 decode
# steps, (e) 2 rows of 64 tokens over 2 stages x 2 microbatches and 8
# decode steps
PAR_SIZES = dict(prompt=64, decode=32, requests=4, req_tokens=32,
                 sp_len=2048, sp_decode=8, pp_rows=2, pp_micro=2,
                 pp_decode=8, max_len=4096)
# llama3_8b's linears split over 2 model ranks (column: N / 2; row: K / 2;
# the lm_head's 129024 padded columns / 2)
TP2_SHAPES = {"qkv": (4096, 3072), "wo": (2048, 4096),
              "gate_up": (4096, 14336), "down": (7168, 4096),
              "lm_head": (4096, 64512)}
# the paged decode of (c): 4 ragged slots over 2 pages of 128
TP2_SERVING = ((32, 128, 16, 4, 128, (None,)),)
TP2_SERVING_LENGTHS = (64, 70, 80, 95)


def shard_shape_cases(gen, add):
    """Phase 17a: the kernels at the per-shard shapes of the parallel
    paths. ``int4_matmul_a8`` at TP = 2's five linears at M = 1 (decode),
    4 (the 4-slot tick) and 64 (the prompt); ``int4_matmul``'s tile route
    at 1024 rows (an SP rank's half of a 2048-token prompt, whole widths);
    ``flash_decode`` and ``flash_prefill`` at Hq = 16 over Hkv = 4 (a TP
    rank's heads), ``flash_decode_paged`` there over 4 ragged slots."""
    for name, (k, n) in TP2_SHAPES.items():
        int4_cases(gen, add, name, k, n, (1, 4, 64), (), label="tp2 ")
    full = {"qkv": (4096, 6144), "wo": (4096, 4096),
            "gate_up": (4096, 28672), "down": (14336, 4096)}
    for name, (k, n) in full.items():
        int4_cases(gen, add, name, k, n, (), (1024,), label="sp2 ")
    dev = torch.device("cuda")
    L, S, d, hq, hkv = 32, 2048, 128, 16, 4
    ck = torch.randn((L, 1, hkv, S, d), device=dev, generator=gen).to(torch.bfloat16)
    cv = torch.randn((L, 1, hkv, S, d), device=dev, generator=gen).to(torch.bfloat16)
    for length in (65, 96, 2047):
        decode_case(gen, add, ck, cv, hq, length, label="tp2 ")
    prefill_case(gen, add, ck, cv, hq, 64, 0, label="tp2 ")
    del ck, cv
    torch.cuda.empty_cache()
    check_serving_kernels(gen, add, TP2_SERVING, TP2_SERVING_LENGTHS, "tp2 ")


def step_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b| of one step's logits."""
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).abs().max() / b.abs().max())


def splice_gaps(cache, one, s: int) -> dict:
    """``step_gap`` of each layer's K and V over the first s positions of
    ``cache`` against ``one``."""
    return {name: [step_gap(getattr(cache, name)[i, :, :, :s],
                            getattr(one, name)[i, :, :, :s])
                   for i in range(one.k.shape[0])] for name in ("k", "v")}


def par_prompts(cfg, sizes, seed=17):
    """The phase's prompts, from one seed: (b)'s, (c)'s requests, (d)'s,
    (e)'s rows and another of (b)'s length (the model's input
    dependence)."""
    rng = np.random.default_rng(seed)
    v = cfg.vocab_size

    def draw(*shape):
        return rng.integers(10, v - 10, shape).astype(np.int64)
    return dict(tp=draw(sizes["prompt"]),
                requests=[draw(n) for n in rng.integers(
                    sizes["prompt"] // 2, sizes["prompt"] + 1,
                    sizes["requests"])],
                sp=draw(sizes["sp_len"]),
                pp=draw(sizes["pp_rows"], sizes["prompt"]),
                other=draw(sizes["prompt"]))


def par_serving(params, cfg, qcfg, sizes, prompts, dev, forward_fn=None):
    """(c): the requests through a paged ServingEngine, greedy."""
    from tinychatengine_tpu_torch.core.config import GenerationConfig
    from tinychatengine_tpu_torch.models import llama
    from tinychatengine_tpu_torch.runtime.serving import ServingEngine
    g = GenerationConfig(temp=0.0, n_predict=sizes["req_tokens"],
                         repeat_penalty=1.0, repeat_last_n=1)
    srv = ServingEngine(params, cfg, qcfg, slots=sizes["requests"],
                        max_len=sizes["max_len"], gcfg=g, paged=True,
                        forward_fn=forward_fn or llama.forward, device=dev)
    reqs = [srv.submit(p) for p in prompts]
    srv.run()
    return [list(r.output_ids) for r in reqs], srv


def par_model(cfg, dev, std=None):
    """Phase 17's llama W4A8 weights: codes centred on the zero point,
    weight scale ``std`` (PAR_STD)."""
    return random_model(cfg, dev, centered=True,
                        std=PAR_STD if std is None else std)


@contextlib.contextmanager
def split_rows(params):
    """While open, ``llama.forward`` in this process computes wo and down
    as a TP = 2 pair of ranks does: each half of K through the kernel,
    rounded to bf16, the halves summed in f32 and rounded once
    (``Axis.psum``); every other op as one process runs it. Phase 17b's
    witness for the rounding that TP adds."""
    from tinychatengine_tpu_torch.models import llama
    from tinychatengine_tpu_torch.ops.linear import apply_linear

    def halves(lin):
        kp, kg = lin.packed.shape[-2] // 2, lin.scales.shape[-2] // 2
        return [dataclasses.replace(
            lin, packed=lin.packed.narrow(-2, r * kp, kp).contiguous(),
            scales=lin.scales.narrow(-2, r * kg, kg).contiguous())
            for r in (0, 1)]
    split = {id(lin): halves(lin)
             for lin in (params.layers.wo, params.layers.down)}
    whole = llama.row_parallel

    def row_parallel(lin, x, tp_axis, **kw):
        k = x.shape[-1] // 2
        y = [apply_linear(h, x[..., r * k:(r + 1) * k].contiguous(),
                          **kw).float() for r, h in enumerate(split[id(lin)])]
        return (y[0] + y[1]).to(x.dtype)
    llama.row_parallel = row_parallel
    try:
        yield
    finally:
        llama.row_parallel = whole


def _counted():
    """The kernels' launch counts since the last call, reset after reading
    (a rank's own process counts)."""
    from tinychatengine_tpu_torch.ops import _build
    out = dict(_build.LAUNCHES)
    _build.reset_launches()
    return out


def par_rank(rank, world, model, dev, sizes, want):
    """Phase 17's rank body (b)-(e), on ``dev`` (every rank of 2). ``want``:
    the one-process run's tokens of (b) and (d), which those parts are
    also fed (teacher-forced logits). (b) and (d) also run a planted fault
    each, outside the counted runs. Returns what rank 0 saw and every
    rank's launch counts and plain-version calls per part."""
    from tinychatengine_tpu_torch.core.config import GenerationConfig
    from tinychatengine_tpu_torch.generation import kv_cache as kvc
    from tinychatengine_tpu_torch.generation.engine import Engine
    from tinychatengine_tpu_torch.models import llama
    from tinychatengine_tpu_torch.parallel import distributed, pp, sp, tp
    from tinychatengine_tpu_torch.parallel.sharding import (make_mesh,
                                                            shard_params)
    from tinychatengine_tpu_torch.tools.convert import refuse_llama_tp
    cfg = model_config(model)
    prompts = par_prompts(cfg, sizes)
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    full, qcfg = par_model(cfg, dev)
    out = {"launches": {}, "plain": {}}
    with plain_calls() as plain:
        # (b) TP = 2: the engine through make_tp_forward
        mesh = make_mesh(1, 2)
        p_tp = shard_params(refuse_llama_tp(full, cfg, 2), mesh)
        fwd = tp.make_tp_forward(mesh, device=dev)
        eng = Engine(p_tp, cfg, qcfg, batch=1, max_len=sizes["max_len"],
                     forward_fn=fwd, device=dev)
        g = GenerationConfig(temp=0.0, n_predict=sizes["decode"],
                             repeat_penalty=1.0, repeat_last_n=1)
        prompt = prompts["tp"][None]
        steps = sizes["decode"] - 1

        def run(n):  # (seconds, collectives, launches, tokens) of n tokens
            _counted()
            distributed.reset_stats()
            sync()
            t = time.perf_counter()
            toks = eng.generate_device(prompt, g, n_tokens=n).cpu()
            return (time.perf_counter() - t, dict(distributed.STATS),
                    _counted(), toks)
        run(1)  # warm the eager loop
        t_1, stats_1, launches_1, _ = run(1)
        t_n, stats_n, launches_n, toks = run(sizes["decode"])
        per_step = {k: (launches_n[k] - launches_1[k]) / steps
                    for k in launches_n}
        out["launches"]["tp_engine"] = launches_n

        def forced_run():  # teacher-forced on the one-process tokens
            cache = eng.new_cache()
            lg, cache = eng.prefill(prompt, cache)
            forced = [lg[0].float().cpu()]
            for i, tk in enumerate(want["tp"][:PAR_FORCED - 1]):
                lg, cache = fwd(p_tp, cfg,
                                torch.tensor([[int(tk)]], device=dev), cache,
                                sizes["prompt"] + i)
                forced.append(lg[0].float().cpu())
            return torch.stack(forced)
        forced = forced_run()
        # the planted fault: rank 1 multiplies its heads' attention by rank
        # 0's wo rows in the middle layer
        li, wo = cfg.num_layers // 2, p_tp.layers.wo
        kept = wo.packed[li].clone(), wo.scales[li].clone()
        if rank == 1:
            wo.packed[li].copy_(full.layers.wo.packed[li, :wo.packed.shape[-2]])
            wo.scales[li].copy_(full.layers.wo.scales[li, :wo.scales.shape[-2]])
        fault = forced_run()
        wo.packed[li].copy_(kept[0])
        wo.scales[li].copy_(kept[1])
        out["tp"] = dict(tokens=toks[0].tolist(), forced=forced, fault=fault,
                         step_s=(t_n - t_1) / steps,
                         per_step={k: (stats_n[k] - stats_1[k]) / steps
                                   for k in stats_n},
                         launches_per_step=per_step)
        # (c) TP paged serving
        _counted()
        toks_c, srv = par_serving(p_tp, cfg, qcfg, sizes,
                                  prompts["requests"], dev, fwd)
        out["serving"] = dict(tokens=toks_c,
                              heads=srv.page_cache.k.shape[2])
        out["launches"]["tp_paged_serving"] = _counted()
        del eng, srv, p_tp, fwd
        # (d) SP = 2 (seq): the ring prefill, the splice, 8 decode steps
        mesh = sp.make_sp_mesh(2)
        s = sizes["sp_len"]
        c_sp = sp.shard_sp_cache(kvc.init_cache(
            cfg.num_layers, 1, s, cfg.num_kv_heads, cfg.head_dim, device=dev),
            mesh)
        ids = torch.as_tensor(prompts["sp"][None], device=dev)
        _counted()
        distributed.reset_stats()
        sync()
        t = time.perf_counter()
        lg, c_sp = sp.make_sp_prefill(mesh, device=dev)(full, cfg, ids, c_sp)
        sync()
        t_sp = time.perf_counter() - t
        sp_stats = dict(distributed.STATS)
        dcache = kvc.init_cache(cfg.num_layers, 1, sizes["max_len"],
                                cfg.num_kv_heads, cfg.head_dim, device=dev)
        sp.sp_cache_into(dcache, c_sp, mesh)
        sp_out = dict(logits=lg[0].float().cpu(), prefill_s=t_sp,
                      stats=sp_stats)
        forced = [lg[0].float().cpu()]  # decode from the splice, fed the
        # one-process run's tokens
        for i, tk in enumerate(want["sp"][:-1]):
            lg, dcache = llama.forward(full, cfg,
                                       torch.tensor([[int(tk)]], device=dev),
                                       dcache, s + i)
            forced.append(lg[0].float().cpu())
        sp_out["forced"] = torch.stack(forced)
        out["launches"]["sp_prefill"] = _counted()
        # every layer of the splice against one process's prefill of the
        # prompt (rank 0), then the planted fault: a ring hop that hands
        # each rank its own block
        one = kvc.init_cache(cfg.num_layers, 1, s, cfg.num_kv_heads,
                             cfg.head_dim, device=dev)
        if rank == 0:
            lg_one, one = llama.forward(full, cfg, ids, one, 0)
            sp_out["layer_gaps"] = splice_gaps(dcache, one, s)
        seq = mesh["seq"]
        seq.ppermute = lambda x, shift=1: x
        c_f = sp.shard_sp_cache(kvc.init_cache(
            cfg.num_layers, 1, s, cfg.num_kv_heads, cfg.head_dim, device=dev),
            mesh)
        lg_f, c_f = sp.make_sp_prefill(mesh, device=dev)(full, cfg, ids, c_f)
        del seq.ppermute
        sp.sp_cache_into(dcache, c_f, mesh)
        if rank == 0:
            sp_out["fault_layer_gaps"] = splice_gaps(dcache, one, s)
            sp_out["fault_logit_gap"] = step_gap(lg_f[0], lg_one[0])
        out["sp"] = sp_out
        del dcache, c_sp, c_f, one
        # (e) PP = 2 stages x its layers, 2 microbatches
        mesh = pp.make_pp_mesh(2)
        b = sizes["pp_rows"]
        p_pp, c_pp = pp.shard_pp(full, kvc.init_cache(
            cfg.num_layers, b, sizes["max_len"], cfg.num_kv_heads,
            cfg.head_dim, device=dev), mesh)
        del full
        fwd = pp.make_pp_forward(mesh, sizes["pp_micro"], device=dev)
        _counted()
        distributed.reset_stats()
        lg, c_pp = fwd(p_pp, cfg, torch.as_tensor(prompts["pp"], device=dev),
                       c_pp, 0)
        pp_out = dict(logits=lg.float().cpu(), stats=dict(distributed.STATS))
        toks_e = []
        for i in range(sizes["pp_decode"]):
            tk = torch.argmax(lg, -1)
            toks_e.append(tk.tolist())
            lg, c_pp = fwd(p_pp, cfg, tk[:, None], c_pp, sizes["prompt"] + i)
        pp_out["tokens"] = np.asarray(toks_e).T.tolist()
        out["pp"] = pp_out
        out["launches"]["pp"] = _counted()
        out["plain"] = dict(plain)
    if rank:  # the other ranks report their counts only
        return {"launches": out["launches"], "plain": out["plain"]}
    return out


def why_this_model(cfg, dev, prompts) -> dict:
    """Phase 17's reasons for its model, printed beside (b): on phase 4's
    uniform bytes, the first-step gap between two prompts; at weight
    scale 0.02, one process with TP's rounding (``split_rows``) against
    one process over PAR_FORCED teacher-forced steps."""
    params, qcfg = random_model(cfg, dev)
    a, b = (forced_logits(params, cfg, qcfg, dev, prompts[k], [0])[0]
            for k in ("tp", "other"))
    out = {"uniform_bytes_other_prompt": step_gap(b, a)}
    del params
    params, qcfg = par_model(cfg, dev, std=0.02)
    toks = prompts["other"][:PAR_FORCED].tolist()
    one = forced_logits(params, cfg, qcfg, dev, prompts["tp"], toks)
    with split_rows(params):
        two = forced_logits(params, cfg, qcfg, dev, prompts["tp"], toks)
    out["std_0.02_split_rows"] = [step_gap(two[i], one[i])
                                  for i in range(PAR_FORCED)]
    del params, one, two
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def parallel_path(dev="cuda", model="llama3_8b", sizes=PAR_SIZES,
                  scaling_args=("--configs", "1x1,1x2", "--num-layers", "4",
                                "--n-decode", "8", "--scheme", "w4a8")):
    """Phase 17 (b)-(f): ``why_this_model``, the one-process references of
    the same weights in this process (and (b)'s split-K witness), then 2
    ranks (``parallel.distributed.launch``) through ``par_rank``, then
    ``tools/scaling.py``'s CLI. Every check fails the run; returns the
    figures the summary prints."""
    from tinychatengine_tpu_torch.core.config import GenerationConfig
    from tinychatengine_tpu_torch.generation import kv_cache as kvc
    from tinychatengine_tpu_torch.generation.engine import Engine
    from tinychatengine_tpu_torch.models import llama
    from tinychatengine_tpu_torch.parallel import distributed
    from tinychatengine_tpu_torch.tools import scaling
    cfg = model_config(model)
    prompts = par_prompts(cfg, sizes)
    with torch.inference_mode():
        why = why_this_model(cfg, dev, prompts)
    params, qcfg = par_model(cfg, dev)
    g = GenerationConfig(temp=0.0, n_predict=sizes["decode"],
                         repeat_penalty=1.0, repeat_last_n=1)
    with torch.inference_mode():
        eng = Engine(params, cfg, qcfg, batch=1, max_len=sizes["max_len"],
                     device=dev)
        want_b = eng.generate_device(prompts["tp"][None], g,
                                     n_tokens=sizes["decode"])[0].tolist()
        forced_b = forced_logits(params, cfg, qcfg, dev, prompts["tp"],
                                 want_b)
        with split_rows(params):
            split_b = forced_logits(params, cfg, qcfg, dev, prompts["tp"],
                                    want_b[:PAR_FORCED])
        other_b = forced_logits(params, cfg, qcfg, dev, prompts["other"],
                                want_b[:1])[0]
        want_c, _ = par_serving(params, cfg, qcfg, sizes,
                                prompts["requests"], dev)
        s = sizes["sp_len"]
        c1 = kvc.init_cache(cfg.num_layers, 1, sizes["max_len"],
                            cfg.num_kv_heads, cfg.head_dim, device=dev)
        lg, c1 = llama.forward(params, cfg, torch.as_tensor(
            prompts["sp"][None], device=dev), c1, 0)
        want_d, sp_steps = [], []
        for i in range(sizes["sp_decode"]):
            sp_steps.append(lg[0].float().cpu())
            tk = int(torch.argmax(lg[0]))
            want_d.append(tk)
            lg, c1 = llama.forward(params, cfg,
                                   torch.tensor([[tk]], device=dev), c1, s + i)
        del c1
        want_e = Engine(params, cfg, qcfg, batch=sizes["pp_rows"],
                        max_len=sizes["max_len"], device=dev).generate_device(
            prompts["pp"], g, n_tokens=sizes["pp_decode"]).tolist()
        pp_first = [forced_logits(params, cfg, qcfg, dev, row, want_e[r])
                    for r, row in enumerate(prompts["pp"])]
    t = time.perf_counter()
    ranks = distributed.launch(par_rank, 2, args=(
        model, dev, sizes, {"tp": want_b, "sp": want_d}), device=dev)
    ranks_s = time.perf_counter() - t
    r0 = ranks[0]
    res = {"why_this_model": why, "ranks_s": ranks_s,
           "launches": r0["launches"]}
    # no plain version ran on the card, on either rank; the TP and SP
    # ranks launch alike (a PP stage launches its own layers, the last one
    # the head too)
    for r, got in enumerate(ranks):
        if dev == "cuda" and any(got["plain"].values()):
            raise SystemExit(f"rank {r}: a plain version ran on the card: "
                             f"{got['plain']}")
        for part in ("tp_engine", "tp_paged_serving", "sp_prefill"):
            if got["launches"][part] != r0["launches"][part]:
                raise SystemExit(f"rank {r} launched otherwise than rank 0 "
                                 f"in {part}: {got['launches'][part]} vs "
                                 f"{r0['launches'][part]}")
    res["pp_launches_by_stage"] = [got["launches"]["pp"] for got in ranks]
    # (b) TP engine: the steps, one process with TP's rounding and the
    # planted fault against one process, and another prompt's first step
    tpo = r0["tp"]
    n = len(tpo["forced"])
    gaps = [step_gap(tpo["forced"][i], forced_b[i]) for i in range(n)]
    split = [step_gap(split_b[i], forced_b[i]) for i in range(n)]
    fault = [step_gap(tpo["fault"][i], forced_b[i]) for i in range(n)]
    other = step_gap(other_b, forced_b[0])
    log(f"phase 17b TP = 2 ranks on one card vs one process: step gaps "
        f"{json.dumps(gaps)}, split_rows {json.dumps(split)}, a wrong wo "
        f"shard {json.dumps(fault)}, another prompt {other} (limit "
        f"{PAR_STEP_TOL}); why this model {json.dumps(why)}")
    if max(gaps + split) > PAR_STEP_TOL:
        raise SystemExit(f"TP logits part from the one-process run: {gaps}, "
                         f"split_rows {split}")
    if min(fault) <= PAR_STEP_TOL or other <= PAR_STEP_TOL:
        raise SystemExit(f"phase 17b cannot see a fault on its model: a "
                         f"wrong shard {fault}, another prompt {other}")
    res["tp_parting"] = partings("tp engine", tpo["tokens"], want_b,
                                 lambda i: forced_b[i].cpu())
    res["tp"] = dict(step_gaps=gaps, split_rows_gaps=split,
                     fault_gaps=fault, other_prompt_gap=other,
                     step_s=tpo["step_s"],
                     tok_s=1.0 / tpo["step_s"], per_step=tpo["per_step"],
                     launches_per_step=tpo["launches_per_step"])
    # (c) TP paged serving
    got_c = r0["serving"]["tokens"]
    res["serving_partings"] = [
        partings(f"tp paged request {i}", got_c[i], want_c[i],
                 lambda j, i=i: forced_logits(params, cfg, qcfg, dev,
                                              prompts["requests"][i],
                                              want_c[i])[j].cpu())
        for i in range(len(want_c))]
    if r0["serving"]["heads"] != cfg.num_kv_heads // 2:
        raise SystemExit("a TP rank's page pool holds other than its heads")
    # (d) SP: the logits, every layer of the splice and the decode steps
    # from it against one process; the planted fault must read above
    spo = r0["sp"]
    lay, flay = spo["layer_gaps"], spo["fault_layer_gaps"]
    res["sp"] = dict(logit_gap=step_gap(spo["logits"], sp_steps[0]),
                     prefill_s=spo["prefill_s"], stats=spo["stats"],
                     k_layer_gaps=lay["k"], v_layer_gaps=lay["v"],
                     step_gaps=[step_gap(spo["forced"][i], sp_steps[i])
                                for i in range(len(sp_steps))],
                     fault_logit_gap=spo["fault_logit_gap"],
                     fault_k_layer_gaps=flay["k"],
                     fault_v_layer_gaps=flay["v"])
    log(f"phase 17d SP = 2 ranks: {json.dumps(res['sp'])}")
    sp_gaps = ([res["sp"]["logit_gap"]] + res["sp"]["step_gaps"] + lay["k"]
               + lay["v"])
    if max(sp_gaps) > PAR_STEP_TOL:
        raise SystemExit(f"SP prefill parts from the one-process prefill: "
                         f"{res['sp']}")
    if min(spo["fault_logit_gap"], max(flay["k"] + flay["v"])) \
            <= PAR_STEP_TOL:
        raise SystemExit(f"phase 17d cannot see a wrong ring hop: "
                         f"{res['sp']}")
    res["sp_parting"] = partings(
        "sp decode", [int(torch.argmax(x)) for x in spo["forced"]], want_d,
        lambda i: sp_steps[i])
    # (e) PP
    ppo = r0["pp"]
    res["pp"] = dict(logit_gaps=[step_gap(ppo["logits"][r], pp_first[r][0])
                                 for r in range(sizes["pp_rows"])],
                     stats=ppo["stats"])
    log(f"phase 17e PP = 2 stages: {json.dumps(res['pp'])}")
    if max(res["pp"]["logit_gaps"]) > PAR_STEP_TOL:
        raise SystemExit(f"PP logits part from the one-process run: "
                         f"{res['pp']}")
    res["pp_partings"] = [partings(f"pp row {r}", ppo["tokens"][r],
                                   want_e[r],
                                   lambda j, r=r: pp_first[r][j].cpu())
                          for r in range(sizes["pp_rows"])]
    # every kernel of the paths launched in the ranks' runs
    need = {"tp_engine": ("int4_matmul_a8", "flash_decode", "flash_prefill"),
            "tp_paged_serving": ("int4_matmul_a8", "flash_decode_paged",
                                 "flash_prefill"),
            "sp_prefill": ("int4_matmul", "int4_matmul_a8", "flash_decode"),
            "pp": ("int4_matmul_a8", "flash_prefill", "flash_decode")}
    if dev == "cuda":
        for part, kernels in need.items():
            for r, got in enumerate(ranks):
                missing = [k for k in kernels if not got["launches"][part][k]]
                if missing:
                    raise SystemExit(f"phase 17 {part}, rank {r}: {missing} "
                                     f"never launched")
    del params
    if dev == "cuda":
        torch.cuda.empty_cache()
    # (f) the scaling CLI, its ranks launched by itself
    res["scaling"] = scaling.main([*scaling_args, "--device", dev])
    return res


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
    "int4_moe": ("tinychatengine_tpu_torch/csrc/int4_moe.cu",
                 "none (the JAX package has no expert layer)",
                 "gate_up rows=512"),
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
# down projection, the fused MLP, int3); phase 3e's served Mellum tick for
# int4_moe, per step and per tick alike (its route, plan, act and combine
# kernels are counted in that phase's line, not in the table)
HOME_RUN = {"flash_decode_paged": "serving_paged", "int8_decode": "opt_engine",
            "int4_matmul_fused": "starcoder_fused",
            "flash_decode_int8": "llama_int8kv_engine",
            "flash_prefill_int8": "llama_int8kv_engine",
            "flash_decode_paged_int8": "long_int8_paged",
            "int4_matmul_kouter": "llama_w4a16_kouter",
            "int4_matmul_glu": "kernels", "mlp_fused": "kernels",
            "int3_matmul": "kernels", "int4_moe": "mellum_tick"}


@functools.cache
def sass(lib: Path) -> str:
    """The SASS of a built library (``cuobjdump -sass``, beside nvcc in the
    CUDA toolkit), dumped once."""
    from tinychatengine_tpu_torch.ops import _build
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    return subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout


def sass_count(lib: Path, opcode: str) -> int:
    """Instructions of ``opcode`` in the SASS of a built library."""
    return sum(opcode in line for line in sass(lib).splitlines())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (no main path)")
    ap.add_argument("--experts-only", action="store_true",
                    help="build, then phase 3e alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from tinychatengine_tpu_torch.ops import _build
    from tinychatengine_tpu_torch.ops import int4_matmul as im

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
    dumped = ("int4_matmul", "flash_prefill", "int4_matmul_kouter",
              "int4_matmul_fused", "mlp_fused", "int3_matmul", "int4_matmul_a8")
    with concurrent.futures.ThreadPoolExecutor(len(dumped)) as pool:
        list(pool.map(sass, [libs[n] for n in dumped]))  # all at once
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
    if args.experts_only:
        phase("mellum experts", check_experts, gen)
        return 0
    cases = phase("kernels", check_kernels, gen)
    kernel_launches = dict(_build.LAUNCHES)
    tile_widths = {"kernels": dict(_build.TILE_LAUNCHES)}  # by token tile
    if set(tile_widths["kernels"]) != set(im.TILE_WIDTHS):
        raise SystemExit("phase 3 ran the tile route at token tiles "
                         f"{tile_widths['kernels']}, not at each of "
                         f"{im.TILE_WIDTHS}")
    linears = phase("w8a8 linears", w8a8_linear_times, gen)
    _build.reset_launches()
    experts = phase("mellum experts", check_experts, gen)
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
    http = phase("llama http serving", http_serving, "llama3_8b", llama)
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
    conv = phase("llama3_8b conversion", convert_path)
    trained = phase("byte models trained on the card", train_path,
                    kernel_cases=cases)
    phase("tp2 and sp2 shard shapes", shard_shape_cases, gen,
          case_recorder(cases))
    par = phase("parallel paths, 2 ranks on one card", parallel_path)

    tick = experts["tick"]
    runs = {"engine": launches,  # path -> launches over its run
            "kernels": kernel_launches,
            "mellum_tick": tick["launches"],
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
            "vlm_engine": vlm_launches,
            "http_dense": http["dense"]["launches"],
            "http_paged": http["paged"]["launches"],
            "convert_awq_calibration": conv["awq_launches"],
            "convert_engine": conv["engine_launches"],
            **{f"rank0_{k}": v for k, v in par["launches"].items()}}
    mellum_tick = {k: v / tick["ticks"] for k, v in tick["launches"].items()}
    step_of = {"int8_decode": opt_step, "int4_matmul_fused": sc_ab["fused"][1],
               "int4_moe": mellum_tick,
               "int4_matmul_kouter": kouter["run"][1],
               **dict.fromkeys(INT8_KV.values(), kv8[1])}
    tick_of = {"int8_decode": opt_serving,
               "int4_matmul_fused": sc_serving["paged"],
               "flash_decode_int8": long_ctx["int8 dense"],
               "flash_prefill_int8": long_ctx["int8 dense"],
               "flash_decode_paged_int8": long_ctx["int8 paged"],
               "int4_moe": {"launches": tick["launches"],
                            "decode_ticks": tick["ticks"]}}
    tile_widths.update({f"{model} serving {mode}": run[mode]
                        ["tile_launches_by_width"]
                        for model, run in (("llama3_8b w4a8", serving),
                                           ("starcoder_15.5b w4a16",
                                            sc_serving))
                        for mode in ("dense", "paged")})
    rows = []
    cases += experts["kernels"]
    for name, (source, replaces, case) in SUMMARY.items():
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
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            **({"tile_launches_by_width": tile_widths}
               if name == "int4_matmul" else {})))
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
    for mode in ("dense", "paged"):
        m = http[mode]
        log(f"llama3_8b w4a8 HTTP serving {mode} on {smi}: "
            f"{m['http_tok_s']:.1f} tok/s over {m['wall_s']:.3f} s, "
            f"engine.step() {m['step_s']:.3f} s in {m['step_calls']} calls "
            f"(REST layer's share of the wall {1 - m['step_share']:.3f}), "
            f"TTFT p50 {m['ttft_p50_s']:.3f} s p95 {m['ttft_p95_s']:.3f} s "
            f"(/metrics mean {m['metrics_ttft_mean_s']:.3f} s), ticks "
            f"{json.dumps(m['tick_stats'])}, greedy equal to in-process "
            f"{m['greedy_eq_in_process']}, all {m['all_eq_in_process']}")
    log(f"llama3_8b chat.py repl on {smi}: {json.dumps(http['chat'])}; "
        f"serve.py bytellama_5m: {json.dumps(http['serve_cli'])}")
    log(f"llama3_8b conversion ({conv['layers']} layers) on {smi}: seconds "
        f"{json.dumps(conv['seconds'])}; AWQ alphas "
        f"{json.dumps(conv['alpha'])}; bytellama_5m ppl "
        f"{json.dumps(conv['bytellama']['ppl'])} (Delta RTN "
        f"{conv['bytellama']['dppl_rtn_pct']:.3f} %, AWQ "
        f"{conv['bytellama']['dppl_awq_pct']:.3f} %; ACCURACY.md's CPU run "
        f"{json.dumps(ACCURACY_CPU_PPL)})")
    for fam in ("llama", "opt"):
        m = trained[fam]
        log(f"{m['model']} trained on {smi}: {m['steps']} steps in "
            f"{m['train_s']:.2f} s ({m['train_tok_s']:.0f} tok/s), loss "
            f"{m['first_loss']:.4f} -> {m['last16_loss']:.4f} (mean of the "
            f"last 16; CPU first step {m['first_loss_cpu']:.4f}), every 25 "
            f"steps {json.dumps([round(v, 4) for v in m['losses_every_25']])}"
            f"; ppl on the card and the CPU {json.dumps(m['ppl_card_cpu'])} "
            f"(untrained init {m['init_fp_ppl']:.2f})")
    log(f"phase 16 on {smi}: greedy agreement {json.dumps(trained['engine'])}"
        f", byteopt input_embeds == ids {trained['opt_embeds_equal']}, "
        f"starcoder input_embeds == ids {sc_ab['embeds_prefill_equal']}, "
        f"bench_op {json.dumps(trained['bench_op'])}, decode trace "
        f"{json.dumps(trained['decode_trace'])}")
    if not sc_ab["embeds_prefill_equal"]:
        raise SystemExit("starcoder's prefill from input_embeds differs from "
                         "its prefill from ids")
    tpm = par["tp"]
    log(f"phase 17 on {smi}, 2 ranks time-sharing one card (no scaling "
        f"figure): TP = 2 llama3_8b w4a8 decode {tpm['tok_s']:.2f} tok/s "
        f"(eager, gloo), per step {tpm['per_step']['all_reduce']:.1f} "
        f"all-reduces, {tpm['per_step']['all_gather']:.1f} all-gathers, "
        f"{tpm['per_step']['broadcast']:.1f} broadcasts, "
        f"{1e3 * tpm['per_step']['seconds']:.3f} host ms inside "
        f"collectives; launches per step "
        f"{json.dumps({k: v for k, v in tpm['launches_per_step'].items() if v})}"
        f"; step gaps against one process {json.dumps(tpm['step_gaps'])}, "
        f"split_rows {json.dumps(tpm['split_rows_gaps'])}, wrong wo shard "
        f"{json.dumps(tpm['fault_gaps'])}, another prompt "
        f"{tpm['other_prompt_gap']}; why this model "
        f"{json.dumps(par['why_this_model'])}; "
        f"SP = 2 {json.dumps(par['sp'])}; PP = 2 {json.dumps(par['pp'])}; "
        f"partings tp {json.dumps(par['tp_parting'])}, paged "
        f"{json.dumps(par['serving_partings'])}, sp "
        f"{json.dumps(par['sp_parting'])}, pp {json.dumps(par['pp_partings'])}"
        f"; ranks' wall {par['ranks_s']:.1f} s")
    for r in par["scaling"]:
        log(f"phase 17f scaling on {smi}: {json.dumps(r)}")
    log("w8a8 linears at M = 1:", json.dumps(linears))
    log("phase seconds:", json.dumps(phase_s))
    log(smi)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
