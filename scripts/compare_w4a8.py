"""Time the PyTorch/CUDA port's W4A8 kernel (``int4_matmul_a8``) and fused
MLP (``mlp_fused``) of one checkout on the card, against their plain
versions, one PyTorch call and their bounds, so two checkouts (say a parent
commit unpacked beside the current tree) can be compared in one run on one
card:

    python3 scripts/compare_w4a8.py PATH/TO/CHECKOUT TAG [--serving]

It imports ``chip_smoke`` and ``tinychatengine_tpu_torch`` from the given
checkout, prints the card's name and power limit, builds the two kernels
(printing their register use and the IMMA / IGMMA / HMMA / HGMMA count of
their SASS), then times ``int4_matmul_a8`` at the cases of
``chip_smoke.py``'s phase 3 (llama3_8b's qkv, wo, gate_up, down and the
129024-column lm_head at M = 1, 8 and 64) and gate_up at M = 100
(``A8_MAX_ROWS``), and ``mlp_fused`` at llama3_8b's MLP at M = 1 and 16.
``--serving`` then makes phase 4's llama3_8b W4A8 model (random weights
from seed 0), measures its TTFT (phase 4's 64-token prompt: prefill and the
first sample, fetched to the host; the median of 7 after a warm-up) and
the device time of one more by kernel (torch.profiler: the total, its
share of the median TTFT, the W4A8 kernels' part), and profiles one decode
burst of phase 5's ServingEngine (8 slots, dense then paged,
``chip_smoke.burst_profile``), printing the W4A8 kernels' device ms per
tick (the kernels of ``A8_NAMES``: the parent's names and the current
ones). Each case is one JSON line (``chip_smoke.case_recorder``);
the last line, ``TAG SUMMARY``, lists them all. Needs a CUDA device."""

import itertools
import json
import statistics
import subprocess
import sys
import time

root, tag = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tinychatengine_tpu_torch.ops import _build  # noqa: E402
from tinychatengine_tpu_torch.ops import int4_matmul as im  # noqa: E402
from tinychatengine_tpu_torch.ops import mlp_fused as mf  # noqa: E402
from tinychatengine_tpu_torch.ops.linear import Int4Linear  # noqa: E402
from tinychatengine_tpu_torch.ops.ref import dequantize_int4  # noqa: E402

A8_SHAPES = (("qkv", 4096, 6144), ("wo", 4096, 4096),
             ("gate_up", 4096, 28672), ("down", 14336, 4096),
             ("lm_head", 4096, 129024))
A8_ROWS = (1, 8, 64)
# the W4A8 kernels' names in chip_smoke.device_ms_by_kernel: the CUDA-core
# kernel's (quantize, main pass, split sum) and the tensor-core kernel's
A8_NAMES = ("quant_act_kernel", "int4_a8_kernel", "sum_splits_kernel",
            "a8_quant_kernel", "a8_mma_kernel")

if not torch.cuda.is_available():
    sys.exit("compare_w4a8: no CUDA device")
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True,
                      text=True).stdout.strip()
print(tag, "CARD", card, flush=True)
t0 = time.perf_counter()
libs = _build.build_all(("int4_matmul_a8", "mlp_fused"))
print(tag, "build", round(time.perf_counter() - t0, 1), "s", flush=True)
for name, text in _build.BUILD_LOG.items():
    for line in text.splitlines():
        if "registers" in line or "spill" in line:
            print(tag, name, line.strip())
for lib, op in itertools.product(libs, ("IMMA", "IGMMA", "HMMA", "HGMMA")):
    print(tag, lib, "SASS", op, cs.sass_count(libs[lib], op), flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator(device="cuda").manual_seed(0)
cases = []
add = cs.case_recorder(cases)


def cycle(n_layers, call):
    state = {"li": 0}

    def run():
        state["li"] = (state["li"] + 1) % n_layers
        call(state["li"])
    return run


for name, k, n in A8_SHAPES:
    packed, scales = cs.int4_stack(gen, k, n)
    nl = packed.shape[0]
    w_lib = dequantize_int4(packed[0], scales[0], 128, torch.bfloat16)
    rows = A8_ROWS + ((100,) if name == "gate_up" else ())
    for m in rows:
        x = torch.randn((m, k), device="cuda", generator=gen).to(
            torch.bfloat16)
        err = share = 0.0
        for li in (0, nl - 1):
            e, sh = cs.mat_err(
                im.int4_matmul_a8(x, packed, scales, 128, layer_idx=li),
                im.int4_matmul_a8_plain(x, packed, scales, 128, layer_idx=li))
            err, share = max(err, e), max(share, sh)
        plain_ms = cs.time_ms(lambda: im.int4_matmul_a8_plain(
            x, packed, scales, 128, layer_idx=0), 10)
        add("int4_matmul_a8", f"{name} M={m} K={k} N={n}", err, share,
            f"{cs.MAT_TOL} * max|plain|",
            cycle(nl, lambda li: im.int4_matmul_a8(x, packed, scales, 128,
                                                   layer_idx=li)),
            50, plain_ms, lambda: torch.matmul(x, w_lib),
            m * k * 2 + k * n // 2 + (k // 128) * n * 2 + m * n * 2,
            2.0 * m * n * k, cs.INT8_OP_S)
    del packed, scales, w_lib
    torch.cuda.empty_cache()

# mlp_fused: llama3_8b's MLP (chip_smoke.py phase 3's cases)
e, f, n_layers = 4096, 14336, 3
silu = torch.nn.functional.silu
wgu, sgu = cs.int4_stack(gen, e, 2 * f, n_layers=n_layers)
wdn, sdn = cs.int4_stack(gen, f, e, n_layers=n_layers)
lin_gu, lin_dn = Int4Linear(wgu, sgu), Int4Linear(wdn, sdn)
lib_gu = dequantize_int4(wgu[0], sgu[0], 128, torch.bfloat16)
lib_dn = dequantize_int4(wdn[0], sdn[0], 128, torch.bfloat16)
for m in (1, 16):
    x = (torch.randn((m, e), device="cuda", generator=gen) * 0.5).to(
        torch.bfloat16)
    err = share = 0.0
    for li in (0, n_layers - 1):
        e_, sh = cs.mat_err(mf.mlp_fused(x, lin_gu, lin_dn, li),
                            mf.mlp_fused_plain(x, lin_gu, lin_dn, li))
        err, share = max(err, e_), max(share, sh)
    plain_ms = cs.time_ms(lambda: mf.mlp_fused_plain(x, lin_gu, lin_dn, 0), 3)

    def lib(x=x):
        g = torch.matmul(x, lib_gu)
        return torch.matmul(silu(g[:, :f]) * g[:, f:], lib_dn)
    add("mlp_fused", f"llama3_8b M={m} E={e} F={f} bn=2048", err, share,
        f"{cs.MAT_TOL} * max|plain|",
        cycle(n_layers, lambda li: mf.mlp_fused(x, lin_gu, lin_dn, li)),
        20, plain_ms, lib,
        3 * e * f // 2 + (e // 128) * 2 * f * 2 + (f // 128) * e * 2
        + 2 * m * e * 2, 6.0 * m * e * f, cs.BF16_FLOP_S)
del wgu, sgu, wdn, sdn, lin_gu, lin_dn, lib_gu, lib_dn
torch.cuda.empty_cache()

if "--serving" in sys.argv:
    from tinychatengine_tpu_torch.core.config import get_model_config
    from tinychatengine_tpu_torch.generation import sampling
    from tinychatengine_tpu_torch.generation.engine import (
        Engine, forward_for_family)
    from tinychatengine_tpu_torch.runtime.serving import ServingEngine
    cfg = get_model_config("llama3_8b")
    params, qcfg = cs.random_model(cfg, "cuda")
    gcfg = cs.greedy_config(64)
    eng = Engine(params, cfg, qcfg, batch=1, max_len=2048, device="cuda")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 64))

    def ttft_ms():
        cache = eng.new_cache()
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, _ = eng.prefill(prompt, cache)
        state = sampling.SamplerState.init(0, 1, 5.0, "cuda")
        tok, _ = sampling.sample(logits, state, gcfg, None)
        tok.cpu()
        return (time.perf_counter() - t) * 1e3
    ttft_ms()
    ttfts = [ttft_ms() for _ in range(7)]
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ttft_ms()
    by = cs.device_ms_by_kernel(prof)
    ttft_device = dict(
        device_ms=sum(by.values()),
        busy_share=sum(by.values()) / statistics.median(ttfts),
        a8_device_ms=sum(v for k, v in by.items() if k in A8_NAMES),
        top_kernels_ms=dict(sorted(by.items(), key=lambda kv: -kv[1])[:6]))
    del eng
    torch.cuda.empty_cache()
    profiles = []
    by_kernel = cs.device_ms_by_kernel

    def recording(prof):
        profiles.append(by_kernel(prof))
        return profiles[-1]
    cs.device_ms_by_kernel = recording
    bursts = {}
    for mode in ("dense", "paged"):
        srv = ServingEngine(params, cfg, qcfg, slots=8, max_len=2048,
                            gcfg=gcfg, admission_chunk=512, tick_batch=16,
                            forward_fn=forward_for_family(cfg.family),
                            paged=mode == "paged", device="cuda")
        cs.serving_load(srv, cfg, 2, 64, seed=1)  # warm-up
        srv.run()
        burst = cs.burst_profile(srv, cfg)["burst"]
        measured = isinstance(burst.get("ticks"), int)
        a8 = {k: v / burst["ticks"] for k, v in profiles[-1].items()
              if k in A8_NAMES} if measured else {}
        bursts[mode] = dict(
            tick_device_ms=burst.get("tick_device_ms", "not measured"),
            tick_wall_ms=burst.get("tick_wall_ms", "not measured"),
            a8_device_ms_per_tick=sum(a8.values()) if measured
            else "not measured", a8_by_kernel=a8)
        del srv
        torch.cuda.empty_cache()
    print(tag, "SERVING", json.dumps(dict(
        ttft_ms_median=statistics.median(ttfts), ttft_ms=ttfts,
        ttft_device=ttft_device, bursts=bursts)), flush=True)
print(tag, "SUMMARY", json.dumps([
    {k: c.get(k) for k in ("kernel", "case", "ms", "library_ms", "bound_ms",
                           "plain_ms", "err_share")}
    for c in cases]))
