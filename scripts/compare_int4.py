"""Time the PyTorch/CUDA port's K-outer and fused W4A16 kernels of one
checkout on the card, against their plain versions and bf16
``torch.matmul``, so two checkouts (say a parent commit unpacked beside the
current tree) can be compared in one run on one card:

    python3 scripts/compare_int4.py PATH/TO/CHECKOUT TAG [--starcoder]

It imports ``chip_smoke`` and ``tinychatengine_tpu_torch`` from the given
checkout, prints the card's name and power limit, builds the two kernels
(printing their register use and the HMMA / HGMMA count of their SASS),
then times ``int4_matmul_kouter`` at llama3_8b's four stacked shapes
(qkv, wo, gate_up, down; bn 2048, bk 1024) at M = 1, 16, 64 and 496, and
``int4_matmul_fused`` at the decode shapes of ``CASES`` (M = 1, and a
serving tick's 8 rows: StarCoder's five call sites with their parts and
llama3_8b's gate_up) through the checkout's own
``chip_smoke.check_fused_kernels``. ``--starcoder`` then runs
the checkout's phase 11 (``chip_smoke.serving_path("starcoder_15.5b",
fused=True)``, 16 requests x 64 tokens) and prints the fused kernel's
device ms per tick of the paged burst. Each case is one JSON line
(``chip_smoke.case_recorder``); the last line, ``TAG SUMMARY``, lists them
all. Needs a CUDA device."""

import itertools
import json
import subprocess
import sys
import time

root, tag = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tinychatengine_tpu_torch.ops import _build  # noqa: E402
from tinychatengine_tpu_torch.ops import int4_matmul as im  # noqa: E402
from tinychatengine_tpu_torch.ops.ref import dequantize_int4  # noqa: E402

# int4_matmul_fused cases: (model, linear, M, K, N, fused parts)
CASES = (
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
KOUTER_SHAPES = (("qkv", 4096, 6144), ("wo", 4096, 4096),
                 ("gate_up", 4096, 28672), ("down", 14336, 4096))
KOUTER_ROWS = (1, 16, 64, 496)

if not torch.cuda.is_available():
    sys.exit("compare_int4: no CUDA device")
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True,
                      text=True).stdout.strip()
print(tag, "CARD", card, flush=True)
t0 = time.perf_counter()
libs = _build.build_all(("int4_matmul_kouter", "int4_matmul_fused"))
print(tag, "build", round(time.perf_counter() - t0, 1), "s", flush=True)
for name, text in _build.BUILD_LOG.items():
    for line in text.splitlines():
        if "registers" in line or "spill" in line:
            print(tag, name, line.strip())
for lib, op in itertools.product(libs, ("HMMA", "HGMMA")):
    print(tag, lib, "SASS", op, cs.sass_count(libs[lib], op), flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator(device="cuda").manual_seed(0)
cases = []
add = cs.case_recorder(cases)
bn, bk = cs.KOUTER_BLOCKS
for (name, k, n), m in itertools.product(KOUTER_SHAPES, KOUTER_ROWS):
    packed, scales = cs.int4_stack(gen, k, n)
    nl = packed.shape[0]
    w_lib = dequantize_int4(packed[0], scales[0], 128, torch.bfloat16)
    x = torch.randn((m, k), device="cuda", generator=gen).to(torch.bfloat16)
    kw = dict(block_n=bn, block_k=bk)
    err = share = 0.0
    for li in (0, nl - 1):
        e, sh = cs.mat_err(
            im.int4_matmul_kouter(x, packed, scales, 128, layer_idx=li, **kw),
            im.int4_matmul_kouter_plain(x, packed, scales, 128, layer_idx=li,
                                        **kw))
        err, share = max(err, e), max(share, sh)
    state = {"li": 0}

    def run(x=x, packed=packed, scales=scales, nl=nl, kw=kw):
        state["li"] = (state["li"] + 1) % nl
        im.int4_matmul_kouter(x, packed, scales, 128, layer_idx=state["li"],
                              **kw)
    plain_ms = cs.time_ms(lambda: im.int4_matmul_kouter_plain(
        x, packed, scales, 128, layer_idx=0, **kw), 3)
    add("int4_matmul_kouter", f"{name} M={m} K={k} N={n} bn={bn} bk={bk}",
        err, share, f"{cs.MAT_TOL} * max|plain|", run, 50 if m == 1 else 20,
        plain_ms, lambda: torch.matmul(x, w_lib),
        m * k * 2 + k * n // 2 + (k // 128) * n * 2 + m * n * 2,
        2.0 * m * n * k, cs.BF16_FLOP_S, bands=k // bk)
    del packed, scales, w_lib
    torch.cuda.empty_cache()
cs.FUSED_CASES = CASES
cs.check_fused_kernels(gen, add)
if "--starcoder" in sys.argv:
    profiles = []
    by_kernel = cs.device_ms_by_kernel

    def recording(prof):
        profiles.append(by_kernel(prof))
        return profiles[-1]
    cs.device_ms_by_kernel = recording
    out = cs.serving_path("starcoder_15.5b", n_requests=16, n_predict=64,
                          fused=True)
    burst = out["paged"]["burst"]
    fused = {k: v / burst["ticks"] for k, v in profiles[-1].items()
             if "fused_" in k or "mma_band" in k}
    print(tag, "STARCODER", json.dumps(dict(
        tok_s_dense=out["dense"]["tok_s"], tok_s_paged=out["paged"]["tok_s"],
        tick_device_ms=burst.get("tick_device_ms"),
        fused_device_ms_per_tick=sum(fused.values()), fused_by_kernel=fused,
        fused_launches_per_tick=out["paged"]["launches"]["int4_matmul_fused"]
        / out["paged"]["decode_ticks"])), flush=True)
print(tag, "SUMMARY", json.dumps([
    {k: c.get(k) for k in ("kernel", "case", "ms", "library_ms", "bound_ms",
                           "plain_ms", "err_share")}
    for c in cases]))
