"""Time the PyTorch/CUDA port's GLU down projection (``int4_matmul_glu``)
and W3 matmul (``int3_matmul``) of one checkout on the card, against their
plain versions, one PyTorch call and their bounds, so two checkouts (say a
parent commit unpacked beside the current tree) can be compared in one run
on one card:

    python3 scripts/compare_glu_int3.py PATH/TO/CHECKOUT TAG [--profile]
        [--bits FILE] [--set MODULE.NAME=INT ...] [--rows 1,8,64]

It imports ``chip_smoke`` and ``tinychatengine_tpu_torch`` from the given
checkout, prints the card's name and power limit, builds the two kernels'
libraries (printing their register use and the HMMA / HGMMA count of their
SASS), then times ``int4_matmul_glu`` at llama3_8b's down from gu (F 14336,
N 4096) and ``int3_matmul`` at llama3_8b's gate_up (K 4096, N 28672) and
down (K 14336, N 4096) widths with f32 scales, each at M = 1, 8 and 64
(``ROWS``), over layer stacks a timing loop cycles through
(``chip_smoke.case_recorder``: CUDA-graph replay, the plain version, the
library call, the bound). ``--profile`` also prints each GLU case's device
time by kernel (torch.profiler over 20 calls), beside ``int4_matmul`` on
the activation made in advance at the same shape (the split between making
the activation and the product). ``--bits FILE`` saves, for fixed seeded
inputs, the outputs of the kernels that share code with these two
(``int4_matmul``'s band route at M = 1 and 8, ``int4_matmul_kouter`` and
``int4_matmul_fused`` at the shapes ``scripts/compare_int4.py`` times,
``mlp_fused`` at M = 1 and 16) to FILE with ``torch.save``: two
checkouts' files compare bit for bit.
``--set im._GLU_TARGET_BLOCKS=528`` (module ``im`` is
``ops/int4_matmul.py``, ``i3`` ``ops/int3_matmul.py``) sets a split
target before the cases run, for sweeps; ``--rows`` replaces ``ROWS``.
Each case is one JSON line; the
last line, ``TAG SUMMARY``, lists them all. Needs a CUDA device."""

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
from tinychatengine_tpu_torch.ops import int3_matmul as i3  # noqa: E402
from tinychatengine_tpu_torch.ops import int4_matmul as im  # noqa: E402
from tinychatengine_tpu_torch.ops.ref import dequantize_int4  # noqa: E402

ROWS = (1, 8, 64)
INT3_SHAPES = (("gate_up", 4096, 28672), ("down", 14336, 4096))
for i, arg in enumerate(sys.argv):
    if arg == "--rows":
        ROWS = tuple(int(v) for v in sys.argv[i + 1].split(","))
    if arg == "--set":
        target, value = sys.argv[i + 1].split("=")
        mod, attr = target.split(".")
        setattr({"im": im, "i3": i3}[mod], attr, int(value))
        print(tag, "SET", target, value, flush=True)

if not torch.cuda.is_available():
    sys.exit("compare_glu_int3: no CUDA device")
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True,
                      text=True).stdout.strip()
print(tag, "CARD", card, flush=True)
t0 = time.perf_counter()
libs = _build.build_all(("int4_matmul_glu", "int3_matmul", "int4_matmul",
                         "int4_matmul_fused", "mlp_fused"))
print(tag, "build", round(time.perf_counter() - t0, 1), "s", flush=True)
for name, text in _build.BUILD_LOG.items():
    for line in text.splitlines():
        if ("registers" in line or "spill" in line) and name in (
                "int4_matmul_kouter", "int3_matmul"):
            print(tag, name, line.strip())
for lib, op in itertools.product(("int4_matmul_kouter", "int3_matmul"),
                                 ("HMMA", "HGMMA")):
    print(tag, lib, "SASS", op, cs.sass_count(libs[lib], op), flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
silu = torch.nn.functional.silu
dev = torch.device("cuda")
cases = []
add = cs.case_recorder(cases)


def cycle(n_layers, call):
    state = {"li": 0}

    def run():
        state["li"] = (state["li"] + 1) % n_layers
        call(state["li"])
    return run


def profile(fn, n=20) -> dict:
    """Device ms per call by kernel over ``n`` calls."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {k: round(v / n, 5)
            for k, v in cs.device_ms_by_kernel(prof).items()}


def bits(path):
    """Seeded outputs of the kernels that share code with these two:
    ``int4_matmul``'s band route (M = 1, 8), ``int4_matmul_kouter`` and
    ``int4_matmul_fused`` (with an RMSNorm) at compare_int4.py's shapes,
    ``mlp_fused`` at M = 1 and 16."""
    from tinychatengine_tpu_torch.ops import mlp_fused as mf
    from tinychatengine_tpu_torch.ops.linear import Int4Linear
    g = torch.Generator(device="cuda").manual_seed(1)
    out = {}

    def rand_x(m, k):
        return torch.randn((m, k), device=dev, generator=g).to(torch.bfloat16)
    packed, scales = cs.int4_stack(g, 4096, 6144, n_layers=2)
    for m in (1, 8):
        out[f"band M={m}"] = im.int4_matmul(rand_x(m, 4096), packed, scales,
                                            128, layer_idx=1)
    for (name, k, n), m in itertools.product(
            (("qkv", 4096, 6144), ("wo", 4096, 4096),
             ("gate_up", 4096, 28672), ("down", 14336, 4096)),
            (1, 16, 64, 496)):
        packed, scales = cs.int4_stack(g, k, n, n_layers=1)
        out[f"kouter {name} M={m}"] = im.int4_matmul_kouter(
            rand_x(m, k), packed, scales, 128, layer_idx=0, block_n=2048,
            block_k=1024)
    for m, k, n in ((1, 4096, 6144), (1, 4096, 28672), (1, 14336, 4096),
                    (1, 4096, 129024), (1, 6144, 6400), (1, 24576, 6144),
                    (8, 6144, 6400), (8, 6144, 6144), (8, 6144, 24576),
                    (8, 24576, 6144), (8, 6144, 49152), (8, 4096, 28672)):
        packed, scales = cs.int4_stack(g, k, n, n_layers=1)
        nw = torch.rand((1, k), device=dev, generator=g) + 0.5
        out[f"fused M={m} K={k} N={n}"] = im.int4_matmul_fused(
            rand_x(m, k), packed, scales, 128, layer_idx=0, norm_w=nw)
    wgu, sgu = cs.int4_stack(g, 4096, 2 * 14336, n_layers=1)
    wdn, sdn = cs.int4_stack(g, 14336, 4096, n_layers=1)
    for m in (1, 16):
        out[f"mlp_fused M={m}"] = mf.mlp_fused(
            (rand_x(m, 4096).float() * 0.5).to(torch.bfloat16),
            Int4Linear(wgu, sgu), Int4Linear(wdn, sdn), 0)
    torch.cuda.synchronize()
    torch.save({k: v.cpu() for k, v in out.items()}, path)
    print(tag, "BITS saved", path, len(out), "outputs", flush=True)


# ---- int4_matmul_glu: llama3_8b's down from gu
f, n = 14336, 4096
packed, scales = cs.int4_stack(torch.Generator(device="cuda").manual_seed(0),
                               f, n)
gen = torch.Generator(device="cuda").manual_seed(0)
nl = packed.shape[0]
w_lib = dequantize_int4(packed[0], scales[0], 128, torch.bfloat16)
for m in ROWS:
    gu = torch.randn((m, 2 * f), device=dev, generator=gen).to(torch.bfloat16)
    err = share = 0.0
    for li in (0, nl - 1):
        e, sh = cs.mat_err(
            im.int4_matmul_glu(gu, packed, scales, 128, layer_idx=li),
            im.int4_matmul_glu_plain(gu, packed, scales, 128, layer_idx=li))
        err, share = max(err, e), max(share, sh)
    plain_ms = cs.time_ms(lambda: im.int4_matmul_glu_plain(
        gu, packed, scales, 128, layer_idx=0), 3)
    add("int4_matmul_glu", f"down M={m} F={f} N={n}", err, share,
        f"{cs.MAT_TOL} * max|plain|",
        cycle(nl, lambda li: im.int4_matmul_glu(gu, packed, scales, 128,
                                                layer_idx=li)),
        50, plain_ms,
        lambda: torch.matmul(silu(gu[:, :f]) * gu[:, f:], w_lib),
        m * 2 * f * 2 + f * n // 2 + (f // 128) * n * 2 + m * n * 2,
        2.0 * m * n * f, cs.BF16_FLOP_S)
    if "--profile" in sys.argv:
        act = (silu(gu[:, :f].float()) * gu[:, f:].float()).to(torch.bfloat16)
        print(tag, "PROFILE", json.dumps(dict(
            case=f"down M={m}",
            glu=profile(lambda: im.int4_matmul_glu(gu, packed, scales, 128,
                                                   layer_idx=1)),
            int4_matmul_on_act=profile(lambda: im.int4_matmul(
                act, packed, scales, 128, layer_idx=1)))), flush=True)
del packed, scales, w_lib
torch.cuda.empty_cache()

# ---- int3_matmul: llama3_8b's gate_up and down widths, f32 scales
for (name, k, n), m in itertools.product(INT3_SHAPES, ROWS):
    nl = max(2, -(-200_000_000 // (k * n * 3 // 8)))
    layers = [(torch.randint(0, 256, (k // 4, n), dtype=torch.uint8,
                             device=dev, generator=gen),
               torch.randint(0, 256, (k // 8, n), dtype=torch.uint8,
                             device=dev, generator=gen),
               (torch.rand((k // 128, n), device=dev, generator=gen)
                + 0.5) * 0.01) for _ in range(nl)]
    w_lib = cs.int3_dequant(*layers[0])
    x = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
    err = share = 0.0
    for li in (0, nl - 1):
        e, sh = cs.mat_err(i3.int3_matmul(x, *layers[li]),
                           i3.int3_matmul_plain(x, *layers[li]))
        err, share = max(err, e), max(share, sh)
    plain_ms = cs.time_ms(lambda: i3.int3_matmul_plain(x, *layers[0]), 3)
    add("int3_matmul", f"{name} M={m} K={k} N={n}", err, share,
        f"{cs.MAT_TOL} * max|plain|",
        cycle(nl, lambda li: i3.int3_matmul(x, *layers[li])), 50, plain_ms,
        lambda: torch.matmul(x, w_lib),
        k * n * 3 // 8 + (k // 128) * n * 4 + m * k * 2 + m * n * 2,
        2.0 * m * n * k, cs.BF16_FLOP_S)
    del layers, w_lib
    torch.cuda.empty_cache()

if "--bits" in sys.argv:
    bits(sys.argv[sys.argv.index("--bits") + 1])
print(tag, "SUMMARY", json.dumps([
    {k: c.get(k) for k in ("kernel", "case", "ms", "library_ms", "bound_ms",
                           "plain_ms", "err_share")}
    for c in cases]))
