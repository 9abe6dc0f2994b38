"""Time the PyTorch/CUDA port's flash_prefill and int8_decode kernels of
one checkout on the card, against their plain versions and SDPA, so two
checkouts (say a parent commit unpacked beside the current tree) can be
compared in one run on one card:

    python3 scripts/compare_attention.py PATH/TO/CHECKOUT TAG [--opt]

It imports ``chip_smoke`` and ``tinychatengine_tpu_torch`` from the given
checkout, prints the card's name and power limit, builds the two kernels,
runs flash_prefill at llama3_8b's widths (B = 1, Hq 32, Hkv 8, D 128, a
32-layer cache cycled) for a 2048-token prompt, 64 rows over a 1984-key
prefix and 100 rows at start 37, bf16 and int8 KV, then the checkout's own
``chip_smoke.check_int8_kernels``, ``int8_decode`` at opt_6.7b's serving
tick (8 short rows in a 2048-key cache), ``check_int8_kv_kernels`` (and
``check_prefill_cases`` where it has them), and with ``--opt`` the OPT
W8A8 main path (``chip_smoke.main_path("opt_6.7b")``). Each case is one
JSON line (``chip_smoke.case_recorder``); the last line, ``TAG SUMMARY``,
lists them all. Needs a CUDA device."""

import json
import subprocess
import sys
import time

root, tag = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tinychatengine_tpu_torch.ops import _build  # noqa: E402
from tinychatengine_tpu_torch.ops import attention as att  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("compare_attention: no CUDA device")
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True,
                      text=True).stdout.strip()
print(tag, "CARD", card, flush=True)
t0 = time.perf_counter()
libs = _build.build_all(("flash_prefill", "int8_decode"))
print(tag, "build", round(time.perf_counter() - t0, 1), "s", flush=True)
for name, text in _build.BUILD_LOG.items():
    for line in text.splitlines():
        if "registers" in line or "spill" in line:
            print(tag, name, line.strip())
for op in ("HMMA", "HGMMA"):
    print(tag, "flash_prefill SASS", op,
          cs.sass_count(libs["flash_prefill"], op))
torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator(device="cuda").manual_seed(0)
cases = []
add = cs.case_recorder(cases)
dev = torch.device("cuda")
sdpa = torch.nn.functional.scaled_dot_product_attention
L, hq, hkv, d, S = 32, 32, 8, 128, 2048
for int8 in (False, True):
    if int8:
        k, ks = cs.int8_kv((L, 1, hkv, S, d), gen)
        v, vs = cs.int8_kv((L, 1, hkv, S, d), gen)
    else:
        k, v = (torch.randn((L, 1, hkv, S, d), device=dev,
                            generator=gen).to(torch.bfloat16)
                for _ in range(2))
        ks = vs = None
    for s, start in ((2048, 0), (64, S - 64), (100, 37)):
        length = start + s
        q = torch.randn((1, s, hq, d), device=dev,
                        generator=gen).to(torch.bfloat16)
        err = share = 0.0
        for li in (0, L - 1):
            y = att.flash_prefill(q, k, v, li, start, length, ks, vs)
            assert not torch.isnan(y).any()
            e, sh = cs.attn_err(y, att.flash_prefill_plain(
                q, k, v, li, start, length, ks, vs), d)
            err, share = max(err, e), max(share, sh)
        state = {"li": 0}

        def run(q=q, start=start, length=length):
            state["li"] = (state["li"] + 1) % L
            att.flash_prefill(q, k, v, state["li"], start, length, ks, vs)
        plain_ms = cs.time_ms(lambda q=q, start=start, length=length:
                              att.flash_prefill_plain(q, k, v, 0, start,
                                                      length, ks, vs), 3)
        kd, vd = k[0, :, :, :length], v[0, :, :, :length]
        if int8:
            kd = cs.dequant(kd, ks[0, :, :, :length])
            vd = cs.dequant(vd, vs[0, :, :, :length])
        qt = q.transpose(1, 2)
        mask = (torch.arange(length, device=dev)[None, :]
                <= start + torch.arange(s, device=dev)[:, None])
        pairs = sum(min(start + r + 1, length) for r in range(s))
        causal = None
        if start == 0:
            causal = cs.graph_ms(lambda: sdpa(qt, kd, vd, is_causal=True,
                                              enable_gqa=True), 5)
        add("flash_prefill_int8" if int8 else "flash_prefill",
            f"B=1 S={s} start={start} Hq={hq} Hkv={hkv} D={d}", err, share,
            cs.ATTN_TOL_TEXT, run, 5 if s == 2048 else 50, plain_ms,
            lambda: sdpa(qt, kd, vd, attn_mask=mask, enable_gqa=True),
            2 * s * hq * d * 2 + 2 * hkv * length * (d + 4 if int8 else 2 * d),
            4.0 * hq * pairs * d, cs.BF16_FLOP_S,
            library_causal_ms=causal)
    del k, v
    torch.cuda.empty_cache()
cs.check_int8_kernels(gen, add)
# int8_decode at opt_6.7b's serving tick (phase 8): 8 slots holding the
# mix's first 8 prompts (serving_load's draws) 32 tokens into their decode,
# in the 2048-key slot cache
rng = np.random.default_rng(0)
tick = []
for _ in range(8):
    n = int(rng.integers(32, 320))
    rng.integers(100, 50272 - 100, n)
    tick.append(n + 32)
n_layers, h, d, smax = 32, 32, 128, 2048
ck, cv = (torch.randint(-127, 128, (n_layers, 8, h, smax, d), dtype=torch.int8,
                        device=dev, generator=gen) for _ in range(2))
q8 = torch.randint(-127, 128, (8, h, d), dtype=torch.int8, device=dev,
                   generator=gen)
lens = torch.tensor(tick, dtype=torch.int32, device=dev)
e, pairs, share = cs.int8_err(
    att.int8_decode(q8, ck, cv, 0, lens, 3e-5, 1e-3),
    att.int8_decode_plain(q8, ck, cv, 0, lens, 3e-5, 1e-3), 1e-3)
state = {"li": 0}


def tick_run():
    state["li"] = (state["li"] + 1) % n_layers
    att.int8_decode(q8, ck, cv, state["li"], lens, 3e-5, 1e-3)
mask = (torch.arange(smax, device=dev)[None] < lens[:, None])[:, None, None]
qb, kb, vb = q8.to(torch.bfloat16)[:, :, None], ck[0].to(torch.bfloat16), \
    cv[0].to(torch.bfloat16)
add("int8_decode", f"B=8 H={h} D={d} S={smax} serving tick "
    f"{min(tick)}..{max(tick)}", e, share, cs.INT8_TOL_TEXT, tick_run, 64,
    cs.time_ms(lambda: att.int8_decode_plain(q8, ck, cv, 0, lens, 3e-5,
                                             1e-3), 10),
    lambda: torch.nn.functional.scaled_dot_product_attention(
        qb, kb, vb, attn_mask=mask, scale=3e-5),
    2 * h * sum(tick) * d + 5 * 8 * h * d + 32, 4.0 * h * sum(tick) * d,
    cs.INT8_OP_S, differing_pairs=pairs)
del ck, cv, kb, vb
torch.cuda.empty_cache()
if hasattr(cs, "check_prefill_cases"):
    cs.check_prefill_cases(gen, add)
cs.check_int8_kv_kernels(gen, add)
if "--opt" in sys.argv:
    m = cs.main_path("opt_6.7b", n_predict=128)[2]
    print(tag, "OPT", json.dumps({k: m.get(k) for k in (
        "decode_tok_s", "decode_device_ms_per_step", "decode_busy_share")}),
        flush=True)
print(tag, "SUMMARY", json.dumps([
    {k: c.get(k) for k in ("kernel", "case", "ms", "library_ms",
                           "library_causal_ms", "bound_ms", "err_share")}
    for c in cases]))
