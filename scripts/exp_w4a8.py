"""Sweep the K splits of the W4A8 kernel and the fused MLP on the card:
times ``int4_matmul_a8`` (CUDA-graph replay, ``chip_smoke.graph_ms``) at
llama3_8b's five shapes and M = 1, 8 and 64 for each band target given
(``ops/int4_matmul.py _A8_TARGET_BLOCKS``, which ``a8_split`` reads at call
time) and splits one call's device time between the quantize and the
contraction kernels (torch.profiler); then ``mlp_fused`` at llama3_8b's MLP
at M = 1 and 16 for each of its targets (``ops/mlp_fused.py
_MLP_TARGET_ITEMS``). Run from the root of a checkout:

    python3 scripts/exp_w4a8.py [a8=T,T,...] [mlp=T,T,...]

(defaults: a8=264,528,1056, no mlp sweep). Prints the card's name and
power limit, then one JSON line per (target, case). Needs a CUDA device."""

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tinychatengine_tpu_torch.ops import int4_matmul as im  # noqa: E402
from tinychatengine_tpu_torch.ops import mlp_fused as mf  # noqa: E402
from tinychatengine_tpu_torch.ops.linear import Int4Linear  # noqa: E402

SHAPES = (("qkv", 4096, 6144), ("wo", 4096, 4096), ("gate_up", 4096, 28672),
          ("down", 14336, 4096), ("lm_head", 4096, 129024))
ROWS = (1, 8, 64)


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("exp_w4a8: no CUDA device")
    opts = dict(a.split("=") for a in sys.argv[1:])
    targets = [int(t) for t in opts.get("a8", "264,528,1056").split(",") if t]
    mlp_targets = [int(t) for t in opts.get("mlp", "").split(",") if t]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    default = im._A8_TARGET_BLOCKS
    for name, k, n in SHAPES:
        packed, scales = cs.int4_stack(gen, k, n)
        nl = packed.shape[0]
        for m in ROWS:
            x = torch.randn((m, k), device="cuda", generator=gen).to(
                torch.bfloat16)
            state = {"li": 0}

            def run():
                state["li"] = (state["li"] + 1) % nl
                im.int4_matmul_a8(x, packed, scales, 128,
                                  layer_idx=state["li"])
            for target in targets:
                im._A8_TARGET_BLOCKS = target
                print(json.dumps(dict(
                    target=target, case=f"{name} M={m}",
                    split=im.a8_split(k, n), ms=cs.graph_ms(run, 50))),
                    flush=True)
            im._A8_TARGET_BLOCKS = default
            from torch.profiler import ProfilerActivity, profile
            run()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    run()
                torch.cuda.synchronize()
            by = {k2: v / 20 for k2, v in cs.device_ms_by_kernel(prof).items()}
            print(json.dumps(dict(case=f"{name} M={m}", target=default,
                                  device_ms_by_kernel=by)), flush=True)
        del packed, scales
        torch.cuda.empty_cache()
    if mlp_targets:
        e, f = 4096, 14336
        gu = Int4Linear(*cs.int4_stack(gen, e, 2 * f, n_layers=3))
        dn = Int4Linear(*cs.int4_stack(gen, f, e, n_layers=3))
        default = mf._MLP_TARGET_ITEMS
        for m in (1, 16):
            x = (torch.randn((m, e), device="cuda", generator=gen) * 0.5).to(
                torch.bfloat16)
            state = {"li": 0}

            def run():
                state["li"] = (state["li"] + 1) % 3
                mf.mlp_fused(x, gu, dn, state["li"])
            for target in mlp_targets:
                mf._MLP_TARGET_ITEMS = target
                print(json.dumps(dict(
                    target=target, case=f"mlp_fused M={m}",
                    split=[mf.mlp_split(m, 2 * f, e), mf.mlp_split(m, e, f)],
                    ms=cs.graph_ms(run, 20))), flush=True)
            mf._MLP_TARGET_ITEMS = default
    return 0


if __name__ == "__main__":
    sys.exit(main())
