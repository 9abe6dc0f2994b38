"""The readings a cell's limits are set from, on the card at the cell's
own size: the program's numbers (``compare.NUMBERS``) over many seeds (the
lower readings) and the controls' over the first few (the upper ones). A
control is the reference with precisions lowered (the limits file's
``controls``, and ``--steps``), or the program itself on one of its own
lower-precision paths (``--variant``: every seed then reads the variant).
One process sets the cell up once and for each seed makes new weights in
the same buffers, serves a window of the mix at its own load, drains it,
and compares a sample as a run does.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        --control 3 --seconds 12 [--variant '{"kv_cache_dtype": "int8"}']
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3,
                   help="how many of the seeds also read the control")
    p.add_argument("--seconds", type=float, default=12.0)
    p.add_argument("--steps", default=None,
                   help='JSON {name: {"linear": {"int8": "int4"}, ...}}: '
                        "controls to read besides the limits file's")
    p.add_argument("--device", default="cuda")
    p.add_argument("--variant", default=None,
                   help='JSON {"scheme": "w4a8"} or {"kv_cache_dtype": '
                        '"int8"}: the program runs so')
    args = p.parse_args(argv)

    from perfbench import compare, drivers, program, run, spec
    from perfbench.model import model_from_config
    run.cache_env()
    cell = spec.workload(spec.benchmark(), args.workload)
    lim = spec.limits(cell["name"])
    controls = {**lim.get("controls", {}),
                **json.loads(args.steps or "{}")}
    mix = spec.traffic(cell["traffic"])
    model = model_from_config(cell["config"], spec.config(cell["config"]))
    seeds = [int(s) for s in args.seeds.split(",")]
    variant = json.loads(args.variant or "{}")
    drv = drivers.KINDS[mix["kind"]](model, mix, seeds[0], args.device,
                                     spec.peaks(), variant)
    drv.setup()
    for i, seed in enumerate(seeds):
        drv.reseed(seed)
        t0 = time.perf_counter()
        before = program.launches()
        rec = drv.run(args.seconds, False)
        after = program.launches()
        drv.finish()
        samples = drv.sample(mix["check"])
        read = compare.readings(model, samples, seed, args.device,
                                controls if i < args.control else None)
        failed = sum(1 for r in rec.requests
                     if r.done == 0.0 or r.emitted != r.n_out)
        # this seed's serving, and the whole process's so far
        read["lower_launches"] = compare.lower_launches(
            {k: after[k] - before[k] for k in after}, lim["lower_kernels"])
        read["lower_launches_process"] = compare.lower_launches(
            after, lim["lower_kernels"])
        print("reading " + json.dumps(dict(
            seed=seed, variant=variant, failed=failed,
            attempted=len(rec.requests),
            batched=sum(s["batched"] for s in samples),
            slots=len({s["slot"] for s in samples}),
            seconds=time.perf_counter() - t0, **read,
            launches={k: v for k, v in after.items() if v})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
