"""Find an open-loop cell's knee: the highest offered rate with no growing
backlog. One process sets the cell up once and serves the mix at each
rate in turn (pre-roll, window, a short drain), printing per rate the
requests counted, the queue at the window's opening and close, TTFT p50 /
p95 over the window's first and second halves, TPOT p95 and tokens/s.

    python3 perfbench/sweep.py --workload <cell> --seed <n> \
        --rates 4,6,8 --seconds 20
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
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--drain", type=float, default=20.0)
    args = p.parse_args(argv)

    from perfbench import drivers, readers, run, spec
    from perfbench.model import model_from_config
    run.cache_env()
    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    mix = dict(spec.traffic(cell["traffic"]), drain_limit_s=args.drain)
    model = model_from_config(cell["config"], spec.config(cell["config"]))
    drv = drivers.OpenLoop(model, mix, args.seed, "cuda", spec.peaks())
    t0 = time.perf_counter()
    drv.setup()
    print(f"setup {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    for rate in (float(r) for r in args.rates.split(",")):
        rec = drv.run(args.seconds, False, rate=rate)
        drv.finish()
        reqs = sorted(rec.requests, key=lambda r: r.due)
        half = len(reqs) // 2

        def ttft(rs, q):
            rec.requests = rs
            return readers.ttft_ms(rec, q)
        row = dict(
            rate=rate, requests=len(reqs),
            unfinished=sum(1 for r in reqs if not r.done),
            queue_open=rec.notes["queue_open"],
            queue_close=rec.notes["queue_close"],
            ttft_p50_first=ttft(reqs[:half], 50),
            ttft_p50_second=ttft(reqs[half:], 50),
            ttft_p95=ttft(reqs, 95), tpot_p95=readers.tpot_ms(rec, 95),
            tok_s=rec.tokens / rec.window_s, drain_s=rec.notes["drain_s"],
            late_max=rec.notes["late_s"]["max"])
        print("sweep " + json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
