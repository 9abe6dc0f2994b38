"""Run one cell of ``BENCHMARK.json`` once, on the machine it starts on.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (kernels built or found in the checkout, weights made on the card
from the seed, every graph the traffic reaches captured, the mix's
pre-roll) runs first and is timed as ``setup_s``; then the window of
``--seconds``; then the window's requests drain, ``memory_peak_bytes`` is
read, the program's state is freed and the plain reference judges a sample
of what was served (``compare``). The last line of standard output is the
result; the last lines of standard error are the numbers compared, each
beside its limit. With ``--trace 1`` a slice after the window runs under
``torch.profiler`` (``perfbench/trace.py``) and the metrics are the
cell's per-layer ones. Exits 2 without enough CUDA devices, 3 when JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "tinychatengine_tpu")
OUT_DIR = ROOT / "build" / "perfbench"


def cache_env(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout;
    no library that would load JAX by itself is let do so."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(root / "build" / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (the whole name: ``tinychatengine_tpu_torch`` is not one)."""
    return sorted({n.split(".", 1)[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_info(device, chips: int) -> dict:
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}


def execute(bench: dict, cell: dict, seed: int, seconds: float, trace: bool,
            device, t_process: float, root: Path = None) -> tuple:
    """One run of ``cell``. Returns (result dict, checks)."""
    import torch

    from perfbench import compare, drivers, program, readers, spec
    from perfbench import trace as tracing
    from perfbench.record import Record
    from perfbench.model import model_from_config
    root = root or spec.HERE
    model = model_from_config(cell["config"],
                              spec.config(cell["config"], root), root)
    mix = spec.traffic(cell["traffic"], root)
    lim = spec.limits(cell["name"], root)
    drv = drivers.KINDS[mix["kind"]](model, mix, seed, device,
                                     spec.peaks(root))
    if mix["kind"] == "closed_loop":
        drv.setup(trace=trace)
    else:
        drv.setup()
    t_setup = time.perf_counter()
    rec = drv.run(seconds, trace, profile_s=mix.get("profile_s", 2.0))
    rec.setup_s = rec.t_open - t_process
    if trace and mix["kind"] == "closed_loop":
        rec.step_ms = drv.pair_step_ms()
    dev = device_info(device, cell["chips"])
    counts = program.launches()
    drv.finish()
    samples = drv.sample(mix["check"])
    mismatch = drv.mismatch
    drv.free()
    if trace:
        rec.trace = tracing.summarize(drv.profile.events(), rec.profiled_s,
                                      spec.kernel_classes(root))
        drv.profile = None
        # the profiler's cost on the host clock: tick_ms.tpot's reading of
        # the traced slice's calls, beside the window's
        rec.notes["traced_tick_ms"] = readers.ms_per_tick(
            Record(calls=rec.traced_calls), readers.decode_only)
    t_ref = time.perf_counter()
    read = compare.readings(model, samples, seed, device)
    read["lower_launches"] = compare.lower_launches(counts,
                                                    lim["lower_kernels"])
    rec.notes["phases_s"] = dict(
        setup_to_traffic=t_setup - t_process, preroll=rec.t_open - t_setup,
        window=rec.window_s, drain=rec.notes.get("drain_s"),
        reduce=t_ref - rec.t_close, reference=time.perf_counter() - t_ref)
    attempted = len(rec.requests)
    failed = sum(1 for r in rec.requests
                 if r.done == 0.0 or r.emitted != r.n_out)
    correct, checks = compare.judge(read, lim, attempted, failed)

    metrics = {}
    for m in spec.cell_metrics(bench, cell["name"], trace):
        v = spec.reader(m["name"], root)(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if trace and rec.trace is not None:
        result["device"]["busy_s"] = rec.trace.busy_s
        result["device"]["window_s"] = rec.trace.window_s
        result["breakdown"] = {"device_ops": rec.trace.device_ops,
                               "idle_gaps": rec.trace.idle_gaps}
    result["checks"] = checks
    notes = dict(rec.notes, work_mismatch=mismatch, readings=read,
                 launches={k: v for k, v in counts.items() if v},
                 window_s=rec.window_s, tokens=rec.tokens)
    _write_notes(cell["name"], seed, trace, notes)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return result, checks


def _write_notes(cell: str, seed: int, trace: bool, notes: dict) -> None:
    """The run's side numbers (how late the generator ran, captures inside
    the window, the readings) to a line on stderr and a file."""
    line = json.dumps(notes, default=str)
    print(f"notes {line}", file=sys.stderr)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    with open(OUT_DIR / f"{cell}-{seed}-{int(trace)}.json", "w") as f:
        f.write(line + "\n")


def main(argv=None) -> int:
    args = parse(argv)
    cache_env()
    import torch
    torch.set_num_threads(4)

    from perfbench import spec
    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, checks = execute(bench, cell, args.seed, args.seconds,
                             bool(args.trace), "cuda", T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
