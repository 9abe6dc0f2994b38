#!/usr/bin/env python3
"""Where a timed decode step's time goes beyond its graph's replay, on one
NVIDIA GPU: llama3_8b W4A8 (random packed weights from seed 0 at full
width, max_len 2048) through ``Engine.generate_device`` on its captured
CUDA graphs, greedy with repeat_penalty 1.1 over the last 64 tokens (the
settings of ``chip_smoke.py`` phase 4 and ``scripts/bench_torch.py``).

For each prompt (``chip_smoke.py``'s fixed 64-token prompt, then
``bench_torch.py``'s fresh ones) and each of 3 trials, a 1-token and a
257-token run, timed by the host's clock and by CUDA events recorded on
the stream around each call. Then the decode step's graph alone: 16 and
256 back-to-back replays (CUDA events), the second also from the timed
run's first position. ``nvidia-smi`` samples the SM and memory clocks and
the power draw every 100 ms throughout. Prints ONE JSON line: ms a step
for each reading, the trials, and the clock samples of each phase (min,
median, max).

Run from the root of a checkout: ``python3 scripts/decode_gap.py``.
Exits 2 without a card.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

N = 256  # decode steps a long run takes beyond the 1-token run
SMI = ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw",
       "--format=csv,noheader,nounits", "-lms", "100"]


class Clocks:
    """nvidia-smi's samples while open: [(sm MHz, mem MHz, W)]."""

    def __enter__(self):
        self.proc = subprocess.Popen(SMI, stdout=subprocess.PIPE,
                                     stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=10)
        rows = [line.split(",") for line in out.splitlines()]
        self.samples = [tuple(float(x) for x in r) for r in rows
                        if len(r) == 3]

    def summary(self) -> dict:
        if not self.samples:
            return {"samples": 0}
        cols = np.asarray(self.samples)
        return {"samples": len(cols), **{
            name: [float(cols[:, i].min()), float(np.median(cols[:, i])),
                   float(cols[:, i].max())]
            for i, name in enumerate(("sm_mhz", "mem_mhz", "power_w"))}}


def main() -> int:
    if not torch.cuda.is_available():
        print(json.dumps({"error": "no CUDA device"}))
        return 2
    from tinychatengine_tpu_torch.core.config import (GenerationConfig,
                                                      QuantConfig,
                                                      get_model_config)
    from tinychatengine_tpu_torch.generation.engine import Engine
    from tinychatengine_tpu_torch.models import llama

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"device: {smi}", file=sys.stderr)
    cfg = get_model_config("llama3_8b")
    qcfg = QuantConfig(scheme="w4a8", group_size=128)
    params = llama.init_random_params(cfg, qcfg, seed=0, max_pos=2048,
                                      fast=True, device="cuda")
    eng = Engine(params, cfg, qcfg, batch=1, max_len=2048, device="cuda")
    g = GenerationConfig(temp=0.0, n_predict=128, repeat_penalty=1.1,
                         repeat_last_n=64)
    fixed = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 64))

    def call(ids, n):
        """(host s, event s) of one generate_device call and its fetch."""
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t = time.perf_counter()
        e0.record()
        eng.generate_device(ids, g, n_tokens=n).cpu()
        e1.record()
        torch.cuda.synchronize()
        return time.perf_counter() - t, e0.elapsed_time(e1) / 1e3

    call(fixed, 2)  # the captures
    out, phases = {"device": smi}, {}
    for name, prompt in (("fixed", lambda trial: fixed),
                         ("fresh", lambda trial: np.random.default_rng(
                             20 + trial).integers(100, cfg.vocab_size - 100,
                                                  (1, 64)))):
        with Clocks() as clk:
            runs = [(call(prompt(t), 1), call(prompt(t), 1 + N))
                    for t in range(3)]
        phases[name] = clk.summary()
        host = [(b[0] - a[0]) * 1e3 / N for a, b in runs]
        event = [(b[1] - a[1]) * 1e3 / N for a, b in runs]
        out[name] = {
            "host_ms_per_step": float(np.median(host)),
            "event_ms_per_step": float(np.median(event)),
            "host_trials": host, "event_trials": event}

    step = next(st for key, st in reversed(eng.graphs.steps.items())
                if key[0] == "decode")

    def replays(n, from_start):
        if from_start:  # the timed run's positions: decode from 64
            step.state.pos.fill_(64)
            step.state.index.zero_()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        e0.record()
        for _ in range(n):
            step.replay()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / n

    with torch.inference_mode(), Clocks() as clk:
        out["replay_16_ms"] = replays(16, False)
        out["replay_256_ms"] = replays(N, True)
        out["replay_256_again_ms"] = replays(N, True)
    phases["replays"] = clk.summary()
    out["clocks"] = phases
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
