"""A copy of the benchmark with three tiny cells added by new files and
BENCHMARK.json entries alone (the way a later change adds a cell), one per
cell of the real benchmark: the same families, mixes and limits' shape, at
widths the CPU runs in seconds."""

import json
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH_DIR = HERE.parent
REPO = BENCH_DIR.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_CONFIGS = {
    "tiny_llama": ("mistral_7b-w4a8", dict(
        hidden_size=256, intermediate_size=512, num_attention_heads=4,
        num_key_value_heads=2, num_hidden_layers=2, vocab_size=512,
        max_position_embeddings=1024, sliding_window=96)),
    "tiny_starcoder": ("starcoder_15.5b-w4a16", dict(
        n_embd=256, n_inner=512, n_head=4, n_layer=2, vocab_size=512,
        n_positions=1024)),
}
# tiny cell -> (its config, its mix, the real cell it stands for, rate)
TINY_CELLS = {
    "tiny_llama.chat": ("tiny_llama", "chat", "mistral_7b-w4a8.chat", 10.0),
    "tiny_starcoder.complete": ("tiny_starcoder", "complete",
                                "starcoder_15.5b-w4a16.complete", 5.0),
    "tiny_llama.solo": ("tiny_llama", "solo", "mistral_7b-w4a8.solo", None),
}


def _write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1) + "\n")


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """(repo root of the copy, its perfbench dir)."""
    repo = tmp_path_factory.mktemp("bench")
    root = repo / "perfbench"
    shutil.copytree(BENCH_DIR, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, (base, over) in TINY_CONFIGS.items():
        c = json.loads((root / "configs" / f"{base}.json").read_text())
        # at 256 wide, the full size's scale leaves attention nearly
        # uniform, and a lost key barely moves it
        c["assumed"] = dict(c["assumed"], weight_std=0.03)
        _write(root / "configs" / f"{name}.json", dict(c, **over))
    for cell, (cfg, mix, real, rate) in TINY_CELLS.items():
        t = json.loads((root / "traffic" / f"{mix}.json").read_text())
        t["server"]["max_len"] = 512
        if t["kind"] == "open_loop":
            t["server"].update(slots=4, admission_chunk=64, tick_batch=4)
            t.update(rate_rps=rate, preroll_s=0.3, drain_limit_s=30)
        t["prompt"].update(median=40, min=8, max=200)
        t["output"].update(median=16, min=4, max=40)
        t["check"]["tokens"] = 60
        t["profile_s"] = 0.5
        _write(root / "traffic" / f"tiny_{cell}.json", t)
        real_lim = json.loads((root / "limits" / f"{real}.json").read_text())
        _write(root / "limits" / f"{cell}.json",
               {"compare": {"gap": {"limit": 0.03},
                            "lower_launches": {"limit": 0}},
                "lower_kernels": real_lim["lower_kernels"],
                "compared_tokens_min": 10})
        bench["workloads"].append({"name": cell, "config": cfg,
                                   "traffic": f"tiny_{cell}", "chips": 1,
                                   "why": f"CPU stand-in for {real}"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real in m.get("workloads", []):
                m["workloads"].append(cell)
    _write(repo / "BENCHMARK.json", bench)
    return repo, root
