"""Model zoo: download + convert registry (counterpart of the JAX package's
``tools/zoo.py``).

Equivalent of the reference's ``llm/tools/download_model.py`` (model-id →
artifact URL + md5 table, :22-254; fetch/verify/unzip :257-344). Differences:

- sources are HuggingFace checkpoint repos (the reference zoo ships
  pre-reordered QM_x86/QM_ARM/... zips; our packing happens at conversion
  time into the one QM_TPU layout, so the zoo maps to ORIGINAL checkpoints);
- download via huggingface_hub when the environment has network access;
  everything degrades to clear errors offline (`ensure_model` also accepts a
  pre-downloaded local directory).

    python -m tinychatengine_tpu_torch.tools.zoo --list
    python -m tinychatengine_tpu_torch.tools.zoo --model LLaMA_3_8B_Instruct \
        --quant w4a16 --out ckpts/llama3_8b [--src DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
from pathlib import Path


@dataclasses.dataclass(frozen=True)
class ZooEntry:
    model_id: str        # reference CLI name (chat.cc:9-43)
    config: str          # core.config registry key
    hf_repo: str         # HF checkpoint source
    tokenizer_file: str  # main tokenizer artifact inside the repo


# reference model registry (llm/application/chat.cc:9-43 names ↔
# llm/tools/download_model.py zoo) mapped to upstream HF checkpoints
REGISTRY = {
    e.model_id: e for e in [
        ZooEntry("LLaMA_7B_AWQ", "llama_7b", "huggyllama/llama-7b", "tokenizer.model"),
        ZooEntry("LLaMA2_7B_chat", "llama2_7b", "meta-llama/Llama-2-7b-chat-hf", "tokenizer.json"),
        ZooEntry("LLaMA2_13B_chat", "llama2_13b", "meta-llama/Llama-2-13b-chat-hf", "tokenizer.json"),
        ZooEntry("CodeLLaMA_7B_Instruct", "codellama_7b", "codellama/CodeLlama-7b-Instruct-hf", "tokenizer.json"),
        ZooEntry("CodeLLaMA_13B_Instruct", "codellama_13b", "codellama/CodeLlama-13b-Instruct-hf", "tokenizer.json"),
        ZooEntry("Mistral_7B_v0.2_Instruct", "mistral_7b", "mistralai/Mistral-7B-Instruct-v0.2", "tokenizer.json"),
        ZooEntry("LLaMA_3_8B_Instruct", "llama3_8b", "meta-llama/Meta-Llama-3-8B-Instruct", "tokenizer.json"),
        ZooEntry("OPT_125m", "opt_125m", "facebook/opt-125m", "vocab.json"),
        ZooEntry("OPT_1.3B", "opt_1.3b", "facebook/opt-1.3b", "vocab.json"),
        ZooEntry("OPT_6.7B", "opt_6.7b", "facebook/opt-6.7b", "vocab.json"),
        ZooEntry("StarCoder_15.5B", "starcoder_15.5b", "bigcode/starcoder", "tokenizer.json"),
        ZooEntry("LLaVA_7B", "llava_7b", "liuhaotian/llava-v1.5-7b", "tokenizer.json"),
        ZooEntry("LLaVA_13B", "llava_13b", "liuhaotian/llava-v1.5-13b", "tokenizer.json"),
        ZooEntry("VILA_2.7B", "vila_2.7b", "Efficient-Large-Model/VILA-2.7b", "tokenizer.json"),
        ZooEntry("VILA_7B", "vila_7b", "Efficient-Large-Model/VILA-7b", "tokenizer.json"),
    ]
}


def list_models() -> list[str]:
    return sorted(REGISTRY)


def md5_file(path: str, chunk: int = 1 << 20) -> str:
    """Artifact integrity check (download_model.py's md5 verification)."""
    h = hashlib.md5()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def ensure_model(model_id: str, cache_dir: str | None = None,
                 local_dir: str | None = None) -> str:
    """Return a local directory holding the HF checkpoint for ``model_id``,
    downloading it if needed (requires network + huggingface_hub)."""
    entry = REGISTRY.get(model_id)
    if entry is None:
        raise KeyError(f"unknown model {model_id!r}; known: {list_models()}")
    if local_dir:
        p = Path(local_dir)
        if not p.exists():
            raise FileNotFoundError(local_dir)
        return str(p)
    try:
        from huggingface_hub import snapshot_download
    except ImportError as e:
        raise RuntimeError(
            "huggingface_hub unavailable — pass --src with a pre-downloaded "
            "checkpoint directory instead") from e
    return snapshot_download(entry.hf_repo, cache_dir=cache_dir)


def fetch_and_convert(model_id: str, out: str, scheme: str = "w4a16",
                      group_size: int = 128, src: str | None = None,
                      device=None) -> str:
    """download (or use src) → convert on ``device`` (``None``: the card)
    → save checkpoint; returns out."""
    from tinychatengine_tpu_torch.core.config import (QuantConfig,
                                                      get_model_config)
    from tinychatengine_tpu_torch.tools import convert as cv
    from tinychatengine_tpu_torch.tools.checkpoint import save_checkpoint

    entry = REGISTRY[model_id]
    cfg = get_model_config(entry.config)
    qcfg = QuantConfig(scheme=scheme, group_size=group_size)
    src_dir = ensure_model(model_id, local_dir=src)
    if cfg.family == "llama":
        params = cv.convert_hf_llama(src_dir, cfg, qcfg, device=device)
    elif cfg.family == "opt":
        if scheme == "w8a8":
            # the checkpoint metadata records the scheme ACTUALLY applied —
            # silently saving fp weights under a w8a8 label would make the
            # Engine force an int8 KV cache over fp activations
            raise ValueError(
                "HF OPT → W8A8 needs activation calibration: fetch with "
                "--quant fp, then run tools.calibrate_opt on the checkpoint")
        params = cv.convert_hf_opt(src_dir, cfg, qcfg, device=device)
    elif cfg.family == "gptbigcode":
        params = cv.convert_hf_gptbigcode(src_dir, cfg, qcfg,
                                           device=device)
    else:
        raise NotImplementedError(
            f"zoo conversion for family {cfg.family}: use tools.convert directly")
    save_checkpoint(out, params, cfg, qcfg, extra_meta={"family": cfg.family})
    # carry the tokenizer next to the weights
    tok_src = Path(src_dir) / entry.tokenizer_file
    if tok_src.exists():
        import shutil
        shutil.copy(tok_src, Path(out) / tok_src.name)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="TinyChatEngine-TPU model zoo (the PyTorch/CUDA port)")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--model")
    ap.add_argument("--out")
    ap.add_argument("--quant", default="w4a16",
                    choices=["fp", "w4a16", "w4a8", "w8a8"])
    ap.add_argument("--group-size", type=int, default=128)
    ap.add_argument("--src", help="pre-downloaded checkpoint dir (offline)")
    ap.add_argument("--device", default="cuda",
                    help="where the converted tree is built: cuda or cpu")
    args = ap.parse_args(argv)
    if args.list:
        for m in list_models():
            e = REGISTRY[m]
            print(f"{m:28s} -> {e.hf_repo} (config {e.config})")
        return
    if not (args.model and args.out):
        ap.error("--model and --out required (or --list)")
    out = fetch_and_convert(args.model, args.out, args.quant,
                            args.group_size, src=args.src, device=args.device)
    print(f"checkpoint ready at {out}")


if __name__ == "__main__":
    main()
