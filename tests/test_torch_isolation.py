"""The PyTorch/CUDA port stands alone: it imports without JAX (the machine
with the card has none) and names nothing of the JAX package."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "tinychatengine_tpu_torch"
JAX_PKG = "tinychatengine_tpu"


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PORT)], prefix="tinychatengine_tpu_torch."))


def test_every_port_module_imports_without_jax():
    mods = ["tinychatengine_tpu_torch"] + _port_modules()
    assert {"tinychatengine_tpu_torch.generation.engine",
            "tinychatengine_tpu_torch.generation.cuda_graph"} <= set(mods)
    assert {"tinychatengine_tpu_torch.runtime.paged",
            "tinychatengine_tpu_torch.runtime.serving",
            "tinychatengine_tpu_torch.models.opt",
            "tinychatengine_tpu_torch.models.gptbigcode",
            "tinychatengine_tpu_torch.tools.calibrate_opt"} <= set(mods)
    assert {"tinychatengine_tpu_torch.models.clip",
            "tinychatengine_tpu_torch.generation.vlm",
            "tinychatengine_tpu_torch.generation.speculative"} <= set(mods)
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'ml_dtypes', 'tinychatengine_tpu'):\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [REPO / "chip_smoke.py",
                          REPO / "scripts" / "bench_torch.py",
                          REPO / "scripts" / "decode_gap.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_package_import(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in (JAX_PKG, "jax", "jaxlib", "ml_dtypes"), \
            f"{path.relative_to(REPO)} imports {name}"


def test_entry_points_default_to_the_card(monkeypatch):
    """Engine, ServingEngine, init_random_params, load_checkpoint,
    init_cache, init_paged_cache, SamplerState.init and
    RowParams.from_configs without device= raise when no CUDA device is
    present, and so do the OPT ones (opt.init_random_params, the OPT
    checkpoint, quantize_opt_w8a8, Engine and ServingEngine for OPT) and
    the GPTBigCode ones (gptbigcode.init_random_params, Engine and
    ServingEngine for GPTBigCode); they never fall back to the CPU."""
    from tinychatengine_tpu_torch.core.config import (GenerationConfig,
                                                      QuantConfig,
                                                      get_model_config)
    from tinychatengine_tpu_torch.generation import kv_cache, sampling
    from tinychatengine_tpu_torch.generation.engine import Engine
    from tinychatengine_tpu_torch.models import llama
    from tinychatengine_tpu_torch.runtime import paged
    from tinychatengine_tpu_torch.runtime.serving import ServingEngine
    from tinychatengine_tpu_torch.tools.checkpoint import load_checkpoint

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_model_config("bytellama_5m")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(None, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.init_random_params(cfg, QuantConfig(scheme="w4a8"), seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_checkpoint(str(REPO / "assets" / "bytellama_5m"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kv_cache.init_cache(1, 1, 16, 1, 64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(None, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paged.init_paged_cache(1, 4, 1, 16, 64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sampling.SamplerState.init(0, 1, 5.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sampling.RowParams.from_configs([GenerationConfig()])

    from tinychatengine_tpu_torch.models import opt
    from tinychatengine_tpu_torch.tools.calibrate_opt import quantize_opt_w8a8
    ocfg = get_model_config("byteopt_4m")
    w8 = QuantConfig(scheme="w8a8")
    for fast in (False, True):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            opt.init_random_params(ocfg, quantized=True, fast=fast, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_checkpoint(str(REPO / "assets" / "byteopt_4m"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quantize_opt_w8a8(None, ocfg, [[1, 2, 3]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(None, ocfg, w8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(None, ocfg, w8, forward_fn=opt.forward)

    from tinychatengine_tpu_torch.models import gptbigcode
    scfg = get_model_config("starcoder_15.5b")
    w4 = QuantConfig(scheme="w4a16")
    for fast in (False, True):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            gptbigcode.init_random_params(scfg, seed=0, qcfg=w4, fast=fast)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(None, scfg, w4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(None, scfg, w4, forward_fn=gptbigcode.forward)


def test_clip_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """The VLM's entry points (clip.init_random_params, preprocess_image of
    a host image, load_clip) without device= raise when no CUDA device is
    present."""
    import numpy as np

    from tinychatengine_tpu_torch.core.config import get_model_config
    from tinychatengine_tpu_torch.models import clip
    from tinychatengine_tpu_torch.tools.checkpoint import load_clip, save_clip

    tiny = get_model_config("clip_vit_large")
    tiny = type(tiny)(**{**tiny.__dict__, "num_layers": 1, "embed_dim": 64,
                         "hidden_dim": 128, "num_heads": 4, "num_kv_heads": 4,
                         "image_size": 28, "mmproj_dim": 64})
    save_clip(str(tmp_path), clip.init_random_params(tiny, device="cpu"), tiny)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        clip.init_random_params(tiny)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        clip.preprocess_image(np.zeros((30, 30, 3), np.uint8), 28)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_clip(str(tmp_path))
