"""The port's model zoo and corpus (``tools/zoo.py``, ``tools/corpus.py``)
against the JAX package's (CPU twins of tests/test_tools.py's zoo cases):
the registry, ``md5_file``, ``local_dir``, the unknown model, the missing
``huggingface_hub`` error (never a download), ``fetch_and_convert`` from a
local directory writing JAX's checkpoint, the CLI's listing, and the
corpus and its split byte for byte."""

import sys

import numpy as np
import pytest
import torch

from tinychatengine_tpu.core.config import MODEL_REGISTRY as JREGISTRY
from tinychatengine_tpu.core.config import ModelConfig as JModelConfig
from tinychatengine_tpu.tools import corpus as jcorpus
from tinychatengine_tpu.tools import zoo as jzoo
from tinychatengine_tpu_torch.core.config import MODEL_REGISTRY
from tinychatengine_tpu_torch.core.config import ModelConfig, get_model_config
from tinychatengine_tpu_torch.tools import corpus, zoo


def test_registry_equals_jax():
    assert zoo.list_models() == jzoo.list_models()
    assert len(zoo.list_models()) >= 15
    for m in zoo.list_models():
        e, je = zoo.REGISTRY[m], jzoo.REGISTRY[m]
        assert (e.model_id, e.config, e.hf_repo, e.tokenizer_file) == \
            (je.model_id, je.config, je.hf_repo, je.tokenizer_file)
        assert get_model_config(e.config).vocab_size > 0
        assert "/" in e.hf_repo


def test_md5_and_ensure_model(tmp_path, monkeypatch):
    p = tmp_path / "f.bin"
    p.write_bytes(b"hello world")
    assert zoo.md5_file(str(p)) == "5eb63bbbe01eeed093cb22bb8f5acdc3" \
        == jzoo.md5_file(str(p))
    assert zoo.ensure_model("OPT_125m", local_dir=str(tmp_path)) \
        == str(tmp_path)
    with pytest.raises(FileNotFoundError):
        zoo.ensure_model("OPT_125m", local_dir=str(tmp_path / "nope"))
    with pytest.raises(KeyError):
        zoo.ensure_model("NotAModel")
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(RuntimeError, match="huggingface_hub unavailable"):
        zoo.ensure_model("OPT_125m")


def test_fetch_and_convert_matches_jax(tmp_path, monkeypatch):
    """A registered entry converted from a local HF directory: the port's
    checkpoint equals JAX's file for file and carries the tokenizer."""
    from test_torch_convert import (LLAMA, _hf_llama_tensors,
                                    assert_ckpt_equal, write_hf)
    d = dict(LLAMA, name="zoo_tiny")
    monkeypatch.setitem(JREGISTRY, "zoo_tiny", JModelConfig(**d))
    monkeypatch.setitem(MODEL_REGISTRY, "zoo_tiny", ModelConfig(**d))
    for mod in (zoo, jzoo):
        monkeypatch.setitem(mod.REGISTRY, "Zoo_Tiny", mod.ZooEntry(
            "Zoo_Tiny", "zoo_tiny", "example/zoo-tiny", "tokenizer.json"))
    src = tmp_path / "hf"
    write_hf(src, _hf_llama_tensors(ModelConfig(**d),
                                    np.random.default_rng(0), True),
             "safetensors")
    (src / "tokenizer.json").write_text("{}")
    zoo.fetch_and_convert("Zoo_Tiny", str(tmp_path / "port"), "w4a8",
                          src=str(src), device="cpu")
    jzoo.fetch_and_convert("Zoo_Tiny", str(tmp_path / "jax"), "w4a8",
                           src=str(src))
    assert_ckpt_equal(tmp_path / "port", tmp_path / "jax")
    assert (tmp_path / "port" / "tokenizer.json").read_text() == "{}"
    with pytest.raises(ValueError, match="calibration"):
        zoo.fetch_and_convert("OPT_125m", str(tmp_path / "o"), "w8a8",
                              src=str(src), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zoo.fetch_and_convert("Zoo_Tiny", str(tmp_path / "c"), src=str(src))


def test_zoo_cli_lists_as_jax(capsys):
    zoo.main(["--list"])
    got = capsys.readouterr().out
    jzoo.main(["--list"])
    assert got == capsys.readouterr().out and "LLaMA_3_8B_Instruct" in got
    with pytest.raises(SystemExit):
        zoo.main([])


def test_corpus_equals_jax():
    blob = corpus.build_corpus(max_bytes=1 << 20)
    assert blob == jcorpus.build_corpus(max_bytes=1 << 20)
    assert len(blob) == 1 << 20
    assert corpus.DEFAULT_ROOTS == jcorpus.DEFAULT_ROOTS
    train, held = corpus.train_eval_split(blob, eval_bytes=1 << 18)
    jtrain, jheld = jcorpus.train_eval_split(blob, eval_bytes=1 << 18)
    assert (train, held) == (jtrain, jheld)
    assert train + held == blob
    with pytest.raises(AssertionError):
        corpus.train_eval_split(blob[:1000], eval_bytes=1 << 18)
