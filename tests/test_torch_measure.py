"""The port's measurement tools and small gaps against the JAX package on
the CPU: the perplexity CLI, ``utils.benchmark.bench_op``,
``utils.profiler.device_trace``, ``quant.packing.pad_to_superblock`` and
the package's ``__version__``.

Tolerances: the perplexity CLIs read the same token count and ppl within
2e-3 relative (the bytellama ppl tolerance of the CPU twins);
``pad_to_superblock`` is bit for bit."""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import tinychatengine_tpu
import tinychatengine_tpu_torch
from tinychatengine_tpu.quant import packing as jpacking
from tinychatengine_tpu.tools import perplexity as jppl
from tinychatengine_tpu_torch.quant import packing as tpacking
from tinychatengine_tpu_torch.tools import perplexity as tppl
from tinychatengine_tpu_torch.utils.benchmark import bench_op
from tinychatengine_tpu_torch.utils.profiler import device_trace

REPO = Path(__file__).resolve().parent.parent
BYTELLAMA = REPO / "assets" / "bytellama_5m"


def _ppl_cli(main, capsys, *extra):
    """(token count, ppl) from a perplexity CLI's two result lines."""
    main(["--checkpoint", str(BYTELLAMA), "--model", "bytellama_5m",
          "--text", str(BYTELLAMA / "eval_sample.txt"), "--max-tokens",
          "2048", "--window", "512", "--stride", "256", *extra])
    out = capsys.readouterr().out
    n = int(re.search(r"^(\d+) tokens, window 512, stride 256$", out,
                      re.M).group(1))
    ppl = float(re.search(r"^perplexity: ([0-9.]+)  \(scheme fp\)$", out,
                          re.M).group(1))
    return n, ppl


def test_perplexity_cli_matches_jax(capsys):
    n, ppl = _ppl_cli(tppl.main, capsys, "--device", "cpu")
    jn, jp = _ppl_cli(jppl.main, capsys)
    assert n == jn == 2048
    assert abs(ppl - jp) <= 2e-3 * jp


@pytest.mark.parametrize("ic", [300, 256, 512, 1])
def test_pad_to_superblock_matches_jax(ic):
    """tests/test_quant.py::test_pad_to_superblock's case and its edges."""
    w = np.random.default_rng(ic).standard_normal((4, ic)).astype(np.float32)
    got, want = tpacking.pad_to_superblock(w), jpacking.pad_to_superblock(w)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert got.shape[1] % tpacking.SUPERBLOCK == 0
    assert (got is w) == (ic % tpacking.SUPERBLOCK == 0)


def test_version_matches_jax():
    assert (tinychatengine_tpu_torch.__version__
            == tinychatengine_tpu.__version__ == "0.1.0")


def test_bench_op_feeds_each_output_into_the_next_input():
    """Each iteration's input is the last one plus 1e-12 times the sum of
    y's first column on every element (the JAX package's feed), in one
    chain; the result is a positive, finite number of seconds."""
    seen = []

    def op(x, w):
        seen.append(x.clone())
        return x @ w + 1.0

    x0 = torch.zeros((64, 128), dtype=torch.float64)
    w = torch.eye(128, dtype=torch.float64)
    t = bench_op(op, x0, w, iters=4, trials=2)
    assert np.isfinite(t) and t > 0
    # a 1-long and a 4-long chain: once to warm up, then once a trial
    assert len(seen) == 3 * (1 + 4)
    for a, b in zip(seen[-4:], seen[-3:]):  # the last 4-long chain
        want = a + 1e-12 * (a[:, 0] + 1.0).sum()
        torch.testing.assert_close(b, want, rtol=1e-12, atol=0)
    assert seen[-1][5, 7] != seen[-4][5, 7]
    assert torch.equal(x0, torch.zeros((64, 128), dtype=torch.float64))


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """A CPU trace of a matmul names ``aten::mm``; the profiler is
    yielded and the trace is written also when the block raises."""
    a = torch.randn(32, 32)
    with device_trace(str(tmp_path / "ok"), device="cpu") as prof:
        a @ a
    text = (tmp_path / "ok" / "trace.json").read_text()
    assert "aten::mm" in text and "traceEvents" in json.loads(text)
    assert any(e.key == "aten::mm" for e in prof.key_averages())
    with pytest.raises(ZeroDivisionError):
        with device_trace(str(tmp_path / "raised"), device="cpu"):
            a @ a
            1 / 0
    assert "aten::mm" in (tmp_path / "raised" / "trace.json").read_text()
