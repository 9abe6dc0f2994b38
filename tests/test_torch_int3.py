"""The port's W3 experiment (``ops/int3_matmul.py``, the int3 numerics in
``quant/numerics.py``) against the JAX package on the CPU: the quantizer and
the QM_TPU3 packer bit for bit, the oracle, and ``int3_matmul_plain``
against the TPU kernel in interpret mode. Inputs are made with numpy from a
seed and fed to both sides."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tinychatengine_tpu.ops import int3_matmul as ji3
from tinychatengine_tpu.quant import numerics as jnum
from tinychatengine_tpu_torch.ops import _build
from tinychatengine_tpu_torch.ops import int3_matmul as ti3
from tinychatengine_tpu_torch.quant import numerics as tnum
from tinychatengine_tpu_torch.quant.packing import numpy_to_torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers: one intra-op thread per worker
    keeps torch's many small CPU ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("gs", [32, 64, 128])
def test_int3_quantizer_bit_exact(gs):
    """Codes and scales equal to JAX's, an all-zero group included; the
    dequantized weights too."""
    rng = np.random.default_rng(gs)
    w = (rng.standard_normal((64, 2048)) * 0.1).astype(np.float32)
    w[:, :gs] = 0.0
    q, d = tnum.quantize_groupwise_int3(w, gs)
    jq, jd = jnum.quantize_groupwise_int3(w, gs)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(d, jd)
    assert q.min() >= 0 and q.max() <= 7
    np.testing.assert_array_equal(tnum.dequantize_groupwise_int3(q, d, gs),
                                  jnum.dequantize_groupwise_int3(jq, jd, gs))


def test_int3_pack_round_trip_bit_exact():
    rng = np.random.default_rng(1)
    q = rng.integers(0, 8, (256, 2048)).astype(np.uint8)
    pa, pb = ti3.pack_qm_tpu3(q)
    jpa, jpb = ji3.pack_qm_tpu3(q)
    assert pa.shape == (512, 256) and pb.shape == (256, 256)
    np.testing.assert_array_equal(pa, jpa)
    np.testing.assert_array_equal(pb, jpb)
    np.testing.assert_array_equal(ti3.unpack_qm_tpu3(pa, pb), q)


def _case(seed, m, k, n, g=128):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, k)) * 0.08).astype(np.float32)
    q, d = jnum.quantize_groupwise_int3(w, g)
    pa, pb = ji3.pack_qm_tpu3(q)
    scales = np.ascontiguousarray(d.T)                      # [K/G, N]
    x = (rng.standard_normal((m, k)) * 0.5).astype(ml_dtypes.bfloat16)
    return x, pa, pb, scales


def test_int3_ref_matches_jax():
    """The oracle (full f32 dequantization, one product) on both sides:
    the same rounding of the same f32 sums, within one bf16 step."""
    x, pa, pb, scales = _case(2, 8, 2048, 512)
    want = np.asarray(ji3.int3_matmul_ref(jnp.asarray(x), pa, pb,
                                          jnp.asarray(scales), 128),
                      np.float32)
    got = ti3.int3_matmul_ref(numpy_to_torch(x), pa, pb, scales, 128)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -8,
                               atol=2.0 ** -8 * np.abs(want).max())


@pytest.mark.parametrize("m,k,n,g,bk,bn", [
    (8, 2048, 512, 128, 1024, 256),   # JAX's test case
    (1, 2048, 256, 128, 2048, 2048),
    (12, 3072, 256, 64, 2048, 256),   # block_k 2048 halves to 1024
    (3, 1024, 384, 32, 1024, 2048),
])
def test_int3_plain_matches_jax_kernel(m, k, n, g, bk, bn):
    """``int3_matmul_plain`` (the TPU kernel's fold, (x.A + 4 x.B - 4 sum
    x) d per group) against interpret-mode ``int3_matmul``, within one
    bf16 step of the element or of the output's largest value; and against
    the oracle within JAX's own tolerance (rtol 0.02, atol 0.05)."""
    x, pa, pb, scales = _case(m + k, m, k, n, g)
    # JAX's grid takes whole 8-row blocks below 9 rows: pad its x
    xj = np.pad(x.astype(np.float32), ((0, max(0, 8 - m)), (0, 0)))
    want = np.asarray(ji3.int3_matmul(
        jnp.asarray(xj, jnp.bfloat16), jnp.asarray(pa), jnp.asarray(pb),
        jnp.asarray(scales), group_size=g, block_k=bk, block_n=bn,
        interpret=True), np.float32)[:m]
    got = ti3.int3_matmul(numpy_to_torch(x), numpy_to_torch(pa),
                          numpy_to_torch(pb), numpy_to_torch(scales),
                          group_size=g, block_k=bk)
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -8,
                               atol=2.0 ** -8 * np.abs(want).max())
    oracle = ti3.int3_matmul_ref(numpy_to_torch(x), pa, pb, scales, g)
    np.testing.assert_allclose(got.float().numpy(), oracle.float().numpy(),
                               rtol=0.02, atol=0.05)


def test_int3_refuses_what_jax_refuses():
    """K must take a K block that is a multiple of 1024 (JAX asserts it),
    the planes and scales must fit x, and the weights are 2-D."""
    x, pa, pb, scales = _case(5, 2, 2048, 256)
    t = numpy_to_torch
    with pytest.raises(ValueError, match="multiple of 1024"):
        ti3.int3_matmul(t(x)[:, :1536], t(pa)[:384], t(pb)[:192],
                        t(scales)[:12])
    with pytest.raises(ValueError, match="does not fit"):
        ti3.int3_matmul(t(x), t(pa)[:256], t(pb), t(scales))
    with pytest.raises(ValueError, match="2-D"):
        ti3.int3_matmul(t(x), t(pa)[None], t(pb), t(scales))
    _build.reset_launches()
    ti3.int3_matmul(t(x), t(pa), t(pb), t(scales))
    assert not any(_build.LAUNCHES.values())
