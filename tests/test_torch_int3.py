"""The port's W3 experiment (``ops/int3_matmul.py``, the int3 numerics in
``quant/numerics.py``) against the JAX package on the CPU: the quantizer and
the QM_TPU3 packer bit for bit, the oracle, ``int3_matmul_plain``
against the TPU kernel in interpret mode, a CPU model of the CUDA kernel's
tensor-core arithmetic (``int3_mma_contraction``) against the TPU kernel,
and the K split the wrapper picks (``int3_split``). Inputs are made with
numpy from a seed and fed to both sides."""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from chip_smoke import MAT_TOL
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


def int3_mma_contraction(xb: torch.Tensor, pa: torch.Tensor,
                         pb: torch.Tensor, scales: torch.Tensor,
                         group_size: int, chunks_per_band: int
                         ) -> torch.Tensor:
    """The arithmetic of ``csrc/int3_matmul.cu`` on the CPU, f32 [M, N]:
    bf16 x [M, K] against the exact codes A + 4B - 4 (-4..3); each k16
    step's 16 products (exact in f32) summed and added to its group's fresh
    f32 sum, steps in K order; at the group's end ``acc = fma(dot, d,
    acc)`` with the f32 scale (product and sum in f64, rounded once to
    f32); bands of ``chunks_per_band`` 1024-row chunks summed apart, then
    added in K order (``test_torch_kouter.mma_contraction``'s int3 twin)."""
    m, k = xb.shape
    x = xb.float()
    q = torch.from_numpy(ti3.unpack_qm_tpu3(pa.numpy(), pb.numpy())).T \
        .float() - ti3.ZERO_POINT3
    d = scales.float()
    band_k = chunks_per_band * ti3.SB_B
    y = torch.zeros((m, pa.shape[-1]), dtype=torch.float32)
    for b0 in range(0, k, band_k):
        acc = torch.zeros_like(y)
        for g0 in range(b0, min(b0 + band_k, k), group_size):
            dot = torch.zeros_like(y)
            for s0 in range(g0, g0 + group_size, 16):
                dot = dot + x[:, s0:s0 + 16] @ q[s0:s0 + 16]
            acc = (acc.double() + dot.double()
                   * d[g0 // group_size].double()).float()
        y = y + acc
    return y


def _tpu_kernel_f32(x, pa, pb, scales, group_size, block_k):
    """The TPU kernel's body (``_int3_kernel``) in interpret mode with an
    f32 output: its accumulator before the one bf16 rounding that
    ``int3_matmul`` makes (every row in one block, N in one block)."""
    m, k = x.shape
    n = pa.shape[-1]
    bm = m + (-m) % 8
    xp = np.pad(x.astype(np.float32), ((0, bm - m), (0, 0)))
    grid = (1, 1, k // block_k)
    kern = functools.partial(ji3._int3_kernel, group_size=group_size,
                             n_kblocks=grid[2], block_k=block_k)
    y = pl.pallas_call(
        kern, grid=grid,
        in_specs=[pl.BlockSpec((bm, block_k), lambda i, j, kb: (i, kb)),
                  pl.BlockSpec((block_k // 4, n), lambda i, j, kb: (kb, j)),
                  pl.BlockSpec((block_k // 8, n), lambda i, j, kb: (kb, j)),
                  pl.BlockSpec((k // group_size, n),
                               lambda i, j, kb: (0, j))],
        out_specs=pl.BlockSpec((bm, n), lambda i, j, kb: (i, j)),
        out_shape=jax.ShapeDtypeStruct((bm, n), jnp.float32),
        scratch_shapes=[pltpu.VMEM((bm, n), jnp.float32)], interpret=True,
    )(jnp.asarray(xp, jnp.bfloat16), jnp.asarray(pa), jnp.asarray(pb),
      jnp.asarray(scales))
    return np.asarray(y)[:m]


@pytest.mark.parametrize("gs", [32, 64, 128])
@pytest.mark.parametrize("m", [1, 8, 16, 64])
def test_int3_mma_contraction_matches_jax_kernel(m, gs):
    """The CUDA kernel's arithmetic against the TPU kernel's f32 sum
    (``_int3_kernel`` in interpret mode, f32 out), K = 3072 in the three
    one-chunk bands that ``int3_split`` gives at N = 256: the two sum the
    same exact terms in other orders (the TPU keeps x . A, x . B and 4 sum
    x apart per group), so they differ by f32 roundings: held within 2^-22
    of the terms' absolute sum, sum over k of |x| * 4 * |d|. Rounded to
    bf16, the model lies within one bf16 step of interpret-mode
    ``int3_matmul`` and within MAT_TOL of the plain version."""
    k, n = 3072, 256
    x, pa, pb, scales = _case(m * gs, m, k, n, gs)
    per, bands = ti3.int3_split(m, n, k)
    assert (per, bands) == (1, 3)
    want = _tpu_kernel_f32(x, pa, pb, scales, gs, 1024)
    xt = numpy_to_torch(x)
    got = int3_mma_contraction(xt, torch.from_numpy(pa), torch.from_numpy(pb),
                               torch.from_numpy(scales), gs, per)
    terms = (xt.float().abs() @ (4.0 * torch.from_numpy(scales).abs()
                                 .repeat_interleave(gs, dim=0))).numpy()
    assert np.all(np.abs(got.numpy() - want) <= 2.0 ** -22 * terms)
    xj = np.pad(x.astype(np.float32), ((0, max(0, 8 - m)), (0, 0)))
    kernel = np.asarray(ji3.int3_matmul(
        jnp.asarray(xj, jnp.bfloat16), jnp.asarray(pa), jnp.asarray(pb),
        jnp.asarray(scales), group_size=gs, block_k=1024, interpret=True),
        np.float32)[:m]
    bf = got.to(torch.bfloat16).float().numpy()
    np.testing.assert_allclose(bf, kernel, rtol=2.0 ** -8,
                               atol=2.0 ** -8 * np.abs(kernel).max())
    plain = ti3.int3_matmul_plain(xt, numpy_to_torch(pa), numpy_to_torch(pb),
                                  numpy_to_torch(scales), group_size=gs
                                  ).float()
    assert (torch.from_numpy(bf) - plain).abs().max() \
        <= MAT_TOL * plain.abs().max()


@pytest.mark.parametrize("k,n", [(4096, 28672), (14336, 4096), (4096, 6144),
                                 (4096, 4096), (3072, 256), (1024, 128)])
def test_int3_split_depends_on_k_and_n_alone_up_to_eight_rows(k, n):
    """``int3_split`` at llama3_8b's widths and the tests' is the same at
    1..8 rows (one 8-row tile), so a row's bits do not depend on how many
    rows ride along; every band holds whole 1024-row chunks and the last
    one at least one; wider row tiles split K no finer."""
    splits = {ti3.int3_split(m, n, k) for m in range(1, 9)}
    assert len(splits) == 1
    per, bands = splits.pop()
    chunks = k // ti3.SB_B
    assert per * (bands - 1) < chunks <= per * bands
    for m in (16, 64, 100):
        per_m, bands_m = ti3.int3_split(m, n, k)
        assert per_m * (bands_m - 1) < chunks <= per_m * bands_m
        assert bands_m <= bands
