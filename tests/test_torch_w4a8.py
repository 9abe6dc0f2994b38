"""The W4A8 kernel's arithmetic against the JAX package on the CPU: a CPU
model of ``csrc/int4_matmul_a8.cu`` (``a8_contraction``: the run-time int8
quantizer, exact int32 group dots, the TPU kernel's fold order, K bands in
K order) against the TPU kernel ``int4_matmul_a8`` in interpret mode, and
the K split the wrapper picks (``a8_split``). Inputs are made with numpy
from a seed and fed to both sides."""

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
from tinychatengine_tpu.ops import int4_matmul as jim
from tinychatengine_tpu.quant import numerics as jnum
from tinychatengine_tpu.quant import packing as jpack
from tinychatengine_tpu_torch.ops import int4_matmul as tim
from tinychatengine_tpu_torch.ops.ref import ZERO_POINT, unpack_int4
from tinychatengine_tpu_torch.quant.packing import SUPERBLOCK, numpy_to_torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers: one intra-op thread per worker
    keeps torch's many small CPU ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(rng, k, n, gs, scale_dtype, layers=3):
    """Stacked (packed [L, K/2, N], scales [L, K/G, N]) numpy arrays; K is
    pack-padded to whole superblocks (``packing.padded_ic``)."""
    packs, scales = [], []
    for _ in range(layers):
        w = (rng.standard_normal((n, k)) * 0.02).astype(np.float32)
        q, s = jnum.quantize_groupwise_int4(w, gs)
        packs.append(jpack.pack_qm_tpu(q, gs))
        scales.append(jpack.pack_scales(s, scale_dtype, gs))
    return np.stack(packs), np.stack(scales)


# the f32 reciprocal of 127: XLA computes the TPU body's ``/ 127.0`` as a
# multiply by it (its simplifier rewrites a division by a constant), and so
# does the kernel
RECIP_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)


def a8_quantize(xb: torch.Tensor, group_size: int):
    """The kernel's quantizer (``a8_quant_kernel``): per (row, group) of bf16
    x [M, K], a_scale = max(absmax, 1e-8) * f32(1 / 127) and q_a =
    clip(rint(x / a_scale), -127, 127), each an f32 operation. Returns (q_a
    int8 [M, K], a_scale f32 [M, K/G])."""
    m, k = xb.shape
    xg = xb.float().reshape(m, k // group_size, group_size)
    a_scale = torch.clamp(xg.abs().amax(dim=-1), min=1e-8) * RECIP_127
    q_a = torch.clamp(torch.round(xg / a_scale[..., None]), -127, 127)
    return q_a.to(torch.int8).reshape(m, k), a_scale


def a8_contraction(xb: torch.Tensor, packed: torch.Tensor,
                   scales: torch.Tensor, group_size: int,
                   sb_per_band: int) -> torch.Tensor:
    """The arithmetic of ``csrc/int4_matmul_a8.cu`` on the CPU, f32 [M, N]
    before the bf16 rounding: bf16 x [M, K] (K the packed K) quantized by
    ``a8_quantize``; per group the exact integer dot sum q_a * (q - 8)
    (the kernel's u8 x s8 dot less 8 sum q_a), then acc = acc +
    ((float(dot) * a_scale) * d), three f32 roundings, groups in K order;
    bands of ``sb_per_band`` superblocks summed apart, then added in K
    order."""
    m, k = xb.shape
    q_a, a_scale = a8_quantize(xb, group_size)
    codes = unpack_int4(packed).to(torch.int64) - ZERO_POINT
    d = scales.float()
    band_k = sb_per_band * SUPERBLOCK
    y = torch.zeros((m, packed.shape[-1]), dtype=torch.float32)
    for b0 in range(0, k, band_k):
        acc = torch.zeros_like(y)
        for g0 in range(b0, min(b0 + band_k, k), group_size):
            gi = g0 // group_size
            dot = q_a[:, g0:g0 + group_size].to(torch.int64) \
                @ codes[g0:g0 + group_size]
            acc = acc + (dot.float() * a_scale[:, gi:gi + 1]) * d[gi]
        y = y + acc
    return y


def _jax_quantize(x: np.ndarray, group_size: int):
    """The TPU kernel body's quantizer (``_int4_a8_kernel``'s absmax,
    a_scale and q_a lines), jitted on the CPU over every group."""
    @jax.jit
    def quant(x):
        xg = x.astype(jnp.float32).reshape(x.shape[0], -1, group_size)
        absmax = jnp.max(jnp.abs(xg), axis=2, keepdims=True)
        a_scale = jnp.maximum(absmax, 1e-8) / 127.0
        q_a = jnp.clip(jnp.round(xg / a_scale), -127, 127).astype(jnp.int8)
        return q_a.reshape(x.shape), a_scale[..., 0]
    q_a, a_scale = quant(jnp.asarray(x))
    return np.asarray(q_a), np.asarray(a_scale)


def _tpu_kernel_f32(x: np.ndarray, packed: np.ndarray, scales: np.ndarray,
                    group_size: int, block_k: int) -> np.ndarray:
    """The TPU kernel's body (``_int4_a8_kernel``) in interpret mode on one
    layer's weights with an f32 output: its accumulator before the one
    bf16 rounding that ``int4_matmul_a8`` makes (the wrapper's unstacked
    pallas_call with f32 scales, every row in one block)."""
    m, kw = x.shape
    n = packed.shape[-1]
    bm = m + (-m) % 16
    xp = np.pad(x.astype(np.float32), ((0, bm - m), (0, 0)))
    grid = (1, 1, kw // block_k)
    kern = functools.partial(jim._int4_a8_kernel, group_size=group_size,
                             n_kblocks=grid[2], block_k=block_k,
                             s_kblocked=False)
    y = pl.pallas_call(
        kern, grid=grid,
        in_specs=[pl.BlockSpec((bm, block_k), lambda i, j, kb: (i, kb)),
                  pl.BlockSpec((block_k // 2, n), lambda i, j, kb: (kb, j)),
                  pl.BlockSpec((kw // group_size, n),
                               lambda i, j, kb: (0, j))],
        out_specs=pl.BlockSpec((bm, n), lambda i, j, kb: (i, j)),
        out_shape=jax.ShapeDtypeStruct((bm, n), jnp.float32),
        scratch_shapes=[pltpu.VMEM((bm, n), jnp.float32)], interpret=True,
    )(jnp.asarray(xp, jnp.bfloat16), jnp.asarray(packed),
      jnp.asarray(scales, jnp.float32))
    return np.asarray(y)[:m]


def _case(m, gs, scale_dtype, k=1024, n=256, seed=0):
    rng = np.random.default_rng(seed + m * gs + (scale_dtype == "bf16"))
    packed, scales = _weights(rng, k, n, gs, scale_dtype)
    x = (rng.standard_normal((m, k)) * 1.5).astype(np.float32).astype(
        ml_dtypes.bfloat16)
    return x, packed, scales


@pytest.mark.parametrize("gs", [32, 64, 128])
@pytest.mark.parametrize("m", [1, 8, 64, 100])
def test_quantizer_matches_the_tpu_kernel_bit_for_bit(m, gs):
    """q_a codes and a_scale equal the TPU kernel body's as XLA runs it,
    bit for bit (a_scale by the f32 reciprocal of 127, x / a_scale an f32
    division, round half to even, clip to +-127), with an all-zero group
    (absmax 0, a_scale 1e-8 / 127) and exact .5 quotients."""
    x, _, _ = _case(m, gs, "f32")
    x = x.astype(np.float32)
    x[0, :gs] = 0.0
    x[-1, gs:2 * gs] = np.linspace(-63.5, 63.5, gs) / 8.0  # halves of 127
    x = x.astype(ml_dtypes.bfloat16)
    want_q, want_s = _jax_quantize(x, gs)
    got_q, got_s = a8_quantize(numpy_to_torch(x), gs)
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy().view(np.uint32),
                                  want_s.view(np.uint32))


@pytest.mark.parametrize("scale_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("gs", [32, 64, 128])
@pytest.mark.parametrize("m", [1, 8, 64, 100])
def test_a8_contraction_matches_jax_kernel(m, gs, scale_dtype):
    """The CUDA kernel's arithmetic against interpret-mode Pallas
    ``int4_matmul_a8``, layers 0 and 2 of a stack, K = 1024 in the four
    bands ``a8_split`` gives at N = 256. Before rounding (the TPU body with
    an f32 output, two K blocks): both sum the same exact terms, one
    accumulator against four bands, so they differ by f32 roundings, held
    within 2^-22 of the terms' absolute sum (sum over k of |q_a| a_scale
    8 |d|, 4 f32 ulps of it). After the bf16 rounding, against the wrapper
    itself: within one bf16 step (2^-8) of the element or of the output's
    largest value."""
    x, packed, scales = _case(m, gs, scale_dtype)
    per, bands = tim.a8_split(1024, 256)
    assert (per, bands) == (1, 4)
    xt = numpy_to_torch(x)
    step = 2.0 ** -8
    for li in (0, 2):
        tp, ts = numpy_to_torch(packed[li]), numpy_to_torch(scales[li])
        got = a8_contraction(xt, tp, ts, gs, per)
        want = _tpu_kernel_f32(x, packed[li], scales[li].astype(np.float32),
                               gs, 512)
        q_a, a_scale = a8_quantize(xt, gs)
        terms = ((q_a.float().abs() * a_scale.repeat_interleave(gs, dim=1))
                 @ (8.0 * ts.float().abs().repeat_interleave(gs, dim=0)))
        assert np.all(np.abs(got.numpy() - want) <= 2.0 ** -22
                      * terms.numpy())
        want_bf16 = np.asarray(jim.int4_matmul_a8(
            jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scales), gs,
            layer_idx=jnp.int32(li), interpret=True), np.float32)
        np.testing.assert_allclose(
            got.to(torch.bfloat16).float().numpy(), want_bf16, rtol=step,
            atol=step * np.abs(want_bf16).max())
        plain = tim.int4_matmul_a8_plain(
            xt, numpy_to_torch(packed), numpy_to_torch(scales), gs,
            layer_idx=li).float()
        err = (got.to(torch.bfloat16).float() - plain).abs().max()
        assert err <= MAT_TOL * plain.abs().max()


@pytest.mark.parametrize("scale_dtype", ["f32", "bf16"])
def test_a8_contraction_takes_a_pack_padded_k(scale_dtype):
    """x of K = 1152 against weights packed at G = 64 to 1536 rows (18
    groups padded to 24, six superblocks in six bands): the wrapper
    zero-pads x; the padded groups quantize to zero codes (a_scale 1e-8 /
    127) and add nothing."""
    rng = np.random.default_rng(11)
    packed, scales = _weights(rng, 1152, 256, 64, scale_dtype)
    assert packed.shape[1] == 768
    x = rng.standard_normal((9, 1152)).astype(np.float32).astype(
        ml_dtypes.bfloat16)
    xp = np.pad(x, ((0, 0), (0, 384)))
    per, bands = tim.a8_split(1536, 256)
    assert (per, bands) == (1, 6)
    step = 2.0 ** -8
    for li in (0, 2):
        got = a8_contraction(numpy_to_torch(xp), numpy_to_torch(packed[li]),
                             numpy_to_torch(scales[li]), 64, per)
        want = np.asarray(jim.int4_matmul_a8(
            jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scales), 64,
            layer_idx=jnp.int32(li), interpret=True), np.float32)
        np.testing.assert_allclose(got.to(torch.bfloat16).float().numpy(),
                                   want, rtol=step,
                                   atol=step * np.abs(want).max())


@pytest.mark.parametrize("k,n,split", [
    (4096, 6144, (6, 3)), (4096, 4096, (4, 4)), (4096, 28672, (16, 1)),
    (14336, 4096, (12, 5)), (4096, 129024, (16, 1)),  # llama3_8b's shapes
    (256, 512, (1, 1)), (2816, 384, (2, 6))])
def test_a8_split_covers_k_in_at_most_eight_bands(k, n, split):
    """``a8_split`` depends on K and N alone (the wrapper never passes M)
    and gives 1 to 8 bands (one cluster a tile) of whole superblocks, the
    last one not empty."""
    nsb = k // SUPERBLOCK
    per, bands = tim.a8_split(k, n)
    assert (per, bands) == split
    assert 1 <= bands <= tim.A8_MAX_BANDS
    assert (bands - 1) * per < nsb <= bands * per
