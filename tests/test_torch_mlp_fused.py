"""The port's fused Llama MLP (``ops/mlp_fused.py``) against the JAX
package on the CPU: ``mlp_fused_plain`` against the TPU kernel in interpret
mode, against the three-op composition, a CPU model of the CUDA kernel's
arithmetic (``mlp_contraction``) against the TPU kernel, the K splits the
wrapper picks, and the shape gate ``mlp_fused_supported`` against JAX's.
Inputs are made with numpy from a seed and fed to both sides."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tinychatengine_tpu.ops import mlp_fused as jmf
from tinychatengine_tpu.ops.linear import Int4Linear as JInt4Linear
from tinychatengine_tpu.quant import numerics as jnum
from tinychatengine_tpu.quant import packing as jpack
from tinychatengine_tpu_torch.ops import _build
from tinychatengine_tpu_torch.ops import int4_matmul as tim
from tinychatengine_tpu_torch.ops import mlp_fused as tmf
from tinychatengine_tpu_torch.ops.linear import Int4Linear
from tinychatengine_tpu_torch.quant.packing import SUPERBLOCK, numpy_to_torch
from test_torch_kouter import mma_contraction

E, F = 512, 1024  # JAX's tests/test_mlp_fused.py widths, at bn = 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers: one intra-op thread per worker
    keeps torch's many small CPU ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stacked(rng, k, n, scale_dtype="f32", layers=2):
    packs, scales = [], []
    for _ in range(layers):
        w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
        q, s = jnum.quantize_groupwise_int4(w, 128)
        packs.append(jpack.pack_qm_tpu(q, 128))
        scales.append(jpack.pack_scales(s, scale_dtype, 128))
    return np.stack(packs), np.stack(scales)


def _both(packed, scales):
    """The same weights as a JAX and a port Int4Linear."""
    return (JInt4Linear(packed=jnp.asarray(packed), scales=jnp.asarray(scales)),
            Int4Linear(packed=numpy_to_torch(packed),
                       scales=numpy_to_torch(scales)))


@pytest.mark.parametrize("scale_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m", [1, 4, 16])
def test_mlp_fused_plain_matches_jax_kernel(m, scale_dtype):
    """Both layers of the stack. Held within one bf16 step (2^-8) of the
    element or of the output's largest value: both sides keep gu in f32 and
    round the activation and the output to bf16 at the same points, but sum
    in other orders, which may move an activation across a bf16 rounding
    boundary."""
    rng = np.random.default_rng(m)
    jgu, tgu = _both(*_stacked(rng, E, 2 * F, scale_dtype))
    jdn, tdn = _both(*_stacked(rng, F, E, scale_dtype))
    x = (rng.standard_normal((m, E)) * 0.5).astype(ml_dtypes.bfloat16)
    step = 2.0 ** -8
    for li in (0, 1):
        want = np.asarray(jmf.mlp_fused(jnp.asarray(x), jgu, jdn,
                                        jnp.int32(li), bn=256, interpret=True),
                          np.float32)
        got = tmf.mlp_fused(numpy_to_torch(x), tgu, tdn, li, bn=256)
        assert got.shape == (m, E) and got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=step,
                                   atol=step * np.abs(want).max())


def mlp_contraction(xb: torch.Tensor, wgu: Int4Linear, wdn: Int4Linear,
                    li: int) -> torch.Tensor:
    """The arithmetic of ``csrc/mlp_fused.cu`` on the CPU: gu by the
    tensor-core contraction's model (``mma_contraction``: exact codes q - 8,
    per-group f32 sums folded by fma) in ``mlp_split``'s bands, kept in
    f32; act = bf16((sigmoid(g) * g) * u) with sigmoid(g) = 1 / (1 +
    exp(-g)); the same contraction of act against W_down in its bands,
    rounded to bf16 once."""
    m, e = xb.shape
    f = wdn.packed.shape[-2] * 2
    gs = wgu.group_size
    per_a, _ = tmf.mlp_split(m, 2 * f, e)
    per_b, _ = tmf.mlp_split(m, e, f)
    gu = mma_contraction(xb, wgu.packed[li], wgu.scales[li], gs, per_a)
    g, u = gu[:, :f], gu[:, f:]
    sig = 1.0 / (1.0 + torch.exp(-g))
    act = ((sig * g) * u).to(torch.bfloat16)
    y = mma_contraction(act, wdn.packed[li], wdn.scales[li], gs, per_b)
    return y.to(torch.bfloat16)


@pytest.mark.parametrize("scale_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m", [1, 5, 16])
def test_mlp_contraction_matches_jax_kernel(m, scale_dtype):
    """The CUDA kernel's arithmetic against interpret-mode Pallas
    ``mlp_fused``, layers 0 and 1, gu in two bands and the down product in
    four: within one bf16 step (2^-8) of the element or of the output's
    largest value (both keep gu in f32 and round act and y to bf16 once,
    summing in other orders)."""
    rng = np.random.default_rng(10 + m)
    jgu, tgu = _both(*_stacked(rng, E, 2 * F, scale_dtype))
    jdn, tdn = _both(*_stacked(rng, F, E, scale_dtype))
    x = (rng.standard_normal((m, E)) * 0.5).astype(ml_dtypes.bfloat16)
    assert tmf.mlp_split(m, 2 * F, E) == (1, 2)
    assert tmf.mlp_split(m, E, F) == (1, 4)
    step = 2.0 ** -8
    for li in (0, 1):
        want = np.asarray(jmf.mlp_fused(jnp.asarray(x), jgu, jdn,
                                        jnp.int32(li), bn=256, interpret=True),
                          np.float32)
        got = mlp_contraction(numpy_to_torch(x), tgu, tdn, li)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=step,
                                   atol=step * np.abs(want).max())


@pytest.mark.parametrize("e,f", [(4096, 14336), (512, 1024), (8192, 28672)])
def test_mlp_split_depends_on_k_and_n_alone(e, f):
    """Each phase's K split is the same at every row count the op takes
    (1 to 16 rows are one row tile), covers K in whole superblocks with the
    last band not empty, and at llama3_8b's widths gives gu 2 bands and the
    down product 8."""
    for n, k in ((2 * f, e), (e, f)):
        splits = {tmf.mlp_split(m, n, k) for m in range(1, 17)}
        assert len(splits) == 1
        per, bands = splits.pop()
        nsb = k // SUPERBLOCK
        assert (bands - 1) * per < nsb <= bands * per
    if (e, f) == (4096, 14336):
        assert tmf.mlp_split(16, 2 * f, e) == (8, 2)
        assert tmf.mlp_split(16, e, f) == (7, 8)


def test_mlp_fused_plain_matches_the_composition():
    """JAX's own test: the three-op composition (bf16 gu, bf16-rounded
    dequantized weights) within 0.06."""
    rng = np.random.default_rng(0)
    _, tgu = _both(*_stacked(rng, E, 2 * F))
    _, tdn = _both(*_stacked(rng, F, E))
    x = numpy_to_torch((rng.standard_normal((4, E)) * 0.5).astype(
        ml_dtypes.bfloat16))
    for li in (0, 1):
        got = tmf.mlp_fused(x, tgu, tdn, li, bn=256)
        gu = tim.int4_matmul_plain(x, tgu.packed, tgu.scales, 128,
                                   layer_idx=li)
        act = (torch.nn.functional.silu(gu[:, :F].float())
               * gu[:, F:].float()).to(torch.bfloat16)
        want = tim.int4_matmul_plain(act, tdn.packed, tdn.scales, 128,
                                     layer_idx=li)
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                                   rtol=0.06, atol=0.06)


@pytest.mark.parametrize("e,f,m,bn", [
    (4096, 14336, 1, 2048), (4096, 14336, 16, 2048),   # llama3_8b decode
    (4096, 14336, 17, 2048), (4096, 14336, 64, 2048),  # M too big
    (4096, 11008, 1, 2048), (4096, 11008, 1, 512),     # 2F % bn
    (512, 1024, 4, 256), (512, 1024, 4, 2048),
    (384, 1024, 1, 128),                               # E % superblock
    (4096, 40960, 16, 2048),                           # gu past 4 MiB
])
def test_mlp_fused_supported_matches_jax(e, f, m, bn):
    """The shape gate, at the cases of JAX's test and around them."""
    assert tmf.mlp_fused_supported(e, f, m, bn) \
        == jmf.mlp_fused_supported(e, f, m, bn)


def test_mlp_fused_refuses_unsupported_shapes():
    """Where ``mlp_fused_supported`` says no, or the two weights do not
    make one MLP, the op raises ValueError (JAX leaves it to the caller)."""
    rng = np.random.default_rng(1)
    _, tgu = _both(*_stacked(rng, E, 2 * F))
    _, tdn = _both(*_stacked(rng, F, E))
    x = torch.zeros((17, E), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="mlp_fused_supported"):
        tmf.mlp_fused(x, tgu, tdn, 0, bn=256)
    with pytest.raises(ValueError, match="mlp_fused_supported"):
        tmf.mlp_fused(x[:4], tgu, tdn, 0, bn=2048)
    with pytest.raises(ValueError, match="are not"):
        tmf.mlp_fused(x[:4], tdn, tgu, 0, bn=256)
    with pytest.raises(ValueError, match="layer-stacked"):
        tmf.mlp_fused(x[:4], tgu, tdn, None, bn=256)
    with pytest.raises(ValueError, match="layer_idx"):
        tmf.mlp_fused(x[:4], tgu, tdn, 2, bn=256)


def test_mlp_fused_cpu_launches_nothing():
    rng = np.random.default_rng(2)
    _, tgu = _both(*_stacked(rng, E, 2 * F))
    _, tdn = _both(*_stacked(rng, F, E))
    _build.reset_launches()
    tmf.mlp_fused(torch.ones((2, E), dtype=torch.bfloat16), tgu, tdn, 1,
                  bn=256)
    assert not any(_build.LAUNCHES.values())
