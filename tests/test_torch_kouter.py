"""The K-outer W4A16 route and the GLU down projection against the JAX
package on the CPU: the plain versions of ``int4_matmul_kouter`` and
``int4_matmul_glu`` against the TPU kernels in interpret mode, a CPU model
of the CUDA kernels' tensor-core arithmetic (``mma_contraction``) against
the TPU kernel, the route's gate against the conditions JAX's
``int4_matmul`` tests, the row tiles and K splits the wrappers pick, the
``TINYCHAT_DECODE_KOUTER`` parser against JAX's (the 2-layer W4A16 forward
with the table filled is a case of tests/test_torch_llama.py's forward
test). Inputs are made with numpy from a seed and fed to both sides."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from chip_smoke import MAT_TOL
from tinychatengine_tpu.ops import int4_matmul as jim
from tinychatengine_tpu.quant import numerics as jnum
from tinychatengine_tpu.quant import packing as jpack
from tinychatengine_tpu_torch.core.config import ModelConfig, QuantConfig
from tinychatengine_tpu_torch.models import llama
from tinychatengine_tpu_torch.ops import _build
from tinychatengine_tpu_torch.ops import int4_matmul as tim
from tinychatengine_tpu_torch.ops.ref import ZERO_POINT, unpack_int4
from tinychatengine_tpu_torch.quant.packing import SUPERBLOCK, numpy_to_torch

# the smallest llama whose four stacked linears the K-outer kernel takes
# (K/G a multiple of 8: E = F = 1024 at G = 128)
KOUTER_LLAMA = dict(name="tiny-kouter", family="llama", num_heads=8,
                    num_kv_heads=4, num_layers=2, max_sqlen=64,
                    embed_dim=1024, hidden_dim=1024, vocab_size=512,
                    rms_norm_eps=1e-5, rope_theta=10000.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers: one intra-op thread per worker
    keeps torch's many small CPU ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _bf16(a) -> np.ndarray:
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)


def _weights(rng, k, n, layers=2, scale_dtype="f32", gs=128):
    """Stacked (packed [L, K/2, N], scales [L, K/G, N]) numpy arrays."""
    packs, scales = [], []
    for _ in range(layers):
        w = (rng.standard_normal((n, k)) * 0.02).astype(np.float32)
        q, s = jnum.quantize_groupwise_int4(w, gs)
        packs.append(jpack.pack_qm_tpu(q, gs))
        scales.append(jpack.pack_scales(s, scale_dtype, gs))
    return np.stack(packs), np.stack(scales)


def _within_a_bf16_step(got, want):
    """Both sides compute the TPU kernel's function in f32 and round once
    to bf16; they may sum in other orders, so an element may land one bf16
    step (2^-8 relative) apart, or one step of the output's largest value
    where the sum cancels."""
    got, want = _f32(got), _f32(want)
    step = 2.0 ** -8
    np.testing.assert_allclose(got, want, rtol=step,
                               atol=step * np.abs(want).max())


@pytest.mark.parametrize("scale_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bn,bk", [(512, 1024), (256, 256), (128, 512)])
def test_kouter_plain_matches_jax_kernel(bn, bk, scale_dtype):
    """The three blockings of the JAX package's own K-outer test, both
    layers of the stack, 16 rows and 5 (JAX pads them to its 16-row
    block)."""
    rng = np.random.default_rng(bk + bn)
    packed, scales = _weights(rng, 1024, 512, scale_dtype=scale_dtype)
    for m in (16, 5):
        x = _bf16(rng.standard_normal((m, 1024)))
        xp = np.pad(x.astype(np.float32), ((0, (-m) % 16), (0, 0)))
        for li in (0, 1):
            want = jim._int4_matmul_kouter(
                jnp.asarray(xp, jnp.bfloat16), jnp.asarray(packed),
                jnp.asarray(scales), jnp.int32(li), group_size=128,
                block_m=16, block_n=bn, block_k=bk, interpret=True)[:m]
            got = tim.int4_matmul_kouter(
                numpy_to_torch(x), numpy_to_torch(packed),
                numpy_to_torch(scales), 128, layer_idx=li, block_n=bn,
                block_k=bk)
            assert got.dtype == torch.bfloat16 and got.shape == (m, 512)
            _within_a_bf16_step(got, want)


def test_kouter_plain_takes_a_pack_padded_k():
    """x of K = 1152 against weights packed to 2048 rows (9 groups padded
    to 16, ``packing.padded_ic``): JAX's int4_matmul zero-pads x before the
    K-outer kernel; the port's wrapper pads it itself."""
    rng = np.random.default_rng(7)
    k, n = 1152, 256
    packs, scales = [], []
    for _ in range(2):
        w = (rng.standard_normal((n, k)) * 0.02).astype(np.float32)
        q, s = jnum.quantize_groupwise_int4(w, 128)
        packs.append(jpack.pack_qm_tpu(q, 128))
        scales.append(jpack.pack_scales(s, "f32", 128))
    packed, scales = np.stack(packs), np.stack(scales)
    assert packed.shape == (2, 1024, n)
    x = _bf16(rng.standard_normal((3, k)))
    xp = np.pad(x.astype(np.float32), ((0, 13), (0, 2048 - k)))
    want = jim._int4_matmul_kouter(
        jnp.asarray(xp, jnp.bfloat16), jnp.asarray(packed),
        jnp.asarray(scales), jnp.int32(1), group_size=128, block_m=16,
        block_n=256, block_k=1024, interpret=True)[:3]
    got = tim.int4_matmul_kouter(numpy_to_torch(x), numpy_to_torch(packed),
                                 numpy_to_torch(scales), 128, layer_idx=1,
                                 block_n=256, block_k=1024)
    _within_a_bf16_step(got, want)


def mma_contraction(xb: torch.Tensor, packed: torch.Tensor,
                    scales: torch.Tensor, group_size: int,
                    sb_per_band: int) -> torch.Tensor:
    """The arithmetic of the CUDA kernels' tensor-core contraction
    (``csrc/int4_mma.cuh``) on the CPU, f32 [M, N]: bf16 x [M, K] against
    one layer's exact codes q - 8; each k16 step's 16 products (exact in
    f32) summed and added to its group's fresh f32 sum, steps in K order;
    at the group's end ``acc = fma(dot, d, acc)`` with the f32 scale (the
    product and sum taken in f64 and rounded once to f32); bands of
    ``sb_per_band`` superblocks summed apart, then added in K order."""
    m, k = xb.shape
    x = xb.float()
    q = (unpack_int4(packed).float() - ZERO_POINT)
    d = scales.float()
    band_k = sb_per_band * SUPERBLOCK
    y = torch.zeros((m, packed.shape[-1]), dtype=torch.float32)
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


@pytest.mark.parametrize("scale_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("gs", [32, 64, 128])
@pytest.mark.parametrize("m", [2, 8, 16, 64])
def test_mma_contraction_matches_jax_kernel(m, gs, scale_dtype):
    """The CUDA kernels' arithmetic against interpret-mode Pallas
    ``_int4_matmul_kouter`` with f32 output (the TPU kernel before its one
    bf16 rounding), K = 1024 in two bands: the two sum the same exact
    terms in other orders (the TPU subtracts 8 sum x from each group's dot
    over raw codes 0..15), so they differ by f32 roundings: held within
    2^-22 of the terms' absolute sum, sum over k of |x| * 15 * |d| (4 f32
    ulps of it; these inputs part by at most 0.14). Rounded to bf16, both
    lie within MAT_TOL of the plain version."""
    rng = np.random.default_rng(m * gs)
    packed, scales = _weights(rng, 1024, 256, scale_dtype=scale_dtype,
                              gs=gs)
    x = _bf16(rng.standard_normal((m, 1024)))
    xp = np.pad(x.astype(np.float32), ((0, (-m) % 16), (0, 0)))
    want = np.asarray(jim._int4_matmul_kouter(
        jnp.asarray(xp, jnp.bfloat16), jnp.asarray(packed),
        jnp.asarray(scales), jnp.int32(1), group_size=gs, block_m=16,
        block_n=256, block_k=512, interpret=True,
        out_dtype=jnp.float32))[:m].copy()
    tp, ts = numpy_to_torch(packed)[1], numpy_to_torch(scales)[1]
    xt = numpy_to_torch(x)
    got = mma_contraction(xt, tp, ts, gs, 512 // SUPERBLOCK)
    terms = (xt.float().abs() @ (15.0 * ts.float().abs()
                                 .repeat_interleave(gs, dim=0))).numpy()
    assert np.all(np.abs(got.numpy() - want) <= 2.0 ** -22 * terms)
    plain = tim.int4_matmul_kouter_plain(
        xt, numpy_to_torch(packed), numpy_to_torch(scales), gs, layer_idx=1,
        block_n=256, block_k=512).float()
    for y in (got, torch.from_numpy(want)):
        err = (y.to(torch.bfloat16).float() - plain).abs().max()
        assert err <= MAT_TOL * plain.abs().max()


@pytest.mark.parametrize("m,tile", [(1, 8), (2, 8), (8, 8), (9, 16),
                                    (16, 16), (17, 32), (33, 64), (496, 64),
                                    (497, None)])
def test_kouter_rows_and_route_at_the_boundaries(monkeypatch, m, tile):
    """With llama3_8b's gate_up listed, ``int4_matmul`` on the card takes
    the K-outer kernel from 1 to 496 rows, each block covering
    ``mma_row_tile(M)`` of them (one route, no row-count boundary), and the
    tile route from 497 rows (padded to 512)."""
    monkeypatch.setattr(tim, "DECODE_KOUTER", {(4096, 28672): (2048, 1024)})
    route, blocks = tim.int4_route(m, 4096, 28672, True)
    if tile is None:
        assert route == "tile"
    else:
        assert (route, blocks) == ("kouter", (2048, 1024))
        assert tim.mma_row_tile(m) == tile


@pytest.mark.parametrize("k,n", [(6144, 6400), (6144, 6144), (6144, 24576),
                                 (24576, 6144), (6144, 49152), (4096, 28672),
                                 (14336, 4096), (4096, 129024)])
def test_fused_split_depends_on_k_and_n_alone_up_to_eight_rows(k, n):
    """``int4_matmul_fused``'s K split at StarCoder's and llama3_8b's
    decode shapes is the same at 1..8 rows (one 8-row tile), so a serving
    row's bits do not depend on how many slots are active; every split
    holds whole superblocks and the last one at least one."""
    splits = {tim.fused_kernel_split(m, n, k) for m in range(1, 9)}
    assert len(splits) == 1 and {tim.mma_row_tile(m) for m in range(1, 9)} \
        == {8}
    per, ksplit = splits.pop()
    nsb = k // SUPERBLOCK
    assert per * (ksplit - 1) < nsb <= per * ksplit


@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("m", [1, 64, 496, 497, 511, 512])
def test_kouter_route_gate_matches_jax(monkeypatch, m, stacked):
    """``kouter_route`` against the branch JAX's ``int4_matmul`` takes, with
    the shape listed and not: both of its kernel calls are replaced by
    recorders, so nothing heavy runs. m = 496 pads to 496 and routes; 497
    pads to 512 and does not; unstacked weights never route."""
    k, n, blocks = 512, 256, (128, 256)
    packed = jnp.zeros(((2,) if stacked else ()) + (k // 2, n), jnp.uint8)
    scales = jnp.zeros(((2,) if stacked else ()) + (k // 128, n), jnp.float32)
    calls = []

    def recorder(name):
        def fn(x, *a, **kw):
            calls.append((name, kw.get("block_n"), kw.get("block_k")))
            return jnp.zeros((x.shape[0], n), jnp.bfloat16)
        return fn
    monkeypatch.setattr(jim, "_int4_matmul_kouter", recorder("kouter"))
    monkeypatch.setattr(jim, "_int4_matmul_2d", recorder("2d"))
    for listed in (True, False):
        table = {(k, n): blocks} if listed else {(k, 2 * n): blocks}
        monkeypatch.setattr(jim, "DECODE_KOUTER", table)
        monkeypatch.setattr(tim, "DECODE_KOUTER", dict(table))
        calls.clear()
        jim.int4_matmul(jnp.zeros((m, k), jnp.bfloat16), packed, scales, 128,
                        layer_idx=jnp.int32(1) if stacked else None)
        jax_routes = calls[0][0] == "kouter"
        got = tim.kouter_route(m, k, n, stacked)
        assert (got is not None) == jax_routes
        assert jax_routes == (stacked and listed and m <= 496)
        if jax_routes:
            assert got == blocks == calls[0][1:]


SPECS_ACCEPTED = [
    "",
    "4096,28672:2048,1024",
    "4096,6144:2048,1024; 4096,4096:2048,1024;4096,28672:2048,1024;"
    "14336,4096:2048,1024;",
    "512,256:128,256",
]
SPECS_REFUSED = [
    "4096,28672",                 # no blocks
    "4096,28672:2048",            # one block
    "4096;28672:2048,1024",       # shape not K,N
    "4096,28672:2048,1024:5",     # two colons
    "4096,28672:100,1024",        # bn not a multiple of 128
    "4096,28672:3072,1024",       # bn does not divide N
    "4096,28672:2048,768",        # bk does not divide K
    "4096,28672:2048,128",        # bk not a multiple of a superblock
    "a,b:c,d",
]


@pytest.mark.parametrize("spec", SPECS_ACCEPTED + SPECS_REFUSED)
def test_decode_kouter_parsing_matches_jax(monkeypatch, spec):
    """``TINYCHAT_DECODE_KOUTER`` takes JAX's ``TCE_DECODE_KOUTER`` syntax:
    the same table from an accepted spec, ValueError from a refused one on
    both sides."""
    monkeypatch.setenv("TCE_DECODE_KOUTER", spec)
    monkeypatch.setenv("TINYCHAT_DECODE_KOUTER", spec)
    want = {}
    try:
        jim._parse_env_blocks("TCE_DECODE_KOUTER", want)
    except ValueError:
        want = ValueError
    if want is ValueError:
        with pytest.raises(ValueError, match="TINYCHAT_DECODE_KOUTER"):
            tim._parse_env_blocks(table={})
    else:
        assert tim._parse_env_blocks(table={}) == want
    assert (spec in SPECS_ACCEPTED) == (want is not ValueError)


def test_decode_kouter_reads_only_its_own_variable(monkeypatch):
    """The port's switch is ``TINYCHAT_DECODE_KOUTER``, off by default; the
    JAX package's ``TCE_`` name fills nothing."""
    monkeypatch.delenv("TINYCHAT_DECODE_KOUTER", raising=False)
    monkeypatch.setenv("TCE_DECODE_KOUTER", "4096,28672:2048,1024")
    assert tim._parse_env_blocks(table={}) == {}
    monkeypatch.setenv("TINYCHAT_DECODE_KOUTER", "4096,28672:2048,1024")
    assert tim._parse_env_blocks(table={}) == {(4096, 28672): (2048, 1024)}


def test_cpu_call_ignores_the_table(monkeypatch):
    """A CPU call of ``int4_matmul`` runs ``int4_matmul_plain`` (JAX's
    ``int4_matmul_xla`` numerics) whatever the table lists, and launches
    nothing."""
    rng = np.random.default_rng(3)
    packed, scales = (numpy_to_torch(a) for a in _weights(rng, 1024, 512))
    x = numpy_to_torch(_bf16(rng.standard_normal((4, 1024))))
    monkeypatch.setattr(tim, "DECODE_KOUTER", {(1024, 512): (512, 1024)})
    assert tim.kouter_route(4, 1024, 512, True) == (512, 1024)
    _build.reset_launches()
    got = tim.int4_matmul(x, packed, scales, 128, layer_idx=1)
    want = tim.int4_matmul_plain(x, packed, scales, 128, layer_idx=1)
    assert torch.equal(got, want)
    assert not any(_build.LAUNCHES.values())


def test_kouter_wrapper_refuses_what_jax_refuses():
    """JAX's ``_int4_matmul_kouter`` asserts stacked weights and K/G % 8
    == 0, and its table the block rules; the port raises ValueError for
    each."""
    rng = np.random.default_rng(4)
    packed, scales = (numpy_to_torch(a) for a in _weights(rng, 1024, 512))
    x = numpy_to_torch(_bf16(rng.standard_normal((2, 1024))))
    kw = dict(block_n=512, block_k=512)
    with pytest.raises(ValueError, match="stacked"):
        tim.int4_matmul_kouter(x, packed[0], scales[0], 128, layer_idx=None,
                               **kw)
    for bn, bk in ((384, 512), (512, 384), (100, 512), (512, 128)):
        with pytest.raises(ValueError, match="block_n"):
            tim.int4_matmul_kouter(x, packed, scales, 128, layer_idx=0,
                                   block_n=bn, block_k=bk)
    p2, s2 = (numpy_to_torch(a) for a in _weights(rng, 512, 256))
    with pytest.raises(ValueError, match="K/G % 8"):
        tim.int4_matmul_kouter(x[:, :512], p2, s2, 128, layer_idx=0,
                               block_n=256, block_k=256)


@pytest.mark.parametrize("scale_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m", [1, 4, 20])
def test_glu_plain_matches_jax_kernel(m, scale_dtype):
    """``int4_matmul_glu_plain`` against interpret-mode ``int4_matmul_glu``
    (any M: JAX pads to 16), both layers; gu rounded to bf16 on both
    sides."""
    rng = np.random.default_rng(m)
    f, n = 512, 256
    packed, scales = _weights(rng, f, n, scale_dtype=scale_dtype)
    gu = _bf16(rng.standard_normal((m, 2 * f)) * 2.0)
    for li in (0, 1):
        want = jim.int4_matmul_glu(jnp.asarray(gu), jnp.asarray(packed),
                                   jnp.asarray(scales), 128,
                                   layer_idx=jnp.int32(li), interpret=True)
        got = tim.int4_matmul_glu(numpy_to_torch(gu), numpy_to_torch(packed),
                                  numpy_to_torch(scales), 128, layer_idx=li)
        assert got.shape == (m, n) and got.dtype == torch.bfloat16
        _within_a_bf16_step(got, want)


def test_glu_plain_against_the_unfused_composition():
    """The same function as int4_matmul (gate_up) -> silu * up -> int4_matmul
    (down) up to where they round: the unfused plain version rounds the
    dequantized weights to bf16. JAX's own test allows 0.06."""
    rng = np.random.default_rng(11)
    f, n = 512, 256
    packed, scales = (numpy_to_torch(a) for a in _weights(rng, f, n))
    gu = numpy_to_torch(_bf16(rng.standard_normal((4, 2 * f))))
    got = tim.int4_matmul_glu(gu, packed, scales, 128, layer_idx=1)
    g, u = gu[:, :f].float(), gu[:, f:].float()
    act = (torch.nn.functional.silu(g) * u).to(torch.bfloat16)
    want = tim.int4_matmul_plain(act, packed, scales, 128, layer_idx=1)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0.06, atol=0.06)


def test_glu_wrapper_refuses_what_jax_refuses():
    """JAX tiles F in superblocks and N in 128 columns and takes stacked
    weights only; the port raises ValueError for each."""
    rng = np.random.default_rng(12)
    packed, scales = (numpy_to_torch(a) for a in _weights(rng, 512, 256))
    gu = torch.zeros((2, 1024), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="stacked"):
        tim.int4_matmul_glu(gu, packed[0], scales[0], 128, layer_idx=None)
    with pytest.raises(ValueError, match="does not fit"):
        tim.int4_matmul_glu(gu[:, :1022], packed, scales, 128, layer_idx=0)
    with pytest.raises(ValueError, match="does not fit"):
        tim.int4_matmul_glu(torch.zeros((2, 768)), packed[:, :192],
                            scales[:, :3], 128, layer_idx=0)
    p2, s2 = (numpy_to_torch(a) for a in _weights(rng, 512, 192))
    with pytest.raises(ValueError, match="N % 128"):
        tim.int4_matmul_glu(gu, p2, s2, 128, layer_idx=0)


def glu_activation(gu: torch.Tensor, f: int) -> torch.Tensor:
    """The GLU kernel's activation (``glu_act_kernel``): bf16(sigmoid(g) *
    g * u) in f32 with sigmoid(g) = 1 / (1 + exp(-g)), g and u the two
    halves of bf16 gu [M, 2F]."""
    g, u = gu[:, :f].float(), gu[:, f:].float()
    return (1.0 / (1.0 + torch.exp(-g)) * g * u).to(torch.bfloat16)


@pytest.mark.parametrize("scale_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("gs", [32, 128])
@pytest.mark.parametrize("m", [1, 8, 16, 64])
def test_glu_mma_model_matches_jax_kernel(m, gs, scale_dtype):
    """The CUDA GLU kernel's arithmetic on the CPU (its activation, then
    ``mma_contraction`` over the bands ``glu_split`` picks) against
    interpret-mode ``int4_matmul_glu``, both layers, within one bf16
    step."""
    rng = np.random.default_rng(100 + m + gs)
    f, n = 1024, 256
    packed, scales = _weights(rng, f, n, scale_dtype=scale_dtype, gs=gs)
    gu = _bf16(rng.standard_normal((m, 2 * f)) * 2.0)
    per, _ = tim.glu_split(m, n, f)
    act = glu_activation(numpy_to_torch(gu), f)
    for li in (0, 1):
        want = jim.int4_matmul_glu(jnp.asarray(gu), jnp.asarray(packed),
                                   jnp.asarray(scales), gs,
                                   layer_idx=jnp.int32(li), interpret=True)
        got = mma_contraction(act, numpy_to_torch(packed)[li],
                              numpy_to_torch(scales)[li], gs, per)
        _within_a_bf16_step(got.to(torch.bfloat16), want)


@pytest.mark.parametrize("f,n", [(14336, 4096), (24576, 6144), (11008, 4096),
                                 (1024, 256), (512, 128)])
def test_glu_split_depends_on_f_and_n_alone_up_to_eight_rows(f, n):
    """``glu_split`` at llama3_8b's, StarCoder's and the tests' down shapes
    is the same at 1..8 rows (one 8-row tile), so a serving row's bits do
    not depend on how many slots are active; every band holds whole
    superblocks and the last one at least one; wider row tiles split F no
    finer."""
    splits = {tim.glu_split(m, n, f) for m in range(1, 9)}
    assert len(splits) == 1
    per, bands = splits.pop()
    nsb = f // SUPERBLOCK
    assert per * (bands - 1) < nsb <= per * bands
    for m in (16, 64, 100):
        per_m, bands_m = tim.glu_split(m, n, f)
        assert per_m * (bands_m - 1) < nsb <= per_m * bands_m
        assert bands_m <= bands


def test_chip_smoke_kouter_phase_rehearses_on_cpu():
    """chip_smoke.py's phase 4f on the CPU at a 2-layer size the K-outer
    kernel takes: the table is filled for the run and restored after, the
    run's metrics, the first-step and the teacher-forced comparisons come
    back, and the unfused tokens it is given are compared."""
    import chip_smoke
    cfg = ModelConfig(**KOUTER_LLAMA)
    params = llama.init_random_params(cfg, QuantConfig(scheme="w4a16"),
                                      seed=0, device="cpu")
    saved = dict(tim.DECODE_KOUTER)
    out = chip_smoke.kouter_engine(
        cfg, (params, QuantConfig(scheme="w4a16")), dev="cpu", long_len=128,
        n_predict=4, blocks=(512, 512), unfused_tokens=[0, 1, 2, 3])
    assert tim.DECODE_KOUTER == saved
    launches, per_step, metrics = out["run"]
    assert metrics["tokens"] and len(metrics["tokens"]) == 4
    assert out["first_step"]["rel_diff"] == 0.0  # the CPU ignores the table
    assert 0 <= out["tokens_agreeing"] <= 4
    e, f, d = cfg.embed_dim, cfg.hidden_dim, cfg.head_dim
    assert set(out["table"]) == {
        (e, (cfg.num_heads + 2 * cfg.num_kv_heads) * d),
        (cfg.num_heads * d, e), (e, 2 * f), (f, e)}
    assert out["first_step_kouter_prefill"]["rel_diff"] == 0.0
    # fed the run's own tokens, both table settings choose them again (the
    # CPU ignores the table) and agree step for step, whichever prefill
    forced = out["teacher_forced"]
    assert forced["steps"] == forced["self_agree"] == 4
    for ref in ("empty_own_prefill", "empty_kouter_prefill"):
        assert forced[ref]["agree"] == forced[ref]["steps_within"] == 4
        assert forced[ref]["max_rel_diff"] == 0.0
        assert forced[ref]["first_parting_step"] is None
    # the plain version at the TPU kernel's cast point (exact codes) is
    # another function than the CPU's int4_matmul_plain (bf16-rounded
    # weights): close, not equal
    plain = forced["plain"]
    assert 0.0 < plain["max_rel_diff"] <= chip_smoke.KOUTER_STEP_TOL
    assert plain["steps_within"] == 4
