"""The port's int4 matmuls, reference ops, quantizer and packer against the
JAX package, on the CPU (where the port's wrappers run their plain
versions). Inputs are made with numpy from a seed and fed to both sides."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tinychatengine_tpu.ops import int4_matmul as jim
from tinychatengine_tpu.ops import ref as jref
from tinychatengine_tpu.quant import numerics as jnum
from tinychatengine_tpu.quant import packing as jpack
from tinychatengine_tpu_torch.ops import _build
from tinychatengine_tpu_torch.ops import int4_matmul as tim
from tinychatengine_tpu_torch.ops import ref as tref
from tinychatengine_tpu_torch.quant import numerics as tnum
from tinychatengine_tpu_torch.quant import packing as tpack


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers: one intra-op thread per worker
    keeps torch's many small CPU ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    """numpy (bf16 via its bit pattern) → torch."""
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return tpack.from_bf16_bits(a.view(np.uint16))
    return torch.from_numpy(np.array(a))


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _weights(rng, k, n, gs=128, scale_dtype="f32", layers=None):
    """(packed, scales) numpy arrays in the QM_TPU layout, stacked when
    ``layers`` is given."""
    packs, scales = [], []
    for _ in range(layers or 1):
        w = (rng.standard_normal((n, k)) * 0.02).astype(np.float32)
        q, s = jnum.quantize_groupwise_int4(w, gs)
        packs.append(jpack.pack_qm_tpu(q, gs))
        scales.append(jpack.pack_scales(s, scale_dtype, gs))
    if layers is None:
        return packs[0], scales[0]
    return np.stack(packs), np.stack(scales)


def _x(rng, m, k):
    return rng.standard_normal((m, k)).astype(np.float32).astype(
        ml_dtypes.bfloat16)


# K=1152 at G=128 packs to K=2048 (packing.padded_ic): x is zero-padded
@pytest.mark.parametrize("k,scale_dtype", [(512, "f32"), (512, "bf16"),
                                           (1152, "bf16")])
def test_int4_matmul_plain_matches_xla(k, scale_dtype):
    rng = np.random.default_rng(0)
    packed, scales = _weights(rng, k, 384, scale_dtype=scale_dtype)
    x = _x(rng, 5, k)
    want = jim.int4_matmul_xla(jnp.asarray(x), jnp.asarray(packed),
                               jnp.asarray(scales), 128)
    got = tim.int4_matmul(_t(x), _t(packed), _t(scales), 128)
    assert got.dtype == torch.bfloat16 and got.shape == (5, 384)
    # same f32 math on the same bf16 operands; the sums may run in another
    # order, so allow one bf16 rounding step of the output
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=8e-3, atol=1e-3)


@pytest.mark.parametrize("k,scale_dtype", [(512, "f32"), (512, "bf16"),
                                           (1152, "bf16")])
def test_int4_matmul_a8_plain_matches_xla(k, scale_dtype):
    rng = np.random.default_rng(1)
    packed, scales = _weights(rng, k, 384, scale_dtype=scale_dtype)
    x = _x(rng, 3, k)
    xk = np.pad(x, ((0, 0), (0, 2 * packed.shape[0] - k)))
    want = jim.int4_matmul_a8_xla(jnp.asarray(xk), jnp.asarray(packed),
                                  jnp.asarray(scales), 128)
    got = tim.int4_matmul_a8(_t(x), _t(packed), _t(scales), 128)
    # identical int8 activation codes (division and half-to-even rounding
    # in both); the f32 sums differ only in order: one bf16 rounding step
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=8e-3, atol=1e-3)


def test_stacked_layer_idx_selects_layer():
    rng = np.random.default_rng(2)
    packed, scales = _weights(rng, 256, 128, scale_dtype="bf16", layers=3)
    x = _x(rng, 2, 256)
    for li in range(3):
        for fn, ref in ((tim.int4_matmul, jim.int4_matmul_xla),
                        (tim.int4_matmul_a8, jim.int4_matmul_a8_xla)):
            got = fn(_t(x), _t(packed), _t(scales), 128, layer_idx=li)
            want = ref(jnp.asarray(x), jnp.asarray(packed[li]),
                       jnp.asarray(scales[li]), 128)
            np.testing.assert_allclose(_f32(got), _f32(want), rtol=8e-3,
                                       atol=1e-3)


@pytest.mark.parametrize("a8", [False, True])
def test_plain_matches_pallas_interpret(a8):
    """The TPU kernel itself (interpret mode) at one stacked shape."""
    rng = np.random.default_rng(3)
    packed, scales = _weights(rng, 512, 256, scale_dtype="bf16", layers=2)
    x = _x(rng, 4, 512)
    pallas = jim.int4_matmul_a8 if a8 else jim.int4_matmul
    want = pallas(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scales),
                  128, layer_idx=jnp.int32(1), interpret=True)
    fn = tim.int4_matmul_a8 if a8 else tim.int4_matmul
    got = fn(_t(x), _t(packed), _t(scales), 128, layer_idx=1)
    # the Pallas kernel folds the zero point (d*(x.q) - 8d*sum x) and keeps
    # scales exact while the plain path rounds the weights to bf16 first:
    # a few bf16 rounding steps of the output
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-2, atol=2e-3)


def test_wrappers_refuse_bad_layouts():
    """Shape checks raise (they guard the kernels' pointers on the card)."""
    rng = np.random.default_rng(9)
    packed, scales = (_t(a) for a in _weights(rng, 256, 128, layers=2))
    x = _t(_x(rng, 2, 256))
    for fn in (tim.int4_matmul, tim.int4_matmul_a8):
        with pytest.raises(ValueError, match="layer_idx"):
            fn(x, packed, scales, 128, layer_idx=2)
        with pytest.raises(ValueError, match="layer_idx"):
            fn(x, packed, scales, 128)
        with pytest.raises(ValueError, match="does not fit"):
            fn(x, packed, scales[:, :1], 128, layer_idx=0)
        with pytest.raises(ValueError, match="does not fit"):
            fn(_t(_x(rng, 2, 384)), packed, scales, 128, layer_idx=0)


def test_cpu_path_launches_no_kernel():
    rng = np.random.default_rng(4)
    packed, scales = _weights(rng, 256, 128)
    _build.reset_launches()
    tim.int4_matmul(_t(_x(rng, 2, 256)), _t(packed), _t(scales), 128)
    tim.int4_matmul_a8(_t(_x(rng, 2, 256)), _t(packed), _t(scales), 128)
    assert all(v == 0 for v in _build.LAUNCHES.values())


@pytest.mark.parametrize("gs", [32, 64, 128])
def test_quantizer_and_packer_bit_exact(gs):
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((96, 1152)) * 0.05).astype(np.float32)
    w[:, :gs] = 0.0  # an all-zero group (d = 0)
    q, s = tnum.quantize_groupwise_int4(w, gs)
    jq, js = jnum.quantize_groupwise_int4(w, gs)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(tpack.pack_qm_tpu(q, gs),
                                  jpack.pack_qm_tpu(jq, gs))
    np.testing.assert_array_equal(
        tpack.unpack_qm_tpu(tpack.pack_qm_tpu(q[:, :1024])), q[:, :1024])
    np.testing.assert_array_equal(
        tpack.pack_scales(s, "bf16", gs),
        jpack.pack_scales(js, "bf16", gs).view(np.uint16))
    np.testing.assert_array_equal(tpack.pack_scales(s, "f32", gs),
                                  jpack.pack_scales(js, "f32", gs))
    assert tpack.padded_ic(1152, gs) == jpack.padded_ic(1152, gs)


def test_dequantize_matches_jax():
    rng = np.random.default_rng(6)
    packed, scales = _weights(rng, 512, 64, scale_dtype="bf16")
    want = jref.dequantize_int4(jnp.asarray(packed), jnp.asarray(scales), 128,
                                dtype=jnp.float32)
    got = tref.dequantize_int4(_t(packed), _t(scales), 128, torch.float32)
    np.testing.assert_array_equal(_f32(got), _f32(want))  # exact: (q-8)*d


def test_rms_norm_and_rotary_match_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 256)).astype(ml_dtypes.bfloat16)
    w = (1 + 0.1 * rng.standard_normal(256)).astype(ml_dtypes.bfloat16)
    # one bf16 rounding step: the f32 mean may be summed in another order
    np.testing.assert_allclose(
        _f32(tref.rms_norm_ref(_t(x), _t(w), 1e-5)),
        _f32(jref.rms_norm_ref(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        rtol=8e-3, atol=1e-6)
    cos, sin = jref.make_rope_cache(64, 32, 500000.0)
    tcos, tsin = tref.make_rope_cache(64, 32, 500000.0)
    # f32 transcendentals of two libraries: a few f32 ulps
    np.testing.assert_allclose(tcos.numpy(), np.asarray(cos), atol=2e-6)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(sin), atol=2e-6)
    q = rng.standard_normal((2, 5, 4, 64)).astype(ml_dtypes.bfloat16)
    k = rng.standard_normal((2, 5, 2, 64)).astype(ml_dtypes.bfloat16)
    pos = np.array([[3, 4, 5, 6, 7], [0, 1, 2, 3, 4]])
    jq, jk = jref.apply_rotary(jnp.asarray(q), jnp.asarray(k), cos[pos],
                               sin[pos])
    tq, tk = tref.apply_rotary(_t(q), _t(k), torch.from_numpy(
        np.asarray(cos)[pos]), torch.from_numpy(np.asarray(sin)[pos]))
    np.testing.assert_allclose(_f32(tq), _f32(jq), rtol=8e-3, atol=1e-6)
    np.testing.assert_allclose(_f32(tk), _f32(jk), rtol=8e-3, atol=1e-6)


@pytest.mark.parametrize("stacked", [True, False])
def test_int4_matmul_route_choice(monkeypatch, stacked):
    """A CUDA call of int4_matmul picks its route from M: the band route at
    M <= 8, stacked or not (the unstacked lm_head too), the tile route from
    9 rows; a shape listed in DECODE_KOUTER goes to the K-outer kernel
    first, as JAX's gate says (stacked only). The band's split comes from K
    and N alone and keeps about two blocks per SM streaming the weight."""
    monkeypatch.setattr(tim, "DECODE_KOUTER", {})
    shapes = ((4096, 6144), (4096, 28672), (14336, 4096), (4096, 129024),
              (512, 392))
    for kw, n in shapes:
        for m in range(1, 9):
            route, (per, bands) = tim.int4_route(m, kw, n, stacked)
            assert route == "band" and (per, bands) == tim.band_split(kw, n)
            nsb = kw // tpack.SUPERBLOCK
            assert per * bands >= nsb > per * (bands - 1)
            assert bands == nsb or -(-n // 128) * bands >= 264
        for m in (9, 64, 65, 130, 497, 2048):
            assert tim.int4_route(m, kw, n, stacked) == (
                "tile", (tim.tile_width(m), tim.tile_split(kw, n)))
    monkeypatch.setattr(tim, "DECODE_KOUTER", {(4096, 28672): (2048, 1024)})
    for m in (1, 8, 9, 496):
        assert tim.int4_route(m, 4096, 28672, stacked)[0] == (
            "kouter" if stacked else "band" if m <= 8 else "tile")
    assert tim.int4_route(497, 4096, 28672, stacked) == ("tile", (256, 1))


# StarCoder-15.5B's linears (packed K, N) and the tile route's K split
STARCODER_SPLITS = {"c_attn": ((6144, 6400), 4), "c_proj": ((6144, 6144), 4),
                    "fc_in": ((6144, 24576), 1), "fc_out": ((24576, 6144), 4),
                    "lm_head": ((6144, 49152), 1)}


@pytest.mark.parametrize("name", list(STARCODER_SPLITS))
def test_int4_matmul_tile_geometry(name):
    """The tile route's launch geometry, from the shape alone: the token
    tile is the smallest of 16 / 32 / 64 / 128 / 256 rows that holds M
    (256-row tiles above), the K split comes from K and N alone (the same
    at every M; a power of two, one cluster of at most 8 blocks, at least
    two 128-k stages a block, at most about two blocks an SM over the
    column tiles)."""
    widths = {9: 16, 16: 16, 17: 32, 33: 64, 64: 64, 65: 128, 128: 128,
              129: 256, 256: 256, 257: 256, 512: 256}
    assert {m: tim.tile_width(m) for m in widths} == widths
    (kw, n), split = STARCODER_SPLITS[name]
    assert tim.tile_split(kw, n) == split
    tiles = -(-n // tim.TILE_COLS)
    assert split & (split - 1) == 0
    assert split == 1 or split * tiles <= 264 < 2 * split * tiles
    for m in (9, 16, 64, 256, 257, 512):
        assert tim.int4_route(m, kw, n, True) == ("tile",
                                                  (widths[m], split))
    assert tim.tile_split(4096, 28672) == 1  # gate_up: 224 column tiles
    assert tim.tile_split(256, 392) == 1  # two stages: no split
    assert tim.tile_split(1280, 392) == 4  # 2-3 stages a block
    assert tim.tile_split(4096, 4096) == 8  # llama3_8b's wo: one full cluster


def test_int4_matmul_tile_width_counter():
    """The tile route's launches by token-tile width sit beside LAUNCHES:
    reset with it, and a captured graph adds its body's widths at every
    replay; a counter registered while a graph is captured leaves it
    registered, also when both are empty (equal dicts)."""
    _build.reset_launches()
    with _build.counting({}):
        with _build.record_launches() as delta:
            tim._count_tile(16)
    assert _build.TILE_LAUNCHES == {}
    assert any(c is _build.TILE_LAUNCHES for c in _build.COUNTERS)
    delta.add()
    delta.add()
    tim._count_tile(256)
    assert _build.TILE_LAUNCHES == {16: 2, 256: 1}
    _build.reset_launches()
    assert _build.TILE_LAUNCHES == {}
