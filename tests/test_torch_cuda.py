"""The port's CUDA kernels against their plain versions at small shapes,
on the card. Marked ``gpu``; each test skips without a CUDA device. This
file imports neither jax nor the JAX package, so it also runs where those
are absent (the machine with the card):

    python -m pytest --noconftest -q tests/test_torch_cuda.py -m gpu

(from the root of the checkout, which puts ``chip_smoke`` on the path)

(``chip_smoke.py`` makes the same checks at full size.)"""

import time

import numpy as np
import pytest
import torch

from chip_smoke import attn_err, int8_err
from tinychatengine_tpu_torch.ops import _build
from tinychatengine_tpu_torch.ops import attention as att
from tinychatengine_tpu_torch.ops import int3_matmul as i3
from tinychatengine_tpu_torch.ops import int4_matmul as im
from tinychatengine_tpu_torch.ops.linear import quantized_linear
from tinychatengine_tpu_torch.ops.ref import make_rope_cache

pytestmark = pytest.mark.gpu

# max |kernel - plain| <= MAT_TOL * max |plain|: the plain versions round
# the dequantized weights (W4A16) to bf16 and sum in another order
MAT_TOL = 1e-2
# attention: chip_smoke.attn_err, element by element, 2^-6 of the element
# plus its row's largest value (the plain versions normalise before the bf16
# cast of the probabilities, the kernels after it)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bf16(rng, shape, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dev).to(torch.bfloat16)


@pytest.mark.parametrize("k,scale_dtype", [(512, "bf16"), (1152, "f32")])
@pytest.mark.parametrize("m", [1, 7, 130])
def test_int4_kernels_match_plain(cuda, k, scale_dtype, m):
    rng = np.random.default_rng(m)
    lins = [quantized_linear(rng.standard_normal((256, k)).astype(np.float32)
                             * 0.02, 128, scale_dtype) for _ in range(2)]
    packed = torch.stack([p.packed for p in lins]).to(cuda)
    scales = torch.stack([p.scales for p in lins]).to(cuda)
    x = _bf16(rng, (m, k), cuda)
    _build.reset_launches()
    for fn, plain in ((im.int4_matmul, im.int4_matmul_plain),
                      (im.int4_matmul_a8, im.int4_matmul_a8_plain)):
        got = fn(x, packed, scales, 128, layer_idx=1).float()
        want = plain(x, packed, scales, 128, layer_idx=1).float()
        torch.cuda.synchronize()
        assert (got - want).abs().max() <= MAT_TOL * want.abs().max()
    assert _build.LAUNCHES["int4_matmul"] == _build.LAUNCHES["int4_matmul_a8"] == 1


@pytest.mark.parametrize("d", [64, 128])
def test_attention_kernels_match_plain(cuda, d):
    rng = np.random.default_rng(d)
    k = _bf16(rng, (2, 2, 2, 256, d), cuda)
    v = _bf16(rng, (2, 2, 2, 256, d), cuda)
    q = _bf16(rng, (2, 8, d), cuda)
    lengths = torch.tensor([5, 256], dtype=torch.int32, device=cuda)
    for window in (None, 100):
        got = att.flash_decode(q, k, v, 1, lengths, window=window).float()
        want = att.flash_decode_plain(q, k, v, 1, lengths,
                                      window=window).float()
        assert attn_err(got, want, d)[1] <= 1.0
    qp = _bf16(rng, (2, 70, 8, d), cuda)
    starts = torch.tensor([0, 100], dtype=torch.int32, device=cuda)
    for start, length in ((100, 160), (starts, starts + 60)):
        got = att.flash_prefill(qp, k, v, 0, start, length).float()
        want = att.flash_prefill_plain(qp, k, v, 0, start, length).float()
        assert not torch.isnan(got).any()
        assert attn_err(got, want, d)[1] <= 1.0
    with pytest.raises(ValueError):  # int8 codes need their scales
        att.flash_decode(q, k.to(torch.int8), v.to(torch.int8), 0, 5)


@pytest.mark.parametrize("d,p", [(128, 128), (128, 16), (64, 16), (64, 64)])
def test_paged_decode_kernel_matches_plain(cuda, d, p):
    """flash_decode_paged on a shuffled page table with ragged lengths (a
    row of length 0 gives zeros), with and without a window; and paged
    against dense decode of the same keys, which visit the same tiles in
    the same order: bit-identical outputs."""
    rng = np.random.default_rng(d + p)
    b, hq, hkv, max_len = 4, 8, 2, 320
    mp = -(-max_len // p)
    n_pages = b * mp + 1
    table = torch.from_numpy(
        rng.permutation(n_pages)[:b * mp].reshape(b, mp).astype(np.int32)
    ).to(cuda)
    pk = _bf16(rng, (2, n_pages, hkv, p, d), cuda)
    pv = _bf16(rng, (2, n_pages, hkv, p, d), cuda)
    q = _bf16(rng, (b, hq, d), cuda)
    lengths = torch.tensor([1, 37, p + 1, max_len], dtype=torch.int32,
                           device=cuda)
    _build.reset_launches()
    for window in (None, 100):
        got = att.flash_decode_paged(q, pk, pv, 1, lengths, table,
                                     window=window).float()
        want = att.flash_decode_paged_plain(q, pk, pv, 1, lengths, table,
                                            window=window).float()
        torch.cuda.synchronize()
        assert attn_err(got, want, d)[1] <= 1.0
    assert _build.LAUNCHES["flash_decode_paged"] == 2
    # the same keys as a dense [L, B, Hkv, S, D] cache
    ck, cv = (torch.stack([att.gather_pages(pk, pv, li, table)[i]
                           for li in range(2)]) for i in (0, 1))
    dense = att.flash_decode(q, ck.contiguous(), cv.contiguous(), 1, lengths)
    paged = att.flash_decode_paged(q, pk, pv, 1, lengths, table)
    assert torch.equal(dense, paged)
    zero = att.flash_decode_paged(q, pk, pv, 1, torch.zeros_like(lengths),
                                  table)
    assert torch.equal(zero, torch.zeros_like(zero))
    with pytest.raises(ValueError):  # scales of the wrong shape
        att.flash_decode_paged(q, pk.to(torch.int8), pv.to(torch.int8), 0,
                               lengths, table,
                               torch.ones(pk.shape[:-2], device=cuda),
                               torch.ones(pk.shape[:-2], device=cuda))


@pytest.mark.parametrize("hq,hkv", [(48, 1), (32, 2)])
@pytest.mark.parametrize("d", [64, 128])
def test_decode_kernels_take_more_than_8_heads_per_kv_head(cuda, d, hq, hkv):
    """MQA (StarCoder's G = 48: six blocks of 8 query heads per KV head)
    and G = 16: dense and paged decode against their plain versions, and
    bit-identical to each other on the same keys."""
    rng = np.random.default_rng(hq + d)
    b, p, max_len = 3, 64, 320
    mp = max_len // p
    k = _bf16(rng, (2, b, hkv, max_len, d), cuda)
    v = _bf16(rng, (2, b, hkv, max_len, d), cuda)
    q = _bf16(rng, (b, hq, d), cuda)
    lengths = torch.tensor([1, 130, max_len], dtype=torch.int32, device=cuda)
    table = torch.from_numpy(rng.permutation(b * mp).reshape(b, mp).astype(
        np.int32) + 1).to(cuda)
    pk = torch.zeros((2, b * mp + 1, hkv, p, d), dtype=torch.bfloat16,
                     device=cuda)
    pv = torch.zeros_like(pk)
    for pool, c in ((pk, k), (pv, v)):
        pool[:, table.reshape(-1).long()] = c.reshape(
            2, b, hkv, mp, p, d).transpose(2, 3).reshape(2, b * mp, hkv, p, d)
    _build.reset_launches()
    dense = att.flash_decode(q, k, v, 1, lengths)
    paged = att.flash_decode_paged(q, pk, pv, 1, lengths, table)
    want = att.flash_decode_plain(q, k, v, 1, lengths).float()
    assert attn_err(dense.float(), want, d)[1] <= 1.0
    assert torch.equal(dense, paged)
    assert _build.LAUNCHES["flash_decode"] == _build.LAUNCHES[
        "flash_decode_paged"] == 1


def _int8_kv(rng, shape, dev):
    """int8 codes [..., D] and positive f32 scales [...] on ``dev``."""
    codes = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
    scales = torch.from_numpy((rng.random(shape[:-1]) * 0.03 + 0.005)
                              .astype(np.float32))
    return codes.to(dev), scales.to(dev)


def _pool(c, table, p):
    """A [L, B, H, S, ...] cache as a page pool [L, n_pages, H, P, ...]
    under ``table`` (page 0 left zero)."""
    L, b, h, s = c.shape[:4]
    mp = s // p
    pool = torch.zeros((L, b * mp + 1, h, p, *c.shape[4:]), dtype=c.dtype,
                       device=c.device)
    pool[:, table.reshape(-1).long()] = c.reshape(
        L, b, h, mp, p, *c.shape[4:]).transpose(2, 3).reshape(
            L, b * mp, h, p, *c.shape[4:])
    return pool


@pytest.mark.parametrize("d", [64, 128])
def test_int8_attention_kernels_match_plain(cuda, d):
    """The int8-KV kernels against their plain versions (which dequantize
    to bf16 first, a different rounding of the same function), held to
    attn_err: decode with ragged lengths and a window, prefill at start 0
    and at start > 0 (scalar, and ragged per row, as a prefix hit's tail).
    Only the int8 counters move."""
    rng = np.random.default_rng(100 + d)
    k, ks = _int8_kv(rng, (2, 2, 2, 320, d), cuda)
    v, vs = _int8_kv(rng, (2, 2, 2, 320, d), cuda)
    q = _bf16(rng, (2, 8, d), cuda)
    lengths = torch.tensor([5, 320], dtype=torch.int32, device=cuda)
    _build.reset_launches()
    for window in (None, 100):
        got = att.flash_decode(q, k, v, 1, lengths, ks, vs, window=window)
        want = att.flash_decode_plain(q, k, v, 1, lengths, ks, vs,
                                      window=window)
        torch.cuda.synchronize()
        assert attn_err(got, want, d)[1] <= 1.0
    qp = _bf16(rng, (2, 70, 8, d), cuda)
    starts = torch.tensor([0, 192], dtype=torch.int32, device=cuda)
    for start, length in ((0, 64), (192, 250), (starts, starts + 60)):
        got = att.flash_prefill(qp, k, v, 0, start, length, ks, vs)
        want = att.flash_prefill_plain(qp, k, v, 0, start, length, ks, vs)
        torch.cuda.synchronize()
        assert not torch.isnan(got).any()
        assert attn_err(got, want, d)[1] <= 1.0
    assert {n: c for n, c in _build.LAUNCHES.items() if c} == {
        "flash_decode_int8": 2, "flash_prefill_int8": 3}


@pytest.mark.parametrize("hq,hkv", [(8, 2), (48, 1)])
@pytest.mark.parametrize("d,p", [(128, 128), (64, 16)])
def test_int8_paged_decode_bit_identical_to_dense(cuda, d, p, hq, hkv):
    """int8 pages under a shuffled table, ragged lengths (0 gives zeros),
    GQA and MQA's G = 48: paged equals dense decode of the same codes and
    scales bit for bit, and both hold to the plain versions."""
    rng = np.random.default_rng(d + p + hq)
    b, max_len = 4, 384
    mp = max_len // p
    k, ks = _int8_kv(rng, (2, b, hkv, max_len, d), cuda)
    v, vs = _int8_kv(rng, (2, b, hkv, max_len, d), cuda)
    table = torch.from_numpy(rng.permutation(b * mp).reshape(b, mp).astype(
        np.int32) + 1).to(cuda)
    pk, pv, pks, pvs = (_pool(c, table, p) for c in (k, v, ks, vs))
    q = _bf16(rng, (b, hq, d), cuda)
    lengths = torch.tensor([0, 37, p + 1, max_len], dtype=torch.int32,
                           device=cuda)
    _build.reset_launches()
    for window in (None, 100):
        dense = att.flash_decode(q, k, v, 1, lengths, ks, vs, window=window)
        paged = att.flash_decode_paged(q, pk, pv, 1, lengths, table, pks,
                                       pvs, window=window)
        want = att.flash_decode_plain(q, k, v, 1, lengths, ks, vs,
                                      window=window)
        torch.cuda.synchronize()
        assert torch.equal(dense, paged)
        assert torch.equal(dense[0], torch.zeros_like(dense[0]))
        assert attn_err(dense[1:], want[1:], d)[1] <= 1.0
    assert {n: c for n, c in _build.LAUNCHES.items() if c} == {
        "flash_decode_int8": 2, "flash_decode_paged_int8": 2}


def _fused_operands(rng, m, k, n, group_size, scale_dtype, dev):
    lins = [quantized_linear(rng.standard_normal((n, k)).astype(np.float32)
                             * 0.02, group_size, scale_dtype)
            for _ in range(2)]
    cos, sin = make_rope_cache(128, 64, device="cpu")
    pos = torch.from_numpy(rng.integers(0, 64, m))
    return dict(
        x=_bf16(rng, (m, k), dev) * 2.0 + 0.5,
        packed=torch.stack([p.packed for p in lins]).to(dev),
        scales=torch.stack([p.scales for p in lins]).to(dev),
        norm_w=_bf16(rng, (2, k), dev) * 0.3 + 1.0,
        norm_b=_bf16(rng, (2, k), dev) * 0.2,
        bias=torch.from_numpy(rng.standard_normal((2, n)).astype(
            np.float32) * 0.05).to(dev),
        residual=_bf16(rng, (m, n), dev),
        rope_cos=cos[pos].to(dev), rope_sin=sin[pos].to(dev))


FUSED_VARIANTS = {  # the parts each model's call sites fold in
    "plain": (),
    "rmsnorm_rope": ("norm_w", "rope"),             # llama qkv
    "layernorm_bias": ("norm_w", "norm_b", "bias"),  # StarCoder c_attn
    "bias_residual": ("bias", "residual"),          # StarCoder fc_out
}


@pytest.mark.parametrize("variant", list(FUSED_VARIANTS))
@pytest.mark.parametrize("m,group_size,scale_dtype",
                         [(1, 128, "bf16"), (1, 32, "f32"), (8, 64, "bf16"),
                          (11, 128, "f32"), (2, 32, "bf16"), (5, 128, "f32"),
                          (8, 128, "f32")])
def test_int4_matmul_fused_matches_plain(cuda, variant, m, group_size,
                                         scale_dtype):
    """K = 1024 (four superblocks, split over blocks at these M) and
    N = 512; the roped q|k columns and the pass-through columns are held
    apart, each to its own largest value (chip_smoke.py's check). Every
    row count runs the tensor-core contraction (11 rows: a 16-row
    tile)."""
    rng = np.random.default_rng(m + group_size)
    k, n, qk = 1024, 512, 384
    ops = _fused_operands(rng, m, k, n, group_size, scale_dtype, cuda)
    kw = {}
    for part in FUSED_VARIANTS[variant]:
        if part == "rope":
            kw.update(rope_cos=ops["rope_cos"], rope_sin=ops["rope_sin"],
                      rope_qk_cols=qk, head_dim=128)
        else:
            kw[part] = ops[part]
    _build.reset_launches()
    got = im.int4_matmul_fused(ops["x"], ops["packed"], ops["scales"],
                               group_size, layer_idx=1, **kw).float()
    want = im.int4_matmul_fused_plain(ops["x"], ops["packed"], ops["scales"],
                                      group_size, layer_idx=1, **kw).float()
    torch.cuda.synchronize()
    assert _build.LAUNCHES["int4_matmul_fused"] == 1
    assert got.shape == (m, n)
    regions = ((slice(0, qk), slice(qk, n)) if "rope" in kw
               else (slice(0, n),))
    for cols in regions:
        w = want[:, cols]
        assert (got[:, cols] - w).abs().max() <= MAT_TOL * w.abs().max()


@pytest.mark.parametrize("d", [64, 128])
def test_int8_decode_kernel_matches_plain(cuda, d):
    """int8_decode over ragged lengths: a row of length 0 gives zeros, 333
    keys end inside no tile, 4500 keys pass the kernel's 4096-key chunk
    (scores recomputed in each pass); held in units of pv_alpha as
    chip_smoke.int8_err holds it, with the alphas as floats and as f32
    tensors on the card, and an int length."""
    rng = np.random.default_rng(d)
    shape = (2, 4, 4, 4608, d)  # [L, B, H, S_max, D]

    def s8(shp):
        return torch.from_numpy(rng.integers(-127, 128, shp).astype(np.int8)
                                ).to(cuda)
    ck, cv, q = s8(shape), s8(shape), s8((4, 4, d))
    lengths = torch.tensor([0, 1, 333, 4500], dtype=torch.int32, device=cuda)
    _build.reset_launches()
    for qk, pv in ((3e-5, 1e-3), (torch.tensor(3e-5, device=cuda),
                                  torch.tensor(1e-3, device=cuda))):
        got = att.int8_decode(q, ck, cv, 1, lengths, qk, pv)
        want = att.int8_decode_plain(q, ck, cv, 1, lengths, qk, pv)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.shape == (4, 4, d)
        assert int8_err(got, want, 1e-3)[2] <= 1.0
        assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert _build.LAUNCHES["int8_decode"] == 2
    got = att.int8_decode(q, ck, cv, 0, 333, 3e-5, 1e-3)
    want = att.int8_decode_plain(q, ck, cv, 0, 333, 3e-5, 1e-3)
    assert int8_err(got, want, 1e-3)[2] <= 1.0
    with pytest.raises(ValueError):
        att.int8_decode(q, ck.to(torch.bfloat16), cv, 0, lengths, 3e-5, 1e-3)


def test_int8_decode_split_bits_depend_on_key_positions_only(cuda):
    """int8_decode's split: a row alone (a scalar length, so a grid of
    int8_splits(length) chunks) gives the same bits as the same row inside a
    B = 8 batch (device lengths, int8_splits(S) chunks), lengths about the
    64-key chunk edges and past the old kernel's 4096-key chunk, a row of
    length 0 gives zeros, a scalar length equals a tensor of it, and the
    counter moves once per call."""
    rng = np.random.default_rng(41)
    lengths = (0, 1, 63, 64, 65, 320, 2047, 4500)
    b, h, d, smax = len(lengths), 4, 128, 4608

    def s8(shp):
        return torch.from_numpy(rng.integers(-127, 128, shp).astype(np.int8)
                                ).to(cuda)
    ck, cv, q = s8((2, b, h, smax, d)), s8((2, b, h, smax, d)), s8((b, h, d))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    _build.reset_launches()
    batch = att.int8_decode(q, ck, cv, 1, lens, 3e-5, 1e-3)
    assert _build.LAUNCHES["int8_decode"] == 1
    want = att.int8_decode_plain(q, ck, cv, 1, lens, 3e-5, 1e-3)
    torch.cuda.synchronize()
    assert int8_err(batch, want, 1e-3)[2] <= 1.0
    assert torch.equal(batch[0], torch.zeros_like(batch[0]))
    for r, n in enumerate(lengths):
        one = att.int8_decode(q[r:r + 1], ck[:, r:r + 1].contiguous(),
                              cv[:, r:r + 1].contiguous(), 1, n, 3e-5, 1e-3)
        assert torch.equal(one[0], batch[r]), n
    assert _build.LAUNCHES["int8_decode"] == 1 + len(lengths)
    for n in (65, 4500):
        same = torch.full((b,), n, dtype=torch.int32, device=cuda)
        assert torch.equal(att.int8_decode(q, ck, cv, 0, n, 3e-5, 1e-3),
                           att.int8_decode(q, ck, cv, 0, same, 3e-5, 1e-3))


# flash_prefill's cases: (D, Hq, Hkv); S = 100 rows (not a multiple of the
# 64-row query tile), ragged device starts and lengths at B = 4 with rows
# past their true length, with and without a window
PREFILL_HEADS = [(128, 8, 2), (64, 8, 2), (128, 48, 1)]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("d,hq,hkv", PREFILL_HEADS)
def test_flash_prefill_kernel_ragged_window_and_heads(cuda, d, hq, hkv,
                                                      int8):
    """flash_prefill (bf16 and int8 KV) against its plain version
    (attn_err) over ragged device start/length, a window, D = 64, MQA and
    S = 100; rows with no allowed key (past the true length, beyond the
    window) give zeros; a row run alone with scalar start/length gives the
    batch's bits."""
    rng = np.random.default_rng(d + hq + int8)
    b, s, smax = 4, 100, 384
    starts, true_len = (0, 37, 130, 250), (100, 60, 17, 100)
    if int8:
        k, ks = _int8_kv(rng, (2, b, hkv, smax, d), cuda)
        v, vs = _int8_kv(rng, (2, b, hkv, smax, d), cuda)
    else:
        k, v = (_bf16(rng, (2, b, hkv, smax, d), cuda) for _ in range(2))
        ks = vs = None
    q = _bf16(rng, (b, s, hq, d), cuda)
    st = torch.tensor(starts, dtype=torch.int32, device=cuda)
    ln = st + torch.tensor(true_len, dtype=torch.int32, device=cuda)
    name = "flash_prefill_int8" if int8 else "flash_prefill"
    col = torch.arange(smax, device=cuda)
    qpos = st[:, None, None].long() + torch.arange(s, device=cuda)[:, None]
    for window in (None, 70):
        _build.reset_launches()
        got = att.flash_prefill(q, k, v, 1, st, ln, ks, vs, window=window)
        want = att.flash_prefill_plain(q, k, v, 1, st, ln, ks, vs,
                                       window=window)
        torch.cuda.synchronize()
        assert _build.LAUNCHES[name] == 1
        allowed = (col < torch.minimum(qpos + 1, ln[:, None, None])) & (
            col > qpos - (window or smax + 1))
        some = allowed.any(-1)  # [B, S]: rows with an allowed key
        assert not torch.isnan(got).any()
        assert attn_err(got[some], want[some], d)[1] <= 1.0
        assert not got[~some].any()
        assert window or some.all()
        for r in range(b):
            one = att.flash_prefill(
                q[r:r + 1], k[:, r:r + 1].contiguous(),
                v[:, r:r + 1].contiguous(), 1, starts[r],
                starts[r] + true_len[r],
                None if ks is None else ks[:, r:r + 1].contiguous(),
                None if vs is None else vs[:, r:r + 1].contiguous(),
                window=window)
            assert torch.equal(one[0], got[r]), (r, window)


def _int4_stack(rng, k, n, scale_dtype, dev, layers=2, group_size=128):
    lins = [quantized_linear(rng.standard_normal((n, k)).astype(np.float32)
                             * 0.02, group_size, scale_dtype)
            for _ in range(layers)]
    return (torch.stack([p.packed for p in lins]).to(dev),
            torch.stack([p.scales for p in lins]).to(dev))


def _mat_ok(got, want):
    torch.cuda.synchronize()
    return (got.float() - want.float()).abs().max() \
        <= MAT_TOL * want.float().abs().max()


@pytest.mark.parametrize("scale_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("k", [1024, 1152])
@pytest.mark.parametrize("m", [1, 7, 130, 496, 497])
def test_kouter_route_runs_the_kernel(cuda, monkeypatch, m, k, scale_dtype):
    """``int4_matmul`` with the shape listed: the K-outer kernel below 497
    rows (against its plain version), ``int4_matmul`` from 497 on; K = 1152
    is pack-padded to 2048."""
    rng = np.random.default_rng(m + k)
    packed, scales = _int4_stack(rng, k, 512, scale_dtype, cuda)
    kw = 2 * packed.shape[-2]
    monkeypatch.setattr(im, "DECODE_KOUTER", {(kw, 512): (256, 512)})
    x = _bf16(rng, (m, k), cuda)
    _build.reset_launches()
    got = im.int4_matmul(x, packed, scales, 128, layer_idx=1)
    routed = m <= 496
    assert _build.LAUNCHES["int4_matmul_kouter"] == int(routed)
    assert _build.LAUNCHES["int4_matmul"] == int(not routed)
    want = im.int4_matmul_kouter_plain(x, packed, scales, 128, layer_idx=1,
                                       block_n=256, block_k=512)
    assert _mat_ok(got, want)


@pytest.mark.parametrize("scale_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("g", [32, 64, 128])
@pytest.mark.parametrize("m", [1, 2, 16, 64, 130, 496])
def test_kouter_tensor_core_route_matches_plain(cuda, m, g, scale_dtype):
    """The K-outer kernel's tensor-core contraction against its plain version:
    K = 2048 in bands of 512 (four bands of two superblocks), N = 384
    (three column tiles), layers 0 and 2 of a stack; 130 and 496 rows
    leave the last 64-row tile partial. (The table's block_k divides K, so
    a K-outer band is never ragged; the fused kernel's ragged split runs
    the same routine below.)"""
    rng = np.random.default_rng(m + g)
    packed, scales = _int4_stack(rng, 2048, 384, scale_dtype, cuda, 3, g)
    x = _bf16(rng, (m, 2048), cuda)
    kw = dict(block_n=128, block_k=512)
    _build.reset_launches()
    for li in (0, 2):
        got = im.int4_matmul_kouter(x, packed, scales, g, layer_idx=li, **kw)
        assert _mat_ok(got, im.int4_matmul_kouter_plain(
            x, packed, scales, g, layer_idx=li, **kw))
    assert _build.LAUNCHES["int4_matmul_kouter"] == 2


def test_int4_matmul_fused_ragged_last_split(cuda):
    """Eight rows where the K split does not divide the superblocks: K =
    2816 (11 superblocks) over N = 24576 splits in 6 ranges of 2, the last
    holding one; G = 32, LayerNorm, bias and residual folded in; random
    packed bytes made on the card."""
    m, k, n, g = 8, 2816, 24576, 32
    per, ksplit = im.fused_kernel_split(m, n, k)
    assert (k // 256) % per and (per, ksplit) == (2, 6)
    gen = torch.Generator(device=cuda).manual_seed(11)
    packed = torch.randint(0, 256, (2, k // 2, n), dtype=torch.uint8,
                           device=cuda, generator=gen)
    scales = (torch.rand((2, k // g, n), device=cuda, generator=gen) * 0.02
              + 0.005).to(torch.bfloat16)

    def randn(*shape):
        return torch.randn(shape, device=cuda, generator=gen)
    x = (randn(m, k) * 2.0 + 0.5).to(torch.bfloat16)
    kw = dict(norm_w=(randn(2, k) * 0.3 + 1.0).to(torch.bfloat16),
              norm_b=(randn(2, k) * 0.2).to(torch.bfloat16),
              bias=randn(2, n) * 0.05,
              residual=randn(m, n).to(torch.bfloat16))
    got = im.int4_matmul_fused(x, packed, scales, g, layer_idx=1, **kw)
    assert _mat_ok(got, im.int4_matmul_fused_plain(x, packed, scales, g,
                                                   layer_idx=1, **kw))


@pytest.mark.parametrize("kernel,m,rows",
                         [("kouter", 496, (1, 2, 7, 16, 64, 130)),
                          ("fused", 8, (1, 2, 5, 7)),
                          ("glu", 8, (1, 2, 5, 7)),
                          ("int3", 8, (1, 2, 5, 7))])
def test_tensor_core_rows_are_independent(cuda, kernel, m, rows):
    """An output row's bits depend on its x row alone: the kernel on x[:r]
    equals its rows of the kernel on x bit for bit, whatever row tile (8 to
    64 rows) each call takes, one row included (the GLU and int3 kernels'
    K splits are the same from 1 to 8 rows)."""
    rng = np.random.default_rng(m)
    if kernel == "glu":
        packed, scales = _int4_stack(rng, 2048, 256, "bf16", cuda,
                                     group_size=64)
        x = _bf16(rng, (m, 4096), cuda)

        def call(xr):
            return im.int4_matmul_glu(xr, packed, scales, 64, layer_idx=1)
    elif kernel == "int3":
        pa, pb, scales = _int3_weights(rng, 2048, 272, 32, cuda)
        x = _bf16(rng, (m, 2048), cuda)

        def call(xr):
            return i3.int3_matmul(xr, pa, pb, scales, group_size=32)
    elif kernel == "kouter":
        packed, scales = _int4_stack(rng, 1024, 640, "bf16", cuda,
                                     group_size=64)
        x = _bf16(rng, (m, 1024), cuda)

        def call(xr):
            return im.int4_matmul_kouter(xr, packed, scales, 64, layer_idx=1,
                                         block_n=128, block_k=512)
    else:
        ops = _fused_operands(rng, m, 1024, 512, 128, "f32", cuda)
        x = ops["x"]

        def call(xr):
            return im.int4_matmul_fused(
                xr, ops["packed"], ops["scales"], 128, layer_idx=1,
                norm_w=ops["norm_w"], norm_b=ops["norm_b"], bias=ops["bias"],
                residual=ops["residual"][:xr.shape[0]])
    full = call(x)
    for r in rows:
        assert torch.equal(call(x[:r]), full[:r]), r


@pytest.mark.parametrize("scale_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("g", [32, 64, 128])
@pytest.mark.parametrize("m", [1, 2, 8, 9, 16, 64, 65, 100])
def test_int4_matmul_a8_tensor_core_matches_plain(cuda, m, g, scale_dtype):
    """The W4A8 kernel on the int8 tensor cores against its plain version:
    K = 2048 over N = 384 (``a8_split``: 8 bands of one superblock, one
    cluster a tile), layers 0 and 2 of a stack; 9, 65 and 100 rows leave
    the last row tile partial."""
    rng = np.random.default_rng(m + g)
    packed, scales = _int4_stack(rng, 2048, 384, scale_dtype, cuda, 3, g)
    assert im.a8_split(2048, 384) == (1, 8)
    x = _bf16(rng, (m, 2048), cuda)
    _build.reset_launches()
    for li in (0, 2):
        got = im.int4_matmul_a8(x, packed, scales, g, layer_idx=li)
        assert _mat_ok(got, im.int4_matmul_a8_plain(x, packed, scales, g,
                                                    layer_idx=li))
    assert _build.LAUNCHES["int4_matmul_a8"] == 2


@pytest.mark.parametrize("k,n,g,split", [(2816, 384, 32, (2, 6)),
                                         (1280, 512, 32, (1, 5)),
                                         (256, 640, 64, (1, 1)),
                                         (1152, 512, 64, (1, 6))])
def test_int4_matmul_a8_ragged_bands(cuda, k, n, g, split):
    """Band splits the llama shapes do not reach: 11 superblocks in 6
    bands (the last holding one; a cluster of 6), a cluster of 5, one
    superblock (one band, no cluster), and K = 1152 pack-padded to 1536
    at G = 64, at 1 and 37 rows."""
    rng = np.random.default_rng(k + n)
    packed, scales = _int4_stack(rng, k, n, "bf16", cuda, 2, g)
    assert im.a8_split(2 * packed.shape[-2], n) == split
    for m in (1, 37):
        x = _bf16(rng, (m, k), cuda)
        got = im.int4_matmul_a8(x, packed, scales, g, layer_idx=1)
        assert _mat_ok(got, im.int4_matmul_a8_plain(x, packed, scales, g,
                                                    layer_idx=1))


def test_int4_matmul_a8_rows_are_independent(cuda):
    """An output row's bits depend on its x row alone: the kernel on x[:r]
    equals its rows of the kernel on all 100 rows bit for bit, whatever
    row tile (8 to 64 rows) each call takes."""
    rng = np.random.default_rng(100)
    packed, scales = _int4_stack(rng, 2048, 640, "bf16", cuda,
                                 group_size=64)
    x = _bf16(rng, (100, 2048), cuda)

    def call(xr):
        return im.int4_matmul_a8(xr, packed, scales, 64, layer_idx=1)
    full = call(x)
    for r in (1, 2, 7, 8, 9, 16, 33, 64, 65):
        assert torch.equal(call(x[:r]), full[:r]), r


@pytest.mark.parametrize("scale_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("m", [1, 9])
def test_int4_matmul_glu_matches_plain(cuda, m, scale_dtype):
    rng = np.random.default_rng(m)
    packed, scales = _int4_stack(rng, 512, 256, scale_dtype, cuda)
    gu = _bf16(rng, (m, 1024), cuda)
    _build.reset_launches()
    for li in (0, 1):
        got = im.int4_matmul_glu(gu, packed, scales, 128, layer_idx=li)
        want = im.int4_matmul_glu_plain(gu, packed, scales, 128, layer_idx=li)
        assert _mat_ok(got, want)
    assert _build.LAUNCHES["int4_matmul_glu"] == 2


@pytest.mark.parametrize("scale_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("g", [32, 64, 128])
@pytest.mark.parametrize("m", [1, 2, 8, 9, 16, 33, 64, 100])
def test_int4_matmul_glu_tensor_core_matches_plain(cuda, m, g, scale_dtype):
    """The GLU kernel (activation kernel, then the tensor-core contraction
    under programmatic dependent launch) against its plain version: F =
    2048, N = 384 (three column tiles), layers 0 and 2 of a stack; 100 rows
    leave the last 64-row tile partial."""
    rng = np.random.default_rng(m + g)
    packed, scales = _int4_stack(rng, 2048, 384, scale_dtype, cuda, 3, g)
    gu = (_bf16(rng, (m, 4096), cuda).float() * 2.0).to(torch.bfloat16)
    _build.reset_launches()
    for li in (0, 2):
        got = im.int4_matmul_glu(gu, packed, scales, g, layer_idx=li)
        assert _mat_ok(got, im.int4_matmul_glu_plain(gu, packed, scales, g,
                                                     layer_idx=li))
    assert _build.LAUNCHES["int4_matmul_glu"] == 2


@pytest.mark.parametrize("target,split", [(2, (9, 1)), (8, (3, 3)),
                                          (10, (2, 5))])
def test_int4_matmul_glu_ragged_bands(cuda, monkeypatch, target, split):
    """F = 2304 (9 superblocks) over N = 256 in one band, three, and five
    with a last band of one superblock (the split targets forced low), at
    8 rows and at 1: against the plain version."""
    monkeypatch.setattr(im, "_GLU_TARGET_BLOCKS", target)
    assert im.glu_split(8, 256, 2304) == split
    rng = np.random.default_rng(target)
    packed, scales = _int4_stack(rng, 2304, 256, "f32", cuda, 2, 32)
    for m in (8, 1):
        gu = _bf16(rng, (m, 4608), cuda)
        got = im.int4_matmul_glu(gu, packed, scales, 32, layer_idx=1)
        assert _mat_ok(got, im.int4_matmul_glu_plain(gu, packed, scales, 32,
                                                     layer_idx=1))


@pytest.mark.parametrize("m", [1, 16, 5])
def test_mlp_fused_matches_plain_and_replays_in_a_graph(cuda, m):
    """The cooperative launch against its plain version, then captured in
    a CUDA graph and replayed (chip_smoke.py times it so)."""
    from tinychatengine_tpu_torch.ops import mlp_fused as mf
    from tinychatengine_tpu_torch.ops.linear import Int4Linear
    rng = np.random.default_rng(m)
    wgu = Int4Linear(*_int4_stack(rng, 512, 2048, "bf16", cuda))
    wdn = Int4Linear(*_int4_stack(rng, 1024, 512, "bf16", cuda))
    x = _bf16(rng, (m, 512), cuda)
    _build.reset_launches()
    got = mf.mlp_fused(x, wgu, wdn, 1, bn=256)
    assert _mat_ok(got, mf.mlp_fused_plain(x, wgu, wdn, 1, bn=256))
    assert _build.LAUNCHES["mlp_fused"] == 1
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = mf.mlp_fused(x, wgu, wdn, 1, bn=256)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, got)


@pytest.mark.parametrize("g", [128, 32])
@pytest.mark.parametrize("m", [1, 9])
def test_int3_matmul_matches_plain(cuda, m, g):
    from tinychatengine_tpu_torch.ops import int3_matmul as i3
    from tinychatengine_tpu_torch.quant.numerics import quantize_groupwise_int3
    rng = np.random.default_rng(m + g)
    q, d = quantize_groupwise_int3(
        rng.standard_normal((256, 2048)).astype(np.float32) * 0.08, g)
    pa, pb = (torch.from_numpy(a).to(cuda) for a in i3.pack_qm_tpu3(q))
    scales = torch.from_numpy(np.ascontiguousarray(d.T)).to(cuda)
    x = _bf16(rng, (m, 2048), cuda)
    _build.reset_launches()
    got = i3.int3_matmul(x, pa, pb, scales, group_size=g)
    assert _mat_ok(got, i3.int3_matmul_plain(x, pa, pb, scales, group_size=g))
    assert _build.LAUNCHES["int3_matmul"] == 1


def _int3_weights(rng, k, n, g, dev):
    """QM_TPU3 planes and f32 scales [K/G, N] of a random [N, K] weight on
    the card."""
    from tinychatengine_tpu_torch.quant.numerics import quantize_groupwise_int3
    q, d = quantize_groupwise_int3(
        rng.standard_normal((n, k)).astype(np.float32) * 0.08, g)
    pa, pb = (torch.from_numpy(a).to(dev) for a in i3.pack_qm_tpu3(q))
    return pa, pb, torch.from_numpy(np.ascontiguousarray(d.T)).to(dev)


@pytest.mark.parametrize("g", [32, 64, 128])
@pytest.mark.parametrize("m", [1, 2, 8, 9, 16, 33, 64, 100])
def test_int3_tensor_core_matches_plain(cuda, m, g):
    """The int3 kernel on the tensor cores against its plain version: K =
    3072 (three chunks), N = 272 (a partial last column tile), every row
    tile; 100 rows leave the last 64-row tile partial."""
    rng = np.random.default_rng(m + g)
    pa, pb, scales = _int3_weights(rng, 3072, 272, g, cuda)
    x = _bf16(rng, (m, 3072), cuda)
    _build.reset_launches()
    got = i3.int3_matmul(x, pa, pb, scales, group_size=g)
    assert _mat_ok(got, i3.int3_matmul_plain(x, pa, pb, scales, group_size=g))
    assert _build.LAUNCHES["int3_matmul"] == 1


@pytest.mark.parametrize("target,split", [(2, (5, 1)), (4, (3, 2)),
                                          (10, (1, 5))])
def test_int3_ragged_bands(cuda, monkeypatch, target, split):
    """K = 5120 (five chunks) over N = 256 in one band, two with a ragged
    last band, and five (the split target forced low), at 8 rows and at 1:
    against the plain version."""
    monkeypatch.setattr(i3, "_INT3_TARGET_BLOCKS", target)
    assert i3.int3_split(8, 256, 5120) == split
    rng = np.random.default_rng(target)
    pa, pb, scales = _int3_weights(rng, 5120, 256, 64, cuda)
    for m in (8, 1):
        x = _bf16(rng, (m, 5120), cuda)
        got = i3.int3_matmul(x, pa, pb, scales, group_size=64)
        assert _mat_ok(got, i3.int3_matmul_plain(x, pa, pb, scales,
                                                 group_size=64))


SPLIT = att.DECODE_SPLIT
# lengths about the split's edges: 1, SPLIT - 1, SPLIT, SPLIT + 1, 2 SPLIT + 65
SPLIT_LENGTHS = (1, SPLIT - 1, SPLIT, SPLIT + 1, 2 * SPLIT + 65)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("hq,hkv", [(8, 2), (48, 1), (32, 2)])
@pytest.mark.parametrize("d", [64, 128])
def test_split_decode_matches_plain_about_the_split(cuda, d, hq, hkv, int8):
    """flash_decode over rows whose lengths sit about the split's edges
    (and a row of length 0, which gives zeros), GQA and MQA, bf16 and int8,
    with and without a window: against the plain version (attn_err), and
    bit for bit against paged decode of the same keys and against a scalar
    length per row."""
    rng = np.random.default_rng(d + hq + 7 * int8)
    lengths = (0,) + SPLIT_LENGTHS
    b, p = len(lengths), 64
    smax = -(-max(lengths) // p) * p
    mp = smax // p
    if int8:
        k, ks = _int8_kv(rng, (2, b, hkv, smax, d), cuda)
        v, vs = _int8_kv(rng, (2, b, hkv, smax, d), cuda)
    else:
        k, v = (_bf16(rng, (2, b, hkv, smax, d), cuda) for _ in range(2))
        ks = vs = None
    table = torch.from_numpy(rng.permutation(b * mp).reshape(b, mp).astype(
        np.int32) + 1).to(cuda)
    pk, pv = _pool(k, table, p), _pool(v, table, p)
    pks, pvs = (None, None) if not int8 else (_pool(ks, table, p),
                                              _pool(vs, table, p))
    q = _bf16(rng, (b, hq, d), cuda)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    for window in (None, SPLIT + 30):
        dense = att.flash_decode(q, k, v, 1, lens, ks, vs, window=window)
        paged = att.flash_decode_paged(q, pk, pv, 1, lens, table, pks, pvs,
                                       window=window)
        want = att.flash_decode_plain(q, k, v, 1, lens, ks, vs,
                                      window=window)
        torch.cuda.synchronize()
        assert torch.equal(dense, paged)
        assert torch.equal(dense[0], torch.zeros_like(dense[0]))
        assert attn_err(dense[1:], want[1:], d)[1] <= 1.0
        for r, n in enumerate(lengths):  # a scalar length: the same bits
            one = att.flash_decode(q[r:r + 1], k[:, r:r + 1].contiguous(),
                                   v[:, r:r + 1].contiguous(), 1, n,
                                   None if ks is None
                                   else ks[:, r:r + 1].contiguous(),
                                   None if vs is None
                                   else vs[:, r:r + 1].contiguous(),
                                   window=window)
            assert torch.equal(one[0], dense[r]), (n, window)


@pytest.mark.parametrize("int8", [False, True])
def test_split_decode_scalar_equals_tensor_lengths(cuda, int8):
    """One length as an int and as an int32 [B] tensor (grids of
    ceil(length / SPLIT) and ceil(S / SPLIT) splits): bit-identical, dense
    and paged."""
    rng = np.random.default_rng(11 + int8)
    b, hq, hkv, d, p, smax = 3, 8, 2, 128, 128, 1024
    mp = smax // p
    if int8:
        k, ks = _int8_kv(rng, (1, b, hkv, smax, d), cuda)
        v, vs = _int8_kv(rng, (1, b, hkv, smax, d), cuda)
    else:
        k, v = (_bf16(rng, (1, b, hkv, smax, d), cuda) for _ in range(2))
        ks = vs = None
    table = torch.from_numpy(rng.permutation(b * mp).reshape(b, mp).astype(
        np.int32) + 1).to(cuda)
    pk, pv = _pool(k, table, p), _pool(v, table, p)
    pks, pvs = (None, None) if not int8 else (_pool(ks, table, p),
                                              _pool(vs, table, p))
    q = _bf16(rng, (b, hq, d), cuda)
    for n in SPLIT_LENGTHS:
        lens = torch.full((b,), n, dtype=torch.int32, device=cuda)
        dense = att.flash_decode(q, k, v, 0, n, ks, vs)
        assert torch.equal(dense, att.flash_decode(q, k, v, 0, lens, ks, vs))
        assert torch.equal(dense, att.flash_decode_paged(
            q, pk, pv, 0, n, table, pks, pvs))
        assert torch.equal(dense, att.flash_decode_paged(
            q, pk, pv, 0, lens, table, pks, pvs))


@pytest.mark.parametrize("n", [392, 400])
@pytest.mark.parametrize("g", [32, 128])
@pytest.mark.parametrize("scale_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("m", [1, 8, 9, 16, 17, 64, 65, 130, 256, 497, 512])
def test_int4_matmul_routes_match_plain(cuda, m, scale_dtype, g, n):
    """Both routes of int4_matmul against the plain version: the band
    route at M <= 8, the tile route (wgmma) from 9 rows, at every token
    tile (16 to 256 rows, two 256-row tiles from 257); K = 1280 (five
    superblocks: ten stages, split over a cluster of four blocks) and
    N = 392 or 400 (not a multiple of 128: the last tile's columns are
    masked; 392 is not a multiple of 16 either, so the tile route copies
    its weights and scales 4 bytes at a time, 400 takes TMA); stacked
    layers 0 and last (a pointer offset), and one unstacked."""
    rng = np.random.default_rng(m + g)
    k, layers = 1280, 3
    lins = [quantized_linear(rng.standard_normal((n, k)).astype(np.float32)
                             * 0.02, g, scale_dtype) for _ in range(layers)]
    packed = torch.stack([p.packed for p in lins]).to(cuda)
    scales = torch.stack([p.scales for p in lins]).to(cuda)
    x = _bf16(rng, (m, k), cuda)
    assert im.int4_route(m, k, n, True)[0] == ("band" if m <= 8 else "tile")
    _build.reset_launches()
    for li in (0, layers - 1):
        got = im.int4_matmul(x, packed, scales, g, layer_idx=li)
        assert _mat_ok(got, im.int4_matmul_plain(x, packed, scales, g,
                                                 layer_idx=li))
    got = im.int4_matmul(x, packed[1], scales[1], g)
    assert _mat_ok(got, im.int4_matmul_plain(x, packed[1], scales[1], g))
    assert _build.LAUNCHES["int4_matmul"] == 3


@pytest.mark.parametrize("m,rows", [(8, (1, 2, 7)),
                                    (497, (9, 64, 65, 130, 200)),
                                    (512, (16, 256, 257))])
def test_int4_matmul_rows_are_independent(cuda, m, rows):
    """Within a route an output row's bits depend on its x row alone:
    int4_matmul(x)[:r] equals int4_matmul(x[:r]) bit for bit (band route
    from 8 rows, tile route from 497 and 512: token tiles of 16 to 256
    rows, one or two 256-row tiles, against each other)."""
    rng = np.random.default_rng(m)
    packed, scales = _int4_stack(rng, 1024, 640, "bf16", cuda)
    x = _bf16(rng, (m, 1024), cuda)
    full = im.int4_matmul(x, packed, scales, 128, layer_idx=1)
    for r in rows:
        assert im.int4_route(r, 1024, 640, True)[0] \
            == im.int4_route(m, 1024, 640, True)[0]
        part = im.int4_matmul(x[:r], packed, scales, 128, layer_idx=1)
        assert torch.equal(part, full[:r]), r


@pytest.mark.parametrize("m,k,n,scale_dtype",
                         [(16, 24576, 6144, "bf16"), (100, 4096, 6160, "f32")])
def test_int4_matmul_tile_route_wide_shapes(cuda, m, k, n, scale_dtype):
    """The tile route at StarCoder's fc_out (a 16-row decode tick: K split
    over a 4-block cluster, 192 stages) and at N = 6160 (a multiple of 16,
    not of 64: the last block's 128 columns hold 16), against the plain
    version, stacked at the last layer and unstacked."""
    gen = torch.Generator(device=cuda).manual_seed(m + n)
    packed = torch.randint(0, 256, (2, k // 2, n), dtype=torch.uint8,
                           device=cuda, generator=gen)
    scales = (torch.rand((2, k // 128, n), device=cuda, generator=gen)
              * 0.02 + 0.005).to(getattr(torch, {"bf16": "bfloat16",
                                                  "f32": "float32"}[scale_dtype]))
    x = torch.randn((m, k), device=cuda, generator=gen).to(torch.bfloat16)
    assert im.int4_route(m, k, n, True)[0] == "tile"
    _build.reset_launches()
    got = im.int4_matmul(x, packed, scales, 128, layer_idx=1)
    assert _mat_ok(got, im.int4_matmul_plain(x, packed, scales, 128,
                                             layer_idx=1))
    got = im.int4_matmul(x, packed[1], scales[1], 128)
    assert _mat_ok(got, im.int4_matmul_plain(x, packed[1], scales[1], 128))
    assert _build.TILE_LAUNCHES == {im.tile_width(m): 2}


@pytest.mark.parametrize("m", [16, 512])
def test_int4_matmul_tile_route_replays_in_a_graph(cuda, m):
    """The tile route captured in a CUDA graph (no host sync, no
    allocation in the kernel) replays its eager result bit for bit, with
    the input rewritten between replays."""
    rng = np.random.default_rng(m)
    packed, scales = _int4_stack(rng, 1280, 392, "bf16", cuda)
    xs = [_bf16(rng, (m, 1280), cuda) for _ in range(2)]
    want = [im.int4_matmul(x, packed, scales, 128, layer_idx=1) for x in xs]
    x = xs[0].clone()
    im.int4_matmul(x, packed, scales, 128, layer_idx=1)  # warm, eager
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = im.int4_matmul(x, packed, scales, 128, layer_idx=1)
    for i in (0, 1, 0):
        x.copy_(xs[i])
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, want[i]), i


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("k,n", [(14336, 2048), (14336, 4096)])
def test_int4_matmul_band_route_ragged_last_band(cuda, m, k, n):
    """The band route where the superblocks do not divide into whole bands
    (56 superblocks in bands of 3 at N = 2048, of 6 at llama3_8b's down,
    N = 4096): the last band holds the remainder. Against the plain
    version, stacked at the last layer and unstacked."""
    per, bands = im.band_split(k, n)
    assert (k // 256) % per and im.int4_route(m, k, n, True) \
        == ("band", (per, bands))
    gen = torch.Generator(device=cuda).manual_seed(m + n)
    packed = torch.randint(0, 256, (2, k // 2, n), dtype=torch.uint8,
                           device=cuda, generator=gen)
    scales = (torch.rand((2, k // 128, n), device=cuda, generator=gen)
              * 0.02 + 0.005).to(torch.bfloat16)
    x = torch.randn((m, k), device=cuda, generator=gen).to(torch.bfloat16)
    got = im.int4_matmul(x, packed, scales, 128, layer_idx=1)
    assert _mat_ok(got, im.int4_matmul_plain(x, packed, scales, 128,
                                             layer_idx=1))
    got = im.int4_matmul(x, packed[1], scales[1], 128)
    assert _mat_ok(got, im.int4_matmul_plain(x, packed[1], scales[1], 128))


# ---- the captured device loops (generation/cuda_graph.py) -----------------

GRAPH_LLAMA = dict(name="tiny_graph", family="llama", num_heads=4,
                   num_kv_heads=2, num_layers=2, max_sqlen=256,
                   embed_dim=256, hidden_dim=512, vocab_size=512)
GRAPH_PROMPT = np.random.default_rng(0).integers(0, 512, (1, 20))


def _tiny_llama(cuda, scheme="w4a8", kv="bf16"):
    from tinychatengine_tpu_torch.core.config import ModelConfig, QuantConfig
    from tinychatengine_tpu_torch.models import llama
    cfg = ModelConfig(**GRAPH_LLAMA)
    qcfg = QuantConfig(scheme=scheme, group_size=128, kv_cache_dtype=kv)
    return cfg, qcfg, llama.init_random_params(cfg, qcfg, seed=0,
                                               device=cuda)


def _engines(cuda, scheme="w4a8", kv="bf16"):
    """(graph engine, eager engine) on one tiny random llama."""
    from tinychatengine_tpu_torch.generation.engine import Engine
    cfg, qcfg, params = _tiny_llama(cuda, scheme, kv)
    return (Engine(params, cfg, qcfg, device=cuda),
            Engine(params, cfg, qcfg, device=cuda, cuda_graphs=False))


@pytest.mark.parametrize("scheme,kv", [("w4a8", "bf16"), ("w4a8", "int8"),
                                       ("w4a16", "bf16"), ("fp", "bf16")])
def test_graph_tokens_equal_eager_tokens(cuda, scheme, kv):
    """``generate_device`` through the captured prompt and step graphs
    gives the eager loop's greedy tokens (with a repeat penalty) at every
    step, and the captured prefill the eager prefill's logits bit for
    bit."""
    from tinychatengine_tpu_torch.core.config import GenerationConfig
    graph, eager = _engines(cuda, scheme, kv)
    g = GenerationConfig(temp=0.0, repeat_penalty=1.1, repeat_last_n=16)
    want = eager.generate_device(GRAPH_PROMPT, g, n_tokens=40)
    for _ in range(2):  # the capture's call, then a replay's
        got = graph.generate_device(GRAPH_PROMPT, g, n_tokens=40)
        assert torch.equal(got, want)
    la, _ = graph.prefill(GRAPH_PROMPT, graph.new_cache())
    lb, _ = eager.prefill(GRAPH_PROMPT, eager.new_cache())
    assert torch.equal(la, lb)


def test_second_generate_device_call_captures_nothing(cuda):
    """One capture each for the prompt bucket and the step; a second call
    with the same shapes (another prompt, another length) replays them,
    and the launch counters count every replay: one step's kernels per
    token, one prefill's per prompt."""
    from tinychatengine_tpu_torch.core.config import GenerationConfig
    graph, _ = _engines(cuda)
    g = GenerationConfig(temp=0.0, repeat_penalty=1.0, repeat_last_n=1)
    graph.generate_device(GRAPH_PROMPT, g, n_tokens=8)
    assert graph.graphs.captures == 2
    nl = GRAPH_LLAMA["num_layers"]
    _build.reset_launches()
    graph.generate_device(GRAPH_PROMPT[:, ::-1].copy(), g, n_tokens=5)
    torch.cuda.synchronize()
    assert graph.graphs.captures == 2
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "flash_prefill": nl, "flash_decode": 5 * nl,
        "int4_matmul_a8": 6 * (4 * nl + 1)}


def _kv_equal(a, b, n: int) -> bool:
    """Positions [0, n) of every buffer of two caches are equal."""
    pairs = [(a.k, b.k), (a.v, b.v)]
    if a.k_scale is not None:
        pairs += [(a.k_scale, b.k_scale), (a.v_scale, b.v_scale)]
    return all(torch.equal(x[:, :, :, :n], y[:, :, :, :n]) for x, y in pairs)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_graph_caches_equal_eager_caches(cuda, kv):
    """The graphs run in the engine's own cache, never handed out: with
    ``return_cache`` the capturing call and a replaying call each return a
    fresh cache (no two share storage) whose length and written positions
    equal the eager loop's. A caller's cache, one that already has a
    length, is filled in place to the eager loop's length and contents,
    and replays without a capture; so does a prefill that continues a
    caller's cache at a later start, copying its head in."""
    from tinychatengine_tpu_torch.core.config import GenerationConfig
    graph, eager = _engines(cuda, kv=kv)
    g = GenerationConfig(temp=0.0, repeat_penalty=1.0, repeat_last_n=1)
    n = GRAPH_PROMPT.shape[1] + 12
    want_toks, want = eager.generate_device(GRAPH_PROMPT, g, n_tokens=12,
                                            return_cache=True)
    got = []
    for _ in range(2):  # the capturing call, then a replaying call
        toks, c = graph.generate_device(GRAPH_PROMPT, g, n_tokens=12,
                                        return_cache=True)
        assert torch.equal(toks, want_toks)
        assert c.length == want.length == n and _kv_equal(c, want, n)
        got.append(c)
    assert graph.graphs.captures == 2
    assert len({c.k.data_ptr() for c in got}
               | {graph._cache.k.data_ptr()}) == 3
    outs = []
    for eng in (graph, eager):
        cache = eng.new_cache()
        cache.length = 5
        toks, out = eng.generate_device(GRAPH_PROMPT, g, n_tokens=12,
                                        cache=cache, return_cache=True)
        assert out is cache and torch.equal(toks, want_toks)
        outs.append(out)
    assert outs[0].length == outs[1].length == 5 + n
    assert _kv_equal(*outs, n) and graph.graphs.captures == 2
    head, tail = GRAPH_PROMPT[:, :12], GRAPH_PROMPT[:, 12:]
    logits, caches = [], []
    for eng in (graph, eager):
        cache = eng.new_cache()
        eng.prefill(head, cache)
        lg, cache = eng.prefill(tail, cache, start=12)
        logits.append(lg)
        caches.append(cache)
    assert torch.equal(*logits) and caches[0].length == caches[1].length
    assert _kv_equal(*caches, GRAPH_PROMPT.shape[1])


def test_plain_call_captured_in_a_step_counts_at_each_replay(cuda,
                                                             monkeypatch):
    """A plain version that a captured step calls is counted by
    ``chip_smoke.plain_calls`` at the step's eager first run and again at
    every replay, though Python calls it only at the capture: the counter
    chip_smoke holds at 0 sees a plain fallback baked into a graph."""
    import chip_smoke
    from tinychatengine_tpu_torch.generation import cuda_graph as cg
    monkeypatch.setattr(att, "flash_decode_plain", lambda t: t * 2)
    x = torch.ones(8, device=cuda)
    y = torch.zeros(8, device=cuda)

    def body():
        y.copy_(att.flash_decode_plain(x))
        x.add_(1)
    from tinychatengine_tpu_torch.utils import tracing
    t0 = time.perf_counter_ns()
    graphs = cg.Graphs(cuda)
    with chip_smoke.plain_calls() as plain:
        step = graphs.step("planted", lambda: cg.Step(body, None))
        for _ in range(4):  # the eager run and the capture, 3 replays
            graphs.run(step)
        torch.cuda.synchronize()
    captures = [s for s in tracing.snapshot(t0) if s.name == "graph.capture"]
    assert graphs.captures == 1 and len(captures) == 1
    assert captures[0].end > captures[0].start
    assert plain["flash_decode_plain"] == 4
    assert float(x[0]) == 5.0 and float(y[0]) == 8.0


@pytest.mark.parametrize("name", ["top_k_top_p", "mirostat2", "typical"])
def test_sampled_graph_draws_equal_eager_draws(cuda, name):
    """The step's generator is registered with its graph: each replay
    draws what the eager step draws for the same seed (temperature with
    top-k and top-p, mirostat 2 with its mu carried in place, tail-free
    and typical)."""
    from tinychatengine_tpu_torch.core.config import GenerationConfig
    graph, eager = _engines(cuda)
    g = {"top_k_top_p": GenerationConfig(temp=0.9, top_k=40, top_p=0.9,
                                         seed=7),
         "mirostat2": GenerationConfig(temp=1.0, mirostat=2, seed=7,
                                       repeat_penalty=1.0),
         "typical": GenerationConfig(temp=0.8, tfs_z=0.95, typical_p=0.9,
                                     seed=9, logit_bias={3: 2.0})}[name]
    want = eager.generate_device(GRAPH_PROMPT, g, n_tokens=32)
    for _ in range(2):
        assert torch.equal(graph.generate_device(GRAPH_PROMPT, g,
                                                 n_tokens=32), want)
    assert len(set(want[0].tolist())) > 4  # the draws are not all greedy


@pytest.mark.parametrize("int8", [False, True])
def test_ctx_cap_leaves_flash_decode_bits(cuda, int8):
    """Device lengths with a ``ctx_cap`` above every length: the grid
    drops only empty splits, so the output equals the full grid's bit for
    bit."""
    rng = np.random.default_rng(21 + int8)
    b, hq, hkv, d, smax = 3, 8, 2, 128, 2048
    if int8:
        k, ks = _int8_kv(rng, (1, b, hkv, smax, d), cuda)
        v, vs = _int8_kv(rng, (1, b, hkv, smax, d), cuda)
    else:
        k, v = (_bf16(rng, (1, b, hkv, smax, d), cuda) for _ in range(2))
        ks = vs = None
    q = _bf16(rng, (b, hq, d), cuda)
    for lens, cap in (([1, 200, 512], 512), ([700, 3, 1024], 1024),
                      ([5, 6, 7], 128), ([2048, 1, 9], 4096)):
        lt = torch.tensor(lens, dtype=torch.int32, device=cuda)
        full = att.flash_decode(q, k, v, 0, lt, ks, vs)
        assert torch.equal(att.flash_decode(q, k, v, 0, lt, ks, vs,
                                            ctx_cap=cap), full)


@pytest.mark.parametrize("paged", [False, True])
def test_serving_graph_ticks_equal_eager_ticks(cuda, paged):
    """The serving burst and single ticks through the captured tick give
    the eager server's tokens for a mixed load (greedy with a penalty,
    top-p, top-k), dense and paged."""
    from tinychatengine_tpu_torch.core.config import GenerationConfig
    from tinychatengine_tpu_torch.runtime.serving import ServingEngine
    cfg, qcfg, params = _tiny_llama(cuda)
    g = GenerationConfig(temp=0.0, n_predict=24, repeat_penalty=1.1,
                         repeat_last_n=8, seed=4)
    mix = [None, GenerationConfig(temp=1.1, top_p=0.9, n_predict=24,
                                  repeat_penalty=1.0, repeat_last_n=4,
                                  seed=33),
           GenerationConfig(temp=0.7, top_k=5, n_predict=24, seed=8)]
    outs = []
    for graphs in (True, False):
        srv = ServingEngine(params, cfg, qcfg, slots=4, gcfg=g, tick_batch=8,
                            paged=paged, page_size=64, device=cuda,
                            cuda_graphs=graphs)
        reqs = [srv.submit(GRAPH_PROMPT[0, :5 + 3 * i], gcfg=mix[i % 3])
                for i in range(6)]
        srv.run()
        outs.append([r.output_ids for r in reqs])
        if graphs:
            assert srv.graphs.captures >= 1 and srv.tick_stats["bursts"] > 0
    assert outs[0] == outs[1]


def test_spec_tick_graph_equals_eager(cuda):
    """Speculative serving through the captured spec tick (one graph keyed
    on K) gives the eager server's tokens and spec counters, and PLD
    through the captured verify step the eager engine's tokens and
    steps."""
    from tinychatengine_tpu_torch.core.config import GenerationConfig
    from tinychatengine_tpu_torch.generation.speculative import generate_pld
    from tinychatengine_tpu_torch.runtime.serving import ServingEngine
    cfg, qcfg, params = _tiny_llama(cuda)
    g = GenerationConfig(temp=0.0, n_predict=32, repeat_penalty=1.0,
                         repeat_last_n=1)
    rep = np.tile(GRAPH_PROMPT[0, :6], 5)
    outs = []
    for graphs in (True, False):
        srv = ServingEngine(params, cfg, qcfg, slots=4, gcfg=g, tick_batch=1,
                            speculative=True, device=cuda, cuda_graphs=graphs)
        reqs = [srv.submit(p) for p in (rep, GRAPH_PROMPT[0, :9], rep[3:])]
        srv.run()
        outs.append(([r.output_ids for r in reqs], dict(srv._spec_stats)))
        if graphs:
            assert srv._spec_stats["ticks"] > 0
    assert outs[0] == outs[1]
    graph, eager = _engines(cuda)
    want = generate_pld(eager, rep[None], n_tokens=40, K=7)
    for _ in range(2):
        got = generate_pld(graph, rep[None], n_tokens=40, K=7)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]


@pytest.mark.parametrize("paged", [False, True])
def test_logprobs_tick_graph_equals_eager(cuda, paged):
    """The captured tick's logprobs variant (bursts and single ticks) gives
    the eager server's tokens, logprobs and top ids, dense and paged."""
    from tinychatengine_tpu_torch.core.config import GenerationConfig
    from tinychatengine_tpu_torch.runtime.serving import ServingEngine
    cfg, qcfg, params = _tiny_llama(cuda)
    g = GenerationConfig(temp=0.0, n_predict=24, repeat_penalty=1.0,
                         repeat_last_n=1)
    hot = GenerationConfig(temp=0.9, top_p=0.9, n_predict=24, seed=3)
    outs = []
    for graphs in (True, False):
        srv = ServingEngine(params, cfg, qcfg, slots=4, gcfg=g, tick_batch=8,
                            paged=paged, page_size=64, device=cuda,
                            logprobs_k=5, cuda_graphs=graphs)
        reqs = [srv.submit(GRAPH_PROMPT[0, :5 + 3 * i],
                           gcfg=hot if i % 2 else None,
                           logprobs=(5, None, 0)[i % 3]) for i in range(6)]
        srv.run()
        outs.append([(r.output_ids, r.output_logprobs,
                      [[t for t, _ in top] for top in r.output_top_logprobs])
                     for r in reqs])
    assert outs[0] == outs[1]


def test_embeds_prompt_graph_equals_eager(cuda):
    """A prompt given as embeds replays its own prefill graph (keyed apart
    from the ids graphs): logits bit for bit and greedy tokens as the
    eager engine's, and the ids prompt of the same shape still replays
    the ids graph."""
    from tinychatengine_tpu_torch.core.config import GenerationConfig
    graph, eager = _engines(cuda)
    ids = GRAPH_PROMPT
    emb = graph.params.embed[torch.as_tensor(ids, device=cuda)].float()
    emb[:, 3:9] = torch.randn((1, 6, emb.shape[-1]), device=cuda,
                              generator=torch.Generator(cuda).manual_seed(0)
                              ) * 0.05
    la, _ = graph.prefill(ids, graph.new_cache(), input_embeds=emb)
    lb, _ = eager.prefill(ids, eager.new_cache(), input_embeds=emb)
    assert torch.equal(la, lb)
    lc, _ = graph.prefill(ids, graph.new_cache())
    ld, _ = eager.prefill(ids, eager.new_cache())
    assert torch.equal(lc, ld) and not torch.equal(la, lc)
    g = GenerationConfig(temp=0.0, n_predict=16, repeat_penalty=1.0,
                         repeat_last_n=1)
    want = eager.generate_device(ids, g, input_embeds=emb)
    assert torch.equal(graph.generate_device(ids, g, input_embeds=emb), want)
    assert graph.generate(ids, g, input_embeds=emb).tokens[0] == \
        want[0].tolist()


def _png_url(seed: int, size: int = 40) -> str:
    import base64
    import io

    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(
        0, 256, (size, size, 3), dtype=np.uint8)).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def test_server_device_work_during_a_capture(cuda):
    """The REST server's embeddings and image encodes run on its scheduler
    thread: an embeddings request and an image chat posted while the
    scheduler captures a new tick graph (the handler threads decode and
    enqueue inside the capture) both return 200, with the embeddings and
    the tokens of the same requests sent to the idle server after."""
    import http.client
    import json
    import threading
    import time

    from tinychatengine_tpu_torch.core.config import (GenerationConfig,
                                                      ModelConfig)
    from tinychatengine_tpu_torch.generation.chat_templates import \
        ChatTemplate
    from tinychatengine_tpu_torch.models import clip
    from tinychatengine_tpu_torch.runtime.server import InferenceServer
    from tinychatengine_tpu_torch.runtime.serving import ServingEngine
    from tinychatengine_tpu_torch.tokenizers.byte_fallback import \
        ByteTokenizer
    cfg, qcfg, params = _tiny_llama(cuda)
    ccfg = ModelConfig(name="clip_tiny", family="clip", num_heads=4,
                       num_kv_heads=4, num_layers=2, max_sqlen=0,
                       embed_dim=64, hidden_dim=128, vocab_size=0,
                       image_size=28, patch_size=14, mmproj_dim=cfg.embed_dim)
    g = GenerationConfig(temp=0.0, n_predict=8, repeat_penalty=1.0,
                         repeat_last_n=1)
    srv = ServingEngine(params, cfg, qcfg, slots=2, gcfg=g, tick_batch=4,
                        device=cuda)
    server = InferenceServer(
        srv, ByteTokenizer(), template=ChatTemplate("U: {input}\nA: ",
                                                    "U: {input}\nA: "),
        request_timeout=120.0,
        clip_params=clip.init_random_params(ccfg, seed=0, device=cuda),
        clip_cfg=ccfg)
    port = server.start(port=0)

    def post(path, body):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", path, json.dumps(body))
        resp = conn.getresponse()
        out = (resp.status, json.loads(resp.read()))
        conn.close()
        return out

    emb_body = {"input": ["hello world", "a second input"]}
    img_body = {"messages": [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": _png_url(0)}},
        {"type": "text", "text": "what is this?"}]}],
        "max_tokens": 8, "ignore_eos": True}
    during = {}
    clients = [threading.Thread(target=lambda k=k, p=p, b=b: during.update(
        {k: post(p, b)})) for k, p, b in (
            ("emb", "/v1/embeddings", emb_body),
            ("img", "/v1/chat/completions", img_body))]
    capture, inside = srv.graphs.capture, []

    def capture_with_clients(step):
        body = step.body

        def slow_body():  # the second call of the body is the captured one
            inside.append(1)
            if len(inside) == 2:
                for t in clients:
                    t.start()
                time.sleep(1.0)  # the handlers decode and enqueue meanwhile
            body()
        step.body = slow_body
        try:
            capture(step)
        finally:
            step.body = body
    srv.graphs.capture = capture_with_clients
    try:
        st, out = post("/v1/completions", {"prompt": "start the ticks",
                                           "max_tokens": 8,
                                           "ignore_eos": True})
        for t in clients:
            t.join(timeout=120)
    finally:
        srv.graphs.capture = capture
    try:
        assert st == 200, out
        assert len(inside) >= 2 and not any(t.is_alive() for t in clients)
        assert during["emb"][0] == 200 and during["img"][0] == 200, during
        idle_emb = post("/v1/embeddings", emb_body)
        idle_img = post("/v1/chat/completions", img_body)
        for a, b in zip(during["emb"][1]["data"], idle_emb[1]["data"]):
            np.testing.assert_allclose(a["embedding"], b["embedding"],
                                       atol=1e-6)
        assert during["img"][1]["choices"] == idle_img[1]["choices"]
        assert during["img"][1]["usage"] == idle_img[1]["usage"]
    finally:
        server.close()


def test_flash_prefill_routes_plain_under_autograd(cuda):
    """On the card ``flash_prefill`` launches its kernel unless autograd
    records (grad enabled and q or the cache needing grad), where it
    raises: the kernel has no backward. A training forward takes the plain
    attention itself (``models.llama.records``): llama calls
    ``flash_prefill_plain``, OPT its dense attention; neither launches a
    kernel, and the gradient reaches the q projection."""
    from tinychatengine_tpu_torch.core.config import ModelConfig, QuantConfig
    from tinychatengine_tpu_torch.generation import kv_cache as kvc
    from tinychatengine_tpu_torch.models import llama, opt
    from tinychatengine_tpu_torch.tools.train_tiny import _tree_map
    rng = np.random.default_rng(31)
    b, s, hq, hkv, d = 2, 48, 4, 2, 64
    q = _bf16(rng, (b, s, hq, d), cuda)
    k = _bf16(rng, (1, b, hkv, s, d), cuda)
    v = _bf16(rng, (1, b, hkv, s, d), cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        att.flash_prefill(q.clone().requires_grad_(), k, v, 0, 0, s)
    with pytest.raises(RuntimeError, match="no backward"):
        att.flash_prefill(q, k.clone().requires_grad_(), v, 0, 0, s)
    _build.reset_launches()
    with torch.no_grad():
        got = att.flash_prefill(q.clone().requires_grad_(), k, v, 0, 0, s)
    got2 = att.flash_prefill(q, k, v, 0, 0, s)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_prefill"] == 2
    assert torch.equal(got, got2)
    want = att.flash_prefill_plain(q, k, v, 0, 0, s)
    assert attn_err(got.float(), want.float(), d)[1] <= 1.0

    ids = torch.arange(8, device=cuda)[None]
    for model, fam in ((llama, "llama"), (opt, "opt")):
        cfg = ModelConfig(name=f"route_{fam}", family=fam, num_heads=4,
                          num_kv_heads=2 if fam == "llama" else 4,
                          num_layers=2, max_sqlen=64, embed_dim=256,
                          hidden_dim=512, vocab_size=258)
        params = (llama.init_random_params(cfg, QuantConfig(scheme="fp"),
                                           seed=0, device=cuda)
                  if fam == "llama" else
                  opt.init_random_params(cfg, quantized=False, seed=0,
                                         device=cuda))
        params = _tree_map(params, lambda p, t: t.detach().requires_grad_(
            t.is_floating_point() and not p.startswith("rope_")))
        calls = []
        real = att.flash_prefill_plain
        att.flash_prefill_plain = lambda *a, **kw: (calls.append(1),
                                                    real(*a, **kw))[1]
        _build.reset_launches()
        try:
            cache = kvc.init_cache(2, 1, 9, cfg.num_kv_heads, 64,
                                   device=cuda)
            logits, _ = model.forward(params, cfg, ids, cache, 0,
                                      full_logits=True)
            logits.float().sum().backward()
            torch.cuda.synchronize()
        finally:
            att.flash_prefill_plain = real
        assert not any(_build.LAUNCHES.values()), fam
        assert len(calls) == (2 if fam == "llama" else 0)
        wq = (params.layers.wqkv.weight if fam == "llama"
              else params.layers.q_proj.weight)
        assert wq.grad.abs().sum() > 0


# ---- the sparse-expert layer (ops/int4_moe.py, models/moe.py) --------------

def _expert_stack(cuda, sets, k, n, seed):
    """Random int4 expert weights [sets, K/2, N] and bf16 scales."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    lo, hi = (torch.randint(1, 16, (sets, k // 2, n), dtype=torch.uint8,
                            device=cuda, generator=gen) for _ in range(2))
    scales = (torch.rand((sets, k // 128, n), device=cuda, generator=gen)
              * 0.02 + 0.005).to(torch.bfloat16)
    return lo | (hi << 4), scales


def _routing(kind, rows, n_experts, k, rng):
    """ids [rows, k] of distinct experts a row: ``uneven`` (skewed, expert
    3 empty) or ``one`` (expert 5 in every row)."""
    if kind == "one":
        others = [e for e in range(n_experts) if e != 5]
        ids = [[5] + list(rng.choice(others, k - 1, replace=False))
               for _ in range(rows)]
    else:
        p = np.array([8, 4, 2, 0, 1, 1, 6, 3], np.float64)[:n_experts]
        ids = [list(rng.choice(n_experts, k, replace=False, p=p / p.sum()))
               for _ in range(rows)]
    return np.asarray(ids, np.int32)


@pytest.mark.parametrize("kind", ["uneven", "one"])
@pytest.mark.parametrize("rows", [1, 8, 64, 512])
def test_grouped_expert_matmul_matches_plain(cuda, rows, kind):
    """The route, plan, grouped matmul, act and combine kernels against
    their plain versions: the plan bit for bit (a stable sort by expert),
    the grouped matmul within MAT_TOL of each expert's plain int4 matmul
    (an empty expert and one taking every row included), the combine bit
    for bit given the same inputs."""
    from tinychatengine_tpu_torch.ops import int4_moe as mo
    rng = np.random.default_rng(rows)
    ne, k, e, f = 8, 2, 512, 256
    ids = torch.from_numpy(_routing(kind, rows, ne, k, rng)).to(cuda)
    t = mo.tile_rows(rows * k, ne)
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    stats_plain = torch.zeros(2, dtype=torch.int64, device=cuda)
    got = mo.plan(ids, ne, t, stats)
    want = mo.plan_plain(ids, ne, t, stats_plain)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(stats, stats_plain)
    if kind == "uneven":
        assert int(got[2][3]) == int(got[2][4])  # expert 3 has no rows
    src, slot_of, offsets, tiles = got
    gu_p, gu_s = _expert_stack(cuda, 2 * ne, e, 2 * f, 1)
    dn_p, dn_s = _expert_stack(cuda, 2 * ne, f, e, 2)
    x = _bf16(rng, (rows, e), cuda)
    xs = x.index_select(0, src)
    gu = mo.grouped_int4_matmul(xs, gu_p, gu_s, 128, ne, offsets, tiles, ne, t)
    gu_ref = mo.grouped_int4_matmul_plain(xs, gu_p, gu_s, 128, ne, offsets,
                                          ne)
    assert _mat_ok(gu, gu_ref)
    act = mo.expert_act(gu, f)
    assert _mat_ok(act, mo.expert_act_plain(gu, f))
    yd = mo.grouped_int4_matmul(act, dn_p, dn_s, 128, ne, offsets, tiles, ne,
                                t)
    assert _mat_ok(yd, mo.grouped_int4_matmul_plain(act, dn_p, dn_s, 128, ne,
                                                    offsets, ne))
    logits = torch.randn((rows, ne), device=cuda)
    rid, rw = mo.route(logits, k)
    pid, pw = mo.route_plain(logits, k, True)
    assert torch.equal(rid, pid)
    torch.testing.assert_close(rw, pw, rtol=1e-6, atol=0)
    w = torch.rand((rows, k), device=cuda)
    assert torch.equal(mo.combine(yd, slot_of, w, x),
                       mo.combine_plain(yd, slot_of, w, x))


def test_grouped_expert_rows_are_independent(cuda):
    """A row's bits do not depend on the rows routed beside it or on the
    token tile: 8 rows alone and among 512 (tiles of 16 and 64)."""
    from tinychatengine_tpu_torch.ops import int4_moe as mo
    rng = np.random.default_rng(7)
    ne, k, e, n = 8, 2, 512, 256
    ids = torch.from_numpy(_routing("uneven", 512, ne, k, rng)).to(cuda)
    w_p, w_s = _expert_stack(cuda, ne, e, n, 3)
    x = _bf16(rng, (512, e), cuda)
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    outs = []
    for rows in (8, 512):
        t = mo.tile_rows(rows * k, ne)
        src, slot_of, offsets, tiles = mo.plan(ids[:rows], ne, t, stats)
        y = mo.grouped_int4_matmul(x[:rows].index_select(0, src), w_p, w_s,
                                   128, 0, offsets, tiles, ne, t)
        outs.append(y[slot_of.long()][:8 * k])
    assert torch.equal(outs[0], outs[1])


GRAPH_MOE = dict(name="tiny_moe", family="llama", num_heads=2,
                 num_kv_heads=1, num_layers=2, max_sqlen=256, embed_dim=256,
                 hidden_dim=512, vocab_size=512, head_dim=128,
                 layer_windows=(16, None), layer_rope=("default", "yarn"),
                 num_experts=8, experts_per_tok=2, expert_dim=256)


def _tiny_moe(cuda):
    from tinychatengine_tpu_torch.core.config import (ModelConfig,
                                                      QuantConfig, YarnRope)
    from tinychatengine_tpu_torch.models import llama
    cfg = ModelConfig(**GRAPH_MOE, yarn=YarnRope(4.0, 64, 32.0, 1.0, 1.14))
    qcfg = QuantConfig(scheme="w4a16", group_size=128)
    return cfg, qcfg, llama.init_random_params(cfg, qcfg, seed=0,
                                               device=cuda, centered=True,
                                               fast=True)


@pytest.mark.parametrize("paged", [False, True])
def test_moe_tick_graph_equals_eager_and_never_syncs(cuda, paged):
    """A small sparse-expert model: the serving tick replayed from its
    captured graph gives the eager server's tokens, and a decode forward
    at per-row positions runs under ``set_sync_debug_mode("error")`` (no
    host sync inside the expert layer)."""
    from tinychatengine_tpu_torch.core.config import GenerationConfig
    from tinychatengine_tpu_torch.generation import kv_cache as kvc
    from tinychatengine_tpu_torch.models import llama
    from tinychatengine_tpu_torch.runtime.serving import ServingEngine
    from tinychatengine_tpu_torch.utils import tracing
    cfg, qcfg, params = _tiny_moe(cuda)
    g = GenerationConfig(temp=0.0, n_predict=24, repeat_penalty=1.0)
    t0 = time.perf_counter_ns()
    outs = []
    for graphs in (True, False):
        srv = ServingEngine(params, cfg, qcfg, slots=4, gcfg=g, tick_batch=8,
                            paged=paged, page_size=64, device=cuda,
                            cuda_graphs=graphs)
        reqs = [srv.submit(GRAPH_PROMPT[0, :5 + 3 * i]) for i in range(6)]
        srv.run()
        outs.append([r.output_ids for r in reqs])
        if graphs:
            assert srv.graphs.captures >= 1
    assert outs[0] == outs[1]
    assert _build.LAUNCHES["int4_moe"] > 0
    # the expert counts ride on the token fetches of a server on "cuda"
    dec = [s for s in tracing.snapshot(t0) if s.name == "serve.experts"]
    assert dec and all(0 < s.a <= s.b for s in dec)
    cache = kvc.init_cache(cfg.num_layers, 4, 64, cfg.num_kv_heads,
                           cfg.head_dim, device=cuda)
    start = torch.tensor([3, 9, 0, 30], dtype=torch.int32, device=cuda)
    toks = torch.tensor([[1], [2], [3], [4]], device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        llama.forward(params, cfg, toks, cache, start, ctx_cap=64)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
