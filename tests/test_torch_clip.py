"""The port's CLIP tower (models/clip.py) against the JAX package's on the
CPU: the resize and normalisation of preprocess_image on an enlarged and
a shrunk image, encode_hidden at f32 and encode_image at bf16 on one
seed's tower, patchify against a convolution, the clip/ checkpoint across
both packages, and JAX params carried across by params_from_numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinychatengine_tpu.core.config import ModelConfig as JModelConfig
from tinychatengine_tpu.models import clip as jclip
from tinychatengine_tpu.tools import checkpoint as jckpt
from tinychatengine_tpu_torch.core.config import ModelConfig
from tinychatengine_tpu_torch.models import clip
from tinychatengine_tpu_torch.tools import checkpoint as tckpt

TINY = dict(name="tiny_clip", family="clip", num_heads=4, num_kv_heads=4,
            num_layers=2, max_sqlen=0, embed_dim=64, hidden_dim=128,
            vocab_size=0, image_size=56, patch_size=14, projection_dim=32,
            mmproj_dim=96)
# preprocess_image, on pixel values 0-255 before the normalisation: the
# port builds jax.image.resize's weights (antialiased when shrinking) and
# contracts them in another order; read 0 enlarged and 4.6e-5 shrunk
RESIZE_TOL = 2e-4
# encode_hidden at f32, relative to max |JAX|: the same products summed in
# another order; read 5.2e-7
HIDDEN_F32_TOL = 1e-5
# encode_image at bf16, relative to max |JAX|: a bf16 rounding that lands
# on the other side moves an element by a bf16 step (2^-8 relative); read
# 3.5e-3
EMBED_BF16_TOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def towers():
    jcfg, cfg = JModelConfig(**TINY), ModelConfig(**TINY)
    return ((jcfg, jclip.init_random_params(jcfg, seed=0)),
            (cfg, clip.init_random_params(cfg, seed=0, device="cpu")))


def _flat_port(params) -> dict:
    return {k: v.float().numpy() for k, v in tckpt.flatten(params).items()}


def _unnormalise(x):
    return (np.asarray(x, np.float32) * np.asarray(clip.CLIP_STD, np.float32)
            + np.asarray(clip.CLIP_MEAN, np.float32)) * 255.0


@pytest.mark.parametrize("shape,size", [((28, 20, 3), 56),
                                        ((480, 640, 3), 336),
                                        ((56, 56, 3), 56)],
                         ids=["enlarged", "shrunk", "same_size"])
def test_preprocess_matches_jax(shape, size):
    """Pad to a centred square, the bilinear resize (antialiased when it
    shrinks, as jax.image.resize is by default) and CLIP's normalisation
    agree with JAX within RESIZE_TOL on 0-255 pixel values."""
    img = np.random.default_rng(0).integers(0, 256, shape, np.uint8)
    want = np.asarray(jclip.preprocess_image(jnp.asarray(img), size))
    got = clip.preprocess_image(img, size, device="cpu").numpy()
    assert got.shape == want.shape == (size, size, 3)
    err = np.abs(_unnormalise(got) - _unnormalise(want)).max()
    assert err <= RESIZE_TOL, err
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_TOL / 60)


def test_resize_weights_antialias_only_when_shrinking():
    """Enlarging interpolates between two neighbours; shrinking spreads
    each output over the widened kernel; every column sums to one."""
    up, down = clip.resize_weights(20, 56), clip.resize_weights(640, 336)
    assert (np.count_nonzero(up, axis=0) <= 2).all()
    assert np.count_nonzero(down, axis=0).max() >= 3
    np.testing.assert_allclose(up.sum(0), 1.0, atol=1e-6)
    np.testing.assert_allclose(down.sum(0), 1.0, atol=1e-6)


def test_init_random_params_is_jax_tower(towers):
    """One seed gives both packages the same tower, leaf for leaf."""
    (_, jp), (_, tp) = towers
    want, got = jckpt._flatten(jp)[0], _flat_port(tp)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def _pixels(seed=1, b=2):
    return np.random.default_rng(seed).standard_normal(
        (b, 56, 56, 3)).astype(np.float32)


def test_encode_hidden_f32_matches_jax(towers):
    (jcfg, jp), (cfg, tp) = towers
    px = _pixels()
    want = np.asarray(jclip.encode_hidden(jp, jcfg, jnp.asarray(px)))
    got = clip.encode_hidden(tp, cfg, torch.from_numpy(px)).numpy()
    assert got.shape == want.shape == (2, 17, 64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=HIDDEN_F32_TOL * np.abs(want).max())


def test_encode_image_bf16_matches_jax(towers):
    (jcfg, jp), (cfg, tp) = towers
    px = _pixels(seed=2)
    want = np.asarray(jclip.encode_image(jp, jcfg, jnp.asarray(px)),
                      np.float32)
    got = clip.encode_image(tp, cfg, torch.from_numpy(px))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert got.shape == want.shape == (2, 16, 96)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= EMBED_BF16_TOL, err


def test_patchify_equals_conv(towers):
    """encode_hidden's patchify and matmul is the stride-14 convolution
    with the patch embedding as its kernel."""
    _, (cfg, tp) = towers
    px = torch.from_numpy(_pixels(seed=3, b=1))
    p, e = cfg.patch_size, cfg.embed_dim
    kernel = tp.patch_embed.reshape(p, p, 3, e).permute(3, 2, 0, 1)  # OIHW
    conv = torch.nn.functional.conv2d(px.permute(0, 3, 1, 2), kernel,
                                      stride=p)           # [1, E, 4, 4]
    conv = conv.flatten(2).transpose(1, 2)
    x = px.reshape(1, 4, p, 4, p, 3).permute(0, 1, 3, 2, 4, 5)
    patch = x.reshape(1, 16, p * p * 3) @ tp.patch_embed
    np.testing.assert_allclose(patch.numpy(), conv.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_clip_checkpoint_across_packages(towers, tmp_path):
    """save_clip / load_clip: the port reads the JAX package's clip/
    checkpoint, the JAX package reads the port's, each leaf exact, and the
    loaded tower encodes as the saved one."""
    (jcfg, jp), (cfg, tp) = towers
    jckpt.save_clip(str(tmp_path / "jax"), jp, jcfg)
    tckpt.save_clip(str(tmp_path / "port"), tp, cfg)
    loaded, cfg2 = tckpt.load_clip(str(tmp_path / "jax"), device="cpu")
    assert cfg2 == cfg
    jloaded, _ = jckpt.load_clip(str(tmp_path / "port"))
    want = jckpt._flatten(jp)[0]
    for got in (_flat_port(loaded), jckpt._flatten(jloaded)[0]):
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)
    px = torch.from_numpy(_pixels(seed=4, b=1))
    torch.testing.assert_close(clip.encode_image(loaded, cfg2, px),
                               clip.encode_image(tp, cfg, px), rtol=0, atol=0)
    params, _ = tckpt.load_checkpoint(str(tmp_path / "port" / "clip"),
                                      device="cpu")
    assert isinstance(params, clip.CLIPParams)


def test_params_from_numpy_carries_jax_params(towers):
    """JAX params through params_from_numpy encode as JAX encodes them."""
    (jcfg, jp), (cfg, _) = towers
    jp2 = jclip.init_random_params(jcfg, seed=5)
    tp2 = clip.params_from_numpy(jckpt._flatten(jp2)[0], cfg, device="cpu")
    px = _pixels(seed=6, b=1)
    want = np.asarray(jclip.encode_hidden(jp2, jcfg, jnp.asarray(px)))
    got = clip.encode_hidden(tp2, cfg, torch.from_numpy(px)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=HIDDEN_F32_TOL * np.abs(want).max())
