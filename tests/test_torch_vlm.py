"""The port's VLM path on the CPU against the JAX package's: the embedding
splice (single and multi-image), llama.forward with input_embeds,
Engine.generate and generate_device with embeds over more than one prefill
chunk, generate_with_image end to end, and that the image conditions the
tokens. Tiny random models (the JAX package's tests/test_vlm.py sizes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinychatengine_tpu.core.config import GenerationConfig as JGen
from tinychatengine_tpu.core.config import ModelConfig as JModelConfig
from tinychatengine_tpu.core.config import QuantConfig as JQuantConfig
from tinychatengine_tpu.generation import kv_cache as jkvc
from tinychatengine_tpu.generation import vlm as jvlm
from tinychatengine_tpu.generation.engine import Engine as JEngine
from tinychatengine_tpu.models import clip as jclip
from tinychatengine_tpu.models import llama as jllama
from tinychatengine_tpu.tools import checkpoint as jckpt
from tinychatengine_tpu_torch.core.config import (GenerationConfig,
                                                  ModelConfig, QuantConfig)
from tinychatengine_tpu_torch.generation import kv_cache as kvc
from tinychatengine_tpu_torch.generation import vlm
from tinychatengine_tpu_torch.generation.engine import Engine
from tinychatengine_tpu_torch.models import clip, llama
from tinychatengine_tpu_torch.tokenizers.byte_fallback import ByteTokenizer

LLM = dict(name="llava_tiny", family="llama", num_heads=4, num_kv_heads=2,
           num_layers=2, max_sqlen=256, embed_dim=128, hidden_dim=256,
           vocab_size=384, rms_norm_eps=1e-5)
CLIP = dict(name="clip_tiny", family="clip", num_heads=4, num_kv_heads=4,
            num_layers=2, max_sqlen=0, embed_dim=64, hidden_dim=128,
            vocab_size=0, image_size=28, patch_size=14, mmproj_dim=128)
GREEDY = dict(temp=0.0, n_predict=8, repeat_penalty=1.0, repeat_last_n=1)
# the 2-layer forward at fp, logits relative to max |JAX| (ROADMAP's
# "Tolerances found": within 2e-2); read 4.4e-3, the cache 2e-3
FORWARD_TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """(JAX llama, JAX tower) and the port's copies of the same weights."""
    jcfg, jq = JModelConfig(**LLM), JQuantConfig(scheme="fp")
    jp = jllama.init_random_params(jcfg, jq, seed=0)
    jccfg = JModelConfig(**CLIP)
    jcp = jclip.init_random_params(jccfg, seed=0)
    cfg, q, ccfg = ModelConfig(**LLM), QuantConfig(scheme="fp"), \
        ModelConfig(**CLIP)
    tp = llama.params_from_numpy(jckpt._flatten(jp)[0], cfg, q, device="cpu")
    tcp = clip.init_random_params(ccfg, seed=0, device="cpu")
    return (jp, jcfg, jq, jcp, jccfg), (tp, cfg, q, tcp, ccfg)


def _image(seed):
    return np.random.default_rng(seed).integers(0, 256, (30, 30, 3),
                                                np.uint8)


def _prompt_embeds(tp, ids, image_rows, seed=7):
    """The prompt's table rows with synthetic image vectors at
    ``image_rows`` (what the projector's splice gives)."""
    emb = tp.embed[torch.as_tensor(ids)].float().numpy()
    rng = np.random.default_rng(seed)
    for pos in image_rows:
        emb[pos] = rng.standard_normal(emb.shape[1]) * 0.05
    return emb


def test_splice_layout_matches_jax(models):
    """ids and embeds of the single-image splice equal JAX's (text rows
    from the table, the image rows verbatim, ids 0 at the image), with the
    marker and without it (the image first)."""
    (jp, *_), (tp, *_) = models
    tok = ByteTokenizer()
    img = np.random.default_rng(0).standard_normal((4, 128)) * 0.5
    for prompt in (f"AB{vlm.IMAGE_MARKER}CD", "describe"):
        ids, emb = vlm.build_multimodal_inputs(
            tok, tp.embed, prompt, torch.from_numpy(img).to(torch.bfloat16))
        jids, jemb = jvlm.build_multimodal_inputs(
            tok, jp.embed, prompt, jnp.asarray(img, jnp.bfloat16))
        np.testing.assert_array_equal(ids, jids)
        assert emb.dtype == torch.bfloat16 and emb.shape == jemb.shape
        np.testing.assert_array_equal(emb.float().numpy(),
                                      np.asarray(jemb, np.float32))
    pre = tok.encode("AB", bos=True)
    ids, _ = vlm.build_multimodal_inputs(
        tok, tp.embed, f"AB{vlm.IMAGE_MARKER}CD", torch.zeros(4, 128))
    assert ids[0, len(pre):len(pre) + 4].tolist() == [0] * 4


def test_multi_image_splice_matches_jax(models):
    (jp, *_), (tp, *_) = models
    tok = ByteTokenizer()
    rng = np.random.default_rng(1)
    imgs = [rng.standard_normal((3, 128)).astype(np.float32),
            rng.standard_normal((2, 128)).astype(np.float32)]
    m = vlm.IMAGE_MARKER
    prompt = f"one {m} two {m} end"
    ids, emb = vlm.build_multimodal_inputs_multi(tok, tp.embed, prompt, imgs)
    jids, jemb = jvlm.build_multimodal_inputs_multi(tok, jp.embed, prompt,
                                                     imgs)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(emb, jemb)
    with pytest.raises(ValueError):
        vlm.build_multimodal_inputs_multi(tok, tp.embed, prompt, imgs[:1])


def test_forward_with_input_embeds_matches_jax(models):
    """A prompt given as embeds (image rows spliced in): logits of every
    position and the cache within FORWARD_TOL of JAX's forward, and the
    embeds, not the ids, decide them."""
    (jp, jcfg, *_), (tp, cfg, *_) = models
    ids = np.array([[3, 0, 0, 0, 9, 17, 40, 41]])
    emb = _prompt_embeds(tp, ids[0], (1, 2, 3))[None]
    jcache = jkvc.init_cache(2, 1, 32, 2, 32)
    want, jcache = jllama.forward(
        jp, jcfg, jnp.asarray(ids, jnp.int32), jcache, jnp.int32(0),
        input_embeds=jnp.asarray(emb, jnp.bfloat16), full_logits=True)
    cache = kvc.init_cache(2, 1, 32, 2, 32, device="cpu")
    got, _ = llama.forward(tp, cfg, torch.as_tensor(ids), cache, 0,
                           full_logits=True,
                           input_embeds=torch.from_numpy(emb))
    want = np.asarray(want, np.float32)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= FORWARD_TOL, err
    np.testing.assert_allclose(cache.k.float().numpy(),
                               np.asarray(jcache.k, np.float32), atol=1e-2)
    plain, _ = llama.forward(tp, cfg, torch.as_tensor(ids),
                             kvc.init_cache(2, 1, 32, 2, 32, device="cpu"),
                             0, full_logits=True)
    assert np.abs(plain.numpy() - got.numpy()).max() > 0.1


@pytest.mark.parametrize("chunk", [2048, 16])
def test_engine_embeds_greedy_matches_jax(models, chunk):
    """Engine.generate and generate_device with embeds, in one prefill
    chunk and in chunks of 16 (a 40-token prompt: two whole chunks and a
    padded tail): greedy tokens equal JAX's Engine.generate on the same
    embeds, and differ from the ids alone."""
    (jp, jcfg, jq, *_), (tp, cfg, q, *_) = models
    ids = (np.arange(20, 60) % (cfg.vocab_size - 1)) + 1
    ids[5:21] = 0
    emb = _prompt_embeds(tp, ids, range(5, 21))
    jeng = JEngine(jp, jcfg, jq, batch=1)
    jeng.CHUNK = chunk
    want = jeng.generate(ids[None].astype(np.int32), JGen(**GREEDY),
                         input_embeds=jnp.asarray(emb, jnp.bfloat16)[None]
                         ).tokens[0]
    eng = Engine(tp, cfg, q, batch=1, device="cpu")
    eng.CHUNK = chunk
    g = GenerationConfig(**GREEDY)
    got = eng.generate(ids[None], g,
                       input_embeds=torch.from_numpy(emb)[None]).tokens[0]
    dev = eng.generate_device(ids[None], g, n_tokens=8,
                              input_embeds=torch.from_numpy(emb)[None])
    assert got == list(want)
    assert dev[0].tolist() == got
    assert eng.generate(ids[None], g).tokens[0] != got


def test_generate_with_image_matches_jax_and_conditions(models):
    """generate_with_image end to end: the port's encode of the image
    agrees with JAX's within the tower's bf16 tolerance; given JAX's image
    embeddings, the port's tokens equal JAX's; a second image changes
    them."""
    (jp, jcfg, jq, jcp, jccfg), (tp, cfg, q, tcp, ccfg) = models
    tok = ByteTokenizer()
    prompt = f"{vlm.IMAGE_MARKER}describe"
    img_a, img_b = _image(2), _image(3)
    jemb = jvlm.encode_image(jcp, jccfg, img_a)
    emb = vlm.encode_image(tcp, ccfg, img_a)
    assert emb.shape == (4, 128) and emb.dtype == torch.bfloat16
    want_e = np.asarray(jemb, np.float32)
    assert np.abs(emb.float().numpy() - want_e).max() \
        <= 1e-2 * np.abs(want_e).max()
    jres = jvlm.generate_with_image(JEngine(jp, jcfg, jq), jcp, jccfg, tok,
                                    prompt, img_a, JGen(**GREEDY))
    g = GenerationConfig(**GREEDY)
    eng = Engine(tp, cfg, q, device="cpu")
    res = vlm.generate_with_image(
        eng, tcp, ccfg, tok, prompt, img_a, g,
        image_embeds=torch.from_numpy(want_e).to(torch.bfloat16))
    assert res.tokens[0] == list(jres.tokens[0])
    ra = vlm.generate_with_image(eng, tcp, ccfg, tok, prompt, img_a, g)
    rb = vlm.generate_with_image(eng, tcp, ccfg, tok, prompt, img_b, g)
    assert len(ra.tokens[0]) == len(rb.tokens[0]) == 8
    assert ra.tokens[0] != rb.tokens[0]


def test_load_image_matches_jax(tmp_path):
    """load_image decodes a file to uint8 [H, W, 3] RGB as the JAX
    package's does (PIL imported when called), a grey PNG included."""
    from PIL import Image
    rgb = np.random.default_rng(4).integers(0, 256, (9, 13, 3), np.uint8)
    Image.fromarray(rgb).save(tmp_path / "rgb.png")
    Image.fromarray(rgb[..., 0]).save(tmp_path / "grey.png")
    for name in ("rgb.png", "grey.png"):
        got = vlm.load_image(str(tmp_path / name))
        want = jvlm.load_image(str(tmp_path / name))
        assert got.dtype == np.uint8 and got.shape == (9, 13, 3)
        np.testing.assert_array_equal(got, want)
