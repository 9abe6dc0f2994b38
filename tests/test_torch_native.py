"""The port's native C++ library (``tinychatengine_tpu_torch/native``)
against the JAX package's and against the pure-Python paths (CPU twins of
tests/test_native.py): the threaded reader equals ``np.fromfile``, a
missing file raises, and the three tokenizers' C++ merges give the ids of
their Python merges and of the JAX tokenizers, in both modes (the C++
library on, and off through ``_native_tried``); a merge the id table
cannot represent turns the C++ path off; ``TINYCHAT_NO_NATIVE`` turns the
library off; it builds with g++ into ``build/tce_native/``."""

import numpy as np
import pytest

from tinychatengine_tpu import native as jnative
from tinychatengine_tpu.tokenizers.bytelevel_bpe import \
    ByteLevelBPE as JByteLevelBPE
from tinychatengine_tpu.tokenizers.llama3_bpe import Llama3BPE as JLlama3BPE
from tinychatengine_tpu.tokenizers.sentencepiece_bpe import \
    SentencePieceBPE as JSentencePieceBPE
from tinychatengine_tpu_torch import native
from tinychatengine_tpu_torch.tokenizers.bytelevel_bpe import (_BYTE_ENC,
                                                               ByteLevelBPE)
from tinychatengine_tpu_torch.tokenizers.llama3_bpe import Llama3BPE
from tinychatengine_tpu_torch.tokenizers.sentencepiece_bpe import \
    SentencePieceBPE

pytestmark = pytest.mark.skipif(
    not (native.available() and jnative.available()),
    reason="native toolchain unavailable")

# tests/test_native.py's texts, and a piece no toy vocabulary holds
TEXTS = [
    "Hello, world!",
    "The quick brown fox jumps over the lazy dog. 1234567890",
    "  leading spaces and\nnewlines\tand tabs  ",
    "naïve café — déjà vu: ünïcödé 日本語のテキスト 🤖🚀",
    "x" * 500,
    "a b c d e f g h i j k l m n o p q r s t u v w x y z",
    "",
    "don't stop believin' — it's 'quoted'",
]


def _python(tok):
    tok._native_tried = True  # the Python merge loop
    return tok


def _bytelevel_parts():
    """tests/test_native.py's toy vocab: all byte chars + some merges."""
    chars = sorted(set(_BYTE_ENC.values()))
    vocab = {c: i for i, c in enumerate(chars)}
    merges = []
    for pair in [("t", "h"), ("th", "e"), ("Ġ", "t"), ("i", "n"),
                 ("o", "u"), ("e", "r"), ("Ġt", "he"), ("in", "g")]:
        if pair[0] in vocab or pair[0] in [a + b for a, b in merges]:
            merges.append(pair)
    for a, b in merges:
        if a + b not in vocab:
            vocab[a + b] = len(vocab)
    return vocab, merges


def _spm_parts(byte_tokens: bool):
    tokens = ["<unk>", "<s>", "</s>"]
    if byte_tokens:
        tokens += [f"<0x{b:02X}>" for b in range(256)]
    scores = [0.0] * len(tokens)
    words = ["▁the", "▁a", "▁an", "the", "he", "▁t", "▁th", "in", "ing",
             "▁quick", "qu", "ick", "▁fox", "fo", "x", "▁hello", "hell",
             "o", "▁world", "wor", "ld", "▁", "e", "t", "h", "a", "b", "c",
             "d", "f", "g", "i", "j", "k", "l", "m", "n", "p", "q", "r",
             "s", "u", "v", "w", "y", "z", ",", ".", "!", "'"]
    for i, w in enumerate(words):
        tokens.append(w)
        scores.append(-float(i) * 0.25)
    return tokens, scores


def test_bytelevel_native_matches_python_and_jax():
    vocab, merges = _bytelevel_parts()
    nat, py = ByteLevelBPE(vocab, merges), _python(ByteLevelBPE(vocab, merges))
    jnat = JByteLevelBPE(vocab, merges)
    jpy = _python(JByteLevelBPE(vocab, merges))
    assert nat._native_merger() is not None
    assert jnat._native_merger() is not None
    for t in TEXTS:
        ids = nat.encode(t)
        assert ids == py.encode(t) == jnat.encode(t) == jpy.encode(t), t
        assert nat.decode(ids) == jnat.decode(ids)


def test_bytelevel_native_disabled_on_unrepresentable_merge():
    """A merge whose RESULT the vocab lacks cannot live in the id table:
    the Python loop applies it and emits unk_id, so the C++ path is off
    (as JAX's); a rule with merely unreachable pieces is dropped and the
    C++ path stays on."""
    chars = sorted(set(_BYTE_ENC.values()))
    vocab = {c: i for i, c in enumerate(chars)}
    vocab["th"] = len(vocab)
    tok = ByteLevelBPE(vocab, [("t", "h"), ("th", "e")])
    assert tok._native_merger() is None
    assert tok.encode("the") == [tok.unk_id]
    assert tok.encode("the") == JByteLevelBPE(
        vocab, [("t", "h"), ("th", "e")]).encode("the")
    vocab["zzq"] = len(vocab)  # "zz" is neither in the vocab nor made
    dropped = ByteLevelBPE(vocab, [("t", "h"), ("zz", "q")])
    assert dropped._native_merger() is not None
    assert dropped.encode("the thq") == _python(
        ByteLevelBPE(vocab, [("t", "h"), ("zz", "q")])).encode("the thq")


@pytest.mark.parametrize("byte_tokens", [True, False])
def test_spm_native_matches_python_and_jax(byte_tokens):
    """Each mode equals JAX's same mode; the two modes differ only on a
    piece the vocabulary lacks (without byte tokens: one unk from C++, an
    unk per byte from Python), as JAX's two do."""
    tokens, scores = _spm_parts(byte_tokens)

    def pair(cls):
        return (cls(tokens, scores, sp_space=True),
                _python(cls(tokens, scores, sp_space=True)))
    (nat, py), (jnat, jpy) = pair(SentencePieceBPE), pair(JSentencePieceBPE)
    assert nat._native_encoder() is not None
    for t in TEXTS:
        assert nat.encode(t, bos=True) == jnat.encode(t, bos=True), t
        assert py.encode(t, bos=True) == jpy.encode(t, bos=True), t
        if byte_tokens or t.isascii():
            assert nat.encode(t, bos=True) == py.encode(t, bos=True), t
        assert nat.decode(nat.encode(t)) == jnat.decode(jnat.encode(t))
    if not byte_tokens:
        assert nat.encode("日本", bos=False) != py.encode("日本", bos=False)


def test_llama3_native_matches_python_and_jax():
    tokens = [bytes([i]) for i in range(256)]
    for w in [b"he", b"ll", b"llo", b"hello", b" wo", b"rld", b" world",
              b"Th", b"The", b" qu", b"ick"]:
        tokens.append(w)
    special = {"<|begin_of_text|>": len(tokens),
               "<|end_of_text|>": len(tokens) + 1}
    nat, py = Llama3BPE(tokens, dict(special)), _python(
        Llama3BPE(tokens, dict(special)))
    jnat = JLlama3BPE(tokens, dict(special))
    assert nat._native_merger() is not None
    for t in TEXTS + ["hello world<|end_of_text|>The quick"]:
        ids = nat.encode(t)
        assert ids == py.encode(t) == jnat.encode(t), t


def test_native_read_file(tmp_path):
    data = np.random.default_rng(0).standard_normal(1 << 16).astype(
        np.float32)
    p = tmp_path / "t.bin"
    data.tofile(p)
    got = native.read_file(str(p), np.float32, n_threads=4)
    np.testing.assert_array_equal(got, data)
    np.testing.assert_array_equal(got, jnative.read_file(str(p), np.float32))
    got2 = native.read_file(str(p), np.float32, count=100, offset=400)
    np.testing.assert_array_equal(got2, data[100:200])
    assert native.read_file(str(p), np.uint8, count=0).size == 0


def test_native_read_missing_file():
    with pytest.raises(FileNotFoundError):
        native.read_file("/nonexistent/file.bin", np.float32)


def test_native_builds_into_build_dir_and_switches_off(monkeypatch):
    lib = native.load_library()
    assert lib is not None and native._target().exists()
    assert native._target().parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "tce_native")
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setenv("TINYCHAT_NO_NATIVE", "1")
    assert not native.available()
    p = native._SRC / "loader.cc"  # the fallback reads as np.fromfile does
    np.testing.assert_array_equal(native.read_file(str(p), np.uint8),
                                  np.fromfile(p, np.uint8))
    vocab, merges = _bytelevel_parts()
    assert ByteLevelBPE(vocab, merges)._native_merger() is None
