"""The port's tokenizers against the JAX package's on the same synthetic
vocabularies and texts: CPU twins of the ten cases of
tests/test_tokenizers.py with ids held equal to the JAX tokenizers' (whose
merges run in C++ here, the port's in Python), the Llama-3 pre-tokenizing
scanner against ``regex.findall`` of the pattern (a property over text
drawn from letters, marks, digits, other numbers, spaces, line breaks,
punctuation and emoji), and ``load_tokenizer``'s discovery against JAX's.
"""

import base64
import json
import struct
import sys
import time
import unicodedata

import pytest
import regex
from hypothesis import given, settings
from hypothesis import strategies as st

from tinychatengine_tpu.tokenizers import ByteLevelBPE as JByteLevelBPE
from tinychatengine_tpu.tokenizers import Llama3BPE as JLlama3BPE
from tinychatengine_tpu.tokenizers import SentencePieceBPE as JSentencePieceBPE
from tinychatengine_tpu.tokenizers.bytelevel_bpe import _BYTE_ENC as J_BYTE_ENC
from tinychatengine_tpu.tokenizers.streaming import \
    StreamDecoder as JStreamDecoder
from tinychatengine_tpu_torch.tokenizers import (ByteLevelBPE, Llama3BPE,
                                                 SentencePieceBPE)
from tinychatengine_tpu_torch.tokenizers.byte_fallback import ByteTokenizer
from tinychatengine_tpu_torch.tokenizers.bytelevel_bpe import _BYTE_ENC
from tinychatengine_tpu_torch.tokenizers.llama3_bpe import (LLAMA3_PATTERN,
                                                            WHITESPACE,
                                                            pretokenize)
from tinychatengine_tpu_torch.tokenizers.streaming import StreamDecoder

# the JAX test's pattern and corpus (tests/test_tokenizers.py:96-109)
LLAMA3_PAT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|"
              r"\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")

_CORPUS = [
    "hello world, hello there! I'd've said it's fine.",
    "The quick brown fox jumps over 12345 lazy dogs...",
    "def f(x):\n    return x + 1  # comment\n\n\nprint(f(2))",
    "tab\tseparated\tvalues  and   multiple spaces",
    "unicode: héllo ünïcödé 日本語テキスト 🤖🔥",
    "MixedCase WORDS and numb3rs 42 007 2048 123456789",
    "punctuation!!! ??? ... --- ### @@@ $$$ %%%",
    "trailing spaces   \nnewlines\r\nwindows\rclassic",
]
TEXTS = _CORPUS + ["", " ", "  ", "a", "\n", "ab" * 200, "héllo wörld",
                   "x² Ⅻ ½ 'S 'LL 'ſ ́a", "I'M SURE THEY'RE"]


def _mini_sp_vocab(tmp_path):
    """A llama_vocab.bin-format file with a tiny scored vocab."""
    toks = ["<unk>", "<s>", "</s>"]
    toks += [f"<0x{i:02X}>" for i in range(256)]
    words = ["h", "e", "l", "o", " ", "he", "ll", "llo", "hello", " world",
             "w", "r", "d", "wor", "ld", "world"]
    toks += words
    scores = [0.0] * len(toks)
    for i, w in enumerate(words):
        scores[259 + i] = float(len(w))  # longer merges score higher
    path = tmp_path / "llama_vocab.bin"
    with open(path, "wb") as f:
        f.write(b"\0" * 36)
        for t, s in zip(toks, scores):
            b = t.encode("utf-8")
            f.write(struct.pack("<I", len(b)) + b + struct.pack("<f", s))
    return path, len(toks)


def _both_sp(tmp_path):
    path, n = _mini_sp_vocab(tmp_path)
    return (SentencePieceBPE.from_reference_bin(path, n_vocab=n),
            JSentencePieceBPE.from_reference_bin(path, n_vocab=n))


def test_sentencepiece_bin_roundtrip(tmp_path):
    tok, jtok = _both_sp(tmp_path)
    ids = tok.encode("hello world", bos=True)
    assert ids == jtok.encode("hello world", bos=True)
    assert ids[0] == tok.bos_id
    assert tok.decode(ids) == "hello world" == jtok.decode(ids)
    assert tok.token_to_id["hello"] in ids
    for text in TEXTS:
        assert tok.encode(text) == jtok.encode(text), text[:40]


def test_sentencepiece_byte_fallback(tmp_path):
    tok, jtok = _both_sp(tmp_path)
    ids = tok.encode("héllo", bos=False)  # é not in vocab → byte tokens
    assert ids == jtok.encode("héllo", bos=False)
    assert tok.decode(ids) == jtok.decode(ids)
    assert tok.decode(ids) == "h\xc3\xa9llo" or "llo" in tok.decode(ids)


def _bytelevel_files(tmp_path):
    """A tiny GPT-2-style vocab: bytes + a few merges."""
    assert _BYTE_ENC == J_BYTE_ENC
    base = sorted(set(_BYTE_ENC.values()))
    vocab = {c: i for i, c in enumerate(base)}
    merges = []
    for pair in [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o"),
                 ("Ġ", "w"), ("Ġw", "o")]:
        merged = pair[0] + pair[1]
        if merged not in vocab:
            vocab[merged] = len(vocab)
        merges.append(pair)
    (tmp_path / "opt_vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "opt_merges.txt").write_text(
        "#version\n" + "\n".join(f"{a} {b}" for a, b in merges))
    return vocab


def test_bytelevel_bpe_roundtrip(tmp_path):
    _bytelevel_files(tmp_path)
    tok, jtok = ByteLevelBPE.load(str(tmp_path)), JByteLevelBPE.load(
        str(tmp_path))
    ids = tok.encode("hello world")
    assert tok.decode(ids) == "hello world"
    assert tok.vocab.get("hello") in ids
    for text in TEXTS:
        ids = tok.encode(text)
        assert ids == jtok.encode(text), text[:40]
        assert tok.decode(ids) == jtok.decode(ids)


def _tiny_llama3(cls):
    tokens = [bytes([i]) for i in range(256)]
    for w in [b"he", b"ll", b"llo", b"hello", b" wo", b"rld", b" world"]:
        tokens.append(w)
    return cls(tokens, special={"<|begin_of_text|>": len(tokens),
                                "<|end_of_text|>": len(tokens) + 1,
                                "<|eot_id|>": len(tokens) + 2})


def test_llama3_roundtrip():
    tok, jtok = _tiny_llama3(Llama3BPE), _tiny_llama3(JLlama3BPE)
    ids = tok.encode("hello world", bos=True)
    assert ids[0] == tok.bos_id
    assert tok.decode(ids) == "hello world"
    for text in TEXTS:
        assert tok.encode(text) == jtok.encode(text), text[:40]


def test_llama3_tiktoken_model_loader(tmp_path):
    lines = [f"{base64.b64encode(tok).decode()} {rank}"
             for rank, tok in enumerate([b"a", b"b", b"ab", b"ba"])]
    p = tmp_path / "tokenizer.model"
    p.write_text("\n".join(lines))
    tok, jtok = Llama3BPE.load(str(p)), JLlama3BPE.load(str(p))
    assert tok.id_to_token == jtok.id_to_token
    assert tok.special == jtok.special
    assert tok.pair_ranks == jtok.pair_ranks
    assert tok.id_to_token[2] == b"ab"
    ids = tok.encode("abab", bos=False)
    assert ids == jtok.encode("abab", bos=False)
    assert tok.decode(ids) == "abab"


def _train_llama3_style(tmp_path, specials=("<|begin_of_text|>",
                                            "<|end_of_text|>", "<|eot_id|>")):
    """A tiny byte-level BPE trained with the llama-3 split pattern by the
    HF tokenizers library → tokenizer.json (the JAX test's fixture)."""
    tokenizers = pytest.importorskip("tokenizers")
    tok = tokenizers.Tokenizer(tokenizers.models.BPE())
    pre = tokenizers.pre_tokenizers
    tok.pre_tokenizer = pre.Sequence([
        pre.Split(tokenizers.Regex(LLAMA3_PAT), behavior="isolated"),
        pre.ByteLevel(add_prefix_space=False, use_regex=False)])
    trainer = tokenizers.trainers.BpeTrainer(
        vocab_size=640, show_progress=False,
        initial_alphabet=pre.ByteLevel.alphabet())
    tok.train_from_iterator(_CORPUS * 4, trainer)
    tok.add_special_tokens(list(specials))
    p = tmp_path / "tokenizer.json"
    tok.save(str(p))
    return tok, p


def test_llama3_hf_parity(tmp_path):
    """Ids equal to the HF tokenizers library's and to the JAX
    Llama3BPE's on the HF-trained llama-3-architecture tokenizer."""
    hf, p = _train_llama3_style(tmp_path)
    mine, jax_tok = Llama3BPE.load(str(p)), JLlama3BPE.load(str(p))
    for text in TEXTS:
        got = mine.encode(text, bos=False)
        assert got == hf.encode(text, add_special_tokens=False).ids, text[:40]
        assert got == jax_tok.encode(text, bos=False), text[:40]


def test_llama3_specials_in_text(tmp_path):
    hf, p = _train_llama3_style(tmp_path)
    mine, jax_tok = Llama3BPE.load(str(p)), JLlama3BPE.load(str(p))
    text = "<|begin_of_text|>hello world<|eot_id|>more text<|end_of_text|>"
    got = mine.encode(text, bos=False)
    assert got == jax_tok.encode(text, bos=False)
    assert mine.special["<|begin_of_text|>"] == got[0]
    assert mine.special["<|eot_id|>"] in got
    assert got[-1] == mine.special["<|end_of_text|>"]
    got_plain = mine.encode(text, bos=False, parse_special=False)
    assert got_plain == jax_tok.encode(text, bos=False, parse_special=False)
    assert mine.special["<|eot_id|>"] not in got_plain


def test_llama3_long_prompt_speed(tmp_path):
    """The pure-Python scanner and merge stay near-linear on long prompts
    (the JAX test's bound, which its C++ merger meets)."""
    hf, p = _train_llama3_style(tmp_path)
    mine = Llama3BPE.load(str(p))
    text = " ".join(_CORPUS) * 50  # ~20k chars
    t0 = time.perf_counter()
    got = mine.encode(text, bos=False)
    dt = time.perf_counter() - t0
    assert got == hf.encode(text, add_special_tokens=False).ids
    assert dt < 2.0, f"long-prompt encode too slow: {dt:.2f}s"


def test_stream_decoder_multibyte_safety():
    tok = ByteTokenizer()
    text = "héllo ünïcödé 日本語 🤖 done"
    ids = tok.encode(text, bos=False)
    pieces = [[], []]
    for out, cls in zip(pieces, (StreamDecoder, JStreamDecoder)):
        sdec = cls(tok)
        out.extend(sdec.feed(t) for t in ids)
        out.append(sdec.flush())
    assert pieces[0] == pieces[1]
    out = "".join(pieces[0])
    assert out == tok.decode(ids)
    assert "�" not in out


def test_stream_decoder_window_reset_long_output():
    tok = ByteTokenizer()
    text = "abc " * 100
    ids = tok.encode(text, bos=False)
    sdec, jsdec = StreamDecoder(tok), JStreamDecoder(tok)
    got = [sdec.feed(t) for t in ids] + [sdec.flush()]
    assert got == [jsdec.feed(t) for t in ids] + [jsdec.flush()]
    assert "".join(got) == text


# ---- the pre-tokenizing scanner against regex -------------------------------

_PAT = regex.compile(LLAMA3_PAT)


def test_scanner_pattern_and_tables_match_regex():
    """The port's pattern is the JAX test's; its whitespace set is the
    pattern's ``\\s`` and its letters and numbers are ``\\p{L}`` and
    ``\\p{N}`` wherever the interpreter's Unicode tables assign the code
    point; the contraction letters fold as ``(?i:...)`` folds them."""
    assert LLAMA3_PATTERN == LLAMA3_PAT
    every = "".join(chr(c) for c in range(sys.maxunicode + 1)
                    if not 0xD800 <= c < 0xE000)
    assert set(regex.findall(r"\s", every)) == WHITESPACE
    assigned = "".join(c for c in every if unicodedata.category(c) != "Cn")
    for cls, cat in ((r"\p{L}", "L"), (r"\p{N}", "N")):
        assert set(regex.findall(cls, assigned)) == \
            {c for c in assigned if unicodedata.category(c)[0] == cat}
    for letter in "strevmld":
        folds = regex.findall(f"(?i:'{letter})", "".join(
            "'" + c for c in every))
        assert {f[1] for f in folds} == {
            c for c in every if c in (letter, letter.upper())
            or (letter == "s" and c == "ſ")}
    for text in _CORPUS:
        assert pretokenize(text) == _PAT.findall(text)


def _pick(cats, limit=64):
    """Up to ``limit`` characters of each category in ``cats``, spread over
    the planes below U+30000."""
    found = {c: [] for c in cats}
    for cp in range(0x20, 0x30000):
        cat = unicodedata.category(chr(cp))
        if cat in found:
            found[cat].append(chr(cp))
    return [c for chars in found.values()
            for c in chars[::max(1, len(chars) // limit)][:limit]]


_ALPHABET = sorted(set(
    list("abcXYZ'sStTrRmMlLdDeEvVſ0123456789 \t\r\n.,!?-_#@$%()[]{}\"")
    + _pick(("Lu", "Ll", "Lt", "Lm", "Lo", "Mn", "Mc", "Me", "Nd", "Nl", "No",
             "Pc", "Pd", "Ps", "Pe", "Po", "Sm", "Sc", "Sk", "So", "Zs",
             "Cc"))
    + list("🤖🔥👍🏽‍  　\x85\xa0\x1c\x1f")))


@settings(max_examples=300, deadline=None, derandomize=True)
@given(st.text(alphabet=_ALPHABET, max_size=80))
def test_scanner_equals_regex_findall(text):
    """``pretokenize`` = ``regex.findall(LLAMA3_PAT)`` on text from letters
    (every L category), marks, digits, Nl / No numbers, spaces (U+0020,
    tabs, the Zs and line-separator code points), CR / LF, punctuation,
    symbols, controls (U+001C..U+001F are not ``\\s``) and emoji."""
    assert pretokenize(text) == _PAT.findall(text)


# ---- load_tokenizer ----------------------------------------------------------

def test_load_tokenizer_discovery_matches_jax(tmp_path):
    """The same files give the same tokenizer class and ids as the JAX
    package's ``load_tokenizer``: tiktoken for llama3, SentencePiece for
    the llama family, byte-level BPE for OPT, the byte tokenizer when
    nothing loads."""
    from tinychatengine_tpu.core.config import get_model_config as jget
    from tinychatengine_tpu.tools.checkpoint import \
        load_tokenizer as jload_tokenizer
    from tinychatengine_tpu_torch.core.config import get_model_config
    from tinychatengine_tpu_torch.tools.checkpoint import load_tokenizer

    d3 = tmp_path / "llama3"
    d3.mkdir()
    (d3 / "tokenizer.model").write_text("\n".join(
        f"{base64.b64encode(t).decode()} {r}"
        for r, t in enumerate([bytes([i]) for i in range(256)]
                              + [b"he", b"ll", b"hello"])))
    dsp = tmp_path / "llama2"
    dsp.mkdir()
    pieces = ["<unk>", "<s>", "</s>", "▁", "h", "e", "l", "o", "w", "r", "d",
              "he", "ll", "▁hello", "▁world", "hello"]
    (dsp / "tokenizer.json").write_text(json.dumps(
        {"model": {"vocab": {t: i for i, t in enumerate(pieces)}}}))
    dopt = tmp_path / "opt"
    dopt.mkdir()
    _bytelevel_files(dopt)
    empty = tmp_path / "empty"
    empty.mkdir()
    cases = [("llama3_8b", d3, Llama3BPE),
             ("llama2_7b", dsp, SentencePieceBPE),
             ("opt_125m", dopt, ByteLevelBPE),
             ("llama2_7b", empty, ByteTokenizer)]
    for model, path, cls in cases:
        mine = load_tokenizer(str(path), get_model_config(model))
        theirs = jload_tokenizer(str(path), jget(model))
        assert isinstance(mine, cls), (model, type(mine))
        assert type(mine).__name__ == type(theirs).__name__
        for text in ("hello world", "héllo <|eot_id|> 42"):
            assert mine.encode(text) == theirs.encode(text), (model, text)
