"""SentencePiece-style score-based BPE (LLaMA 1/2 family; counterpart of the
JAX package's ``tokenizers/sentencepiece_bpe.py``).

Re-implementation of the llama.cpp-derived tokenizer the reference uses
(llm/src/LLaMATokenizer.cc): split text into UTF-8 characters, then greedily
merge the adjacent pair whose concatenation is a vocab token with the highest
score, until no merge applies. bos=1, eos=2, unk=0
(llm/include/LLaMATokenizer.h:20-24).

Loads either the reference's ``llama_vocab.bin`` (9 ignored u32s, then
n_vocab x {u32 len, bytes, f32 score}) or a HF ``tokenizer.json``
(sentencepiece-exported, with ▁ word markers).

The whole-text encode runs in the C++ encoder of the port's ``native/``
when it is available (as the JAX package's does), else in the same
algorithm in Python. The two differ only on a piece the vocabulary lacks,
as JAX's two do: the C++ encoder falls back to byte tokens where
``<0x00>``..``<0xFF>`` hold one contiguous id range, else to one ``unk``;
the Python loop emits one token per byte, ``unk`` where a byte token is
missing.
"""

from __future__ import annotations

import heapq
import json
import struct
from pathlib import Path


def _utf8_char_lengths(b: bytes):
    """Split a UTF-8 byte string into character-sized chunks (lengths)."""
    lens = []
    i = 0
    while i < len(b):
        c = b[i]
        n = 1 if c < 0x80 else 2 if c >> 5 == 0b110 else 3 if c >> 4 == 0b1110 \
            else 4 if c >> 3 == 0b11110 else 1
        n = min(n, len(b) - i)
        lens.append(n)
        i += n
    return lens


class SentencePieceBPE:
    def __init__(self, tokens: list[str], scores: list[float],
                 bos_id: int = 1, eos_id: int = 2, unk_id: int = 0,
                 sp_space: bool = False):
        self.id_to_token = tokens
        self.scores = scores
        self.token_to_id = {t: i for i, t in enumerate(tokens)}
        self.bos_id, self.eos_id, self.unk_id = bos_id, eos_id, unk_id
        self.sp_space = sp_space  # vocab uses ▁ (HF) vs literal space (ref bin)
        self._native = None        # lazily-built C++ encoder (native/)
        self._native_tried = False

    def _native_encoder(self):
        """C++ whole-text encoder (native/src/bpe.cc tce_spm_*); None if the
        native library is unavailable. Byte fallback uses the contiguous
        <0x00>..<0xFF> id range when the vocab has one."""
        if self._native_tried:
            return self._native
        self._native_tried = True
        try:
            from tinychatengine_tpu_torch import native
            if not native.available():
                return None
            base = self.token_to_id.get("<0x00>", -1)
            if base >= 0 and self.token_to_id.get("<0xFF>") != base + 255:
                base = -1  # non-contiguous byte tokens: let unk handle it
            self._native = native.NativeSPM(
                [t.encode("utf-8") for t in self.id_to_token], self.scores,
                byte_fallback_base=base, unk_id=self.unk_id)
        except Exception:
            self._native = None
        return self._native

    # -- loading -------------------------------------------------------------
    @classmethod
    def load(cls, path: str) -> "SentencePieceBPE":
        p = Path(path)
        if p.suffix == ".bin":
            return cls.from_reference_bin(p)
        if p.name.endswith("tokenizer.json") or p.suffix == ".json":
            return cls.from_hf_json(p)
        raise ValueError(f"unknown tokenizer file {path}")

    @classmethod
    def from_reference_bin(cls, path, n_vocab: int = 32000) -> "SentencePieceBPE":
        """llama_vocab.bin (LLaMATokenizer.cc llama_init_vocab format)."""
        tokens, scores = [], []
        with open(path, "rb") as f:
            f.read(9 * 4)  # dummy header
            for _ in range(n_vocab):
                (ln,) = struct.unpack("<I", f.read(4))
                tokens.append(f.read(ln).decode("utf-8", errors="replace"))
                (sc,) = struct.unpack("<f", f.read(4))
                scores.append(sc)
        return cls(tokens, scores, sp_space=False)

    @classmethod
    def from_hf_json(cls, path) -> "SentencePieceBPE":
        data = json.loads(Path(path).read_text())
        vocab = data["model"]["vocab"]
        if isinstance(vocab, dict):  # BPE-style: derive scores from rank
            tokens = [None] * len(vocab)
            for t, i in vocab.items():
                tokens[i] = t
            scores = [-float(i) for i in range(len(tokens))]
        else:  # Unigram: [token, score] pairs
            tokens = [t for t, _ in vocab]
            scores = [s for _, s in vocab]
        return cls(tokens, scores, sp_space=True)

    # -- encode/decode -------------------------------------------------------
    def encode(self, text: str, bos: bool = True) -> list[int]:
        if self.sp_space:
            text = "▁" + text.replace(" ", "▁")
        out = []
        if bos:
            out.append(self.bos_id)
        if not text:
            return out

        nat = self._native_encoder()
        if nat is not None:
            return out + nat.encode(text.encode("utf-8"))

        # symbols = utf-8 characters; greedy highest-score merges via heap
        chars = []
        bs = text.encode("utf-8")
        i = 0
        for n in _utf8_char_lengths(bs):
            chars.append(bs[i:i + n].decode("utf-8", errors="replace"))
            i += n

        prev = list(range(-1, len(chars) - 1))
        nxt = list(range(1, len(chars) + 1))
        nxt[-1] = -1
        alive = [True] * len(chars)
        heap = []

        def try_add(l, r):
            if l < 0 or r < 0 or r >= len(chars):
                return
            merged = chars[l] + chars[r]
            tid = self.token_to_id.get(merged)
            if tid is not None:
                heapq.heappush(heap, (-self.scores[tid], l, r, merged))

        for j in range(1, len(chars)):
            try_add(j - 1, j)

        while heap:
            _, l, r, merged = heapq.heappop(heap)
            if not (alive[l] and alive[r]) or chars[l] + chars[r] != merged:
                continue
            chars[l] = merged
            alive[r] = False
            nxt[l] = nxt[r]
            if nxt[r] != -1:
                prev[nxt[r]] = l
            try_add(prev[l], l)
            try_add(l, nxt[l])

        j = 0
        while j != -1 and j < len(chars):
            if alive[j]:
                tid = self.token_to_id.get(chars[j])
                if tid is not None:
                    out.append(tid)
                else:  # byte fallback: <0xXX> tokens (sentencepiece convention)
                    for byte in chars[j].encode("utf-8"):
                        out.append(self.token_to_id.get(f"<0x{byte:02X}>",
                                                        self.unk_id))
            j = nxt[j]
        return out

    def decode(self, ids) -> str:
        parts = []
        for i in ids:
            if i in (self.bos_id, self.eos_id):
                continue
            t = self.id_to_token[int(i)]
            if t.startswith("<0x") and t.endswith(">") and len(t) == 6:
                parts.append(chr(int(t[3:5], 16)))
            else:
                parts.append(t)
        s = "".join(parts)
        return s.replace("▁", " ") if self.sp_space else s

    @property
    def vocab_size(self) -> int:
        return len(self.id_to_token)
