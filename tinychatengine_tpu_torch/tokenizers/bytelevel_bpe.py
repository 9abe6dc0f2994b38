"""GPT-2 byte-level BPE (OPT / StarCoder families; counterpart of the JAX
package's ``tokenizers/bytelevel_bpe.py``).

Re-implementation of the reference's encoders (llm/src/OPTTokenizer.cc,
llm/src/GPTBigCodeTokenizer.cc — both GPT-2 style): text → regex-ish word
split → bytes mapped to printable unicode → rank-ordered pair merges →
vocab lookup. Loads ``vocab.json`` + ``merges.txt`` (the files the reference
ships as opt_vocab.json/opt_merges.txt) or HF ``tokenizer.json``.

The merge runs in Python: the JAX package's C++ rank merger (its
``native/``) is not ported yet, and this is the same algorithm as its
fallback.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

# GPT-2 word-splitting pattern
_PAT = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\s\d\W]+| ?\d+| ?[^\s\w]+|\s+(?!\S)|\s+",
    re.UNICODE)


def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte→printable-unicode map."""
    bs = list(range(ord("!"), ord("~") + 1)) + \
        list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


_BYTE_ENC = _bytes_to_unicode()
_BYTE_DEC = {v: k for k, v in _BYTE_ENC.items()}


class ByteLevelBPE:
    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 bos_id: int = 2, eos_id: int = 2, unk_token: str = "<unk>"):
        self.vocab = vocab
        self.id_to_token = {i: t for t, i in vocab.items()}
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        self.bos_id, self.eos_id = bos_id, eos_id
        self.unk_id = vocab.get(unk_token, 0)
        self._cache: dict[str, list[int]] = {}

    @classmethod
    def load(cls, path: str) -> "ByteLevelBPE":
        p = Path(path)
        if p.is_dir():
            vocab_file = next(iter(sorted(p.glob("*vocab.json"))))
            merges_file = next(iter(sorted(p.glob("*merges.txt"))))
            return cls.from_files(vocab_file, merges_file)
        if p.name.endswith("tokenizer.json"):
            data = json.loads(p.read_text())
            vocab = data["model"]["vocab"]
            merges = [tuple(m.split(" ") if isinstance(m, str) else m)
                      for m in data["model"]["merges"]]
            return cls(vocab, merges)
        raise ValueError(path)

    @classmethod
    def from_files(cls, vocab_json, merges_txt) -> "ByteLevelBPE":
        vocab = json.loads(Path(vocab_json).read_text())
        merges = []
        for line in Path(merges_txt).read_text().splitlines():
            if line.startswith("#") or not line.strip():
                continue
            a, b = line.split(" ")[:2]
            merges.append((a, b))
        return cls(vocab, merges)

    def _bpe(self, word: str) -> list[int]:
        """word (byte-mapped) → token ids: the lowest-ranked adjacent pair
        merges first, until no pair has a rank."""
        if word in self._cache:
            return self._cache[word]
        parts = list(word)
        while len(parts) > 1:
            pairs = [(self.ranks.get((parts[i], parts[i + 1]), 1 << 60), i)
                     for i in range(len(parts) - 1)]
            rank, i = min(pairs)
            if rank >= 1 << 60:
                break
            parts = parts[:i] + [parts[i] + parts[i + 1]] + parts[i + 2:]
        ids = [self.vocab.get(tok, self.unk_id) for tok in parts]
        self._cache[word] = ids
        return ids

    def encode(self, text: str, bos: bool = False) -> list[int]:
        out = [self.bos_id] if bos else []
        for word in _PAT.findall(text):
            mapped = "".join(_BYTE_ENC[b] for b in word.encode("utf-8"))
            out.extend(self._bpe(mapped))
        return out

    def decode(self, ids) -> str:
        text = "".join(self.id_to_token.get(int(i), "") for i in ids)
        data = bytes(_BYTE_DEC[c] for c in text if c in _BYTE_DEC)
        return data.decode("utf-8", errors="replace")

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)
