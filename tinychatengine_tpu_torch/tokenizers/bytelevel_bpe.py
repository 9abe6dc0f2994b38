"""GPT-2 byte-level BPE (OPT / StarCoder families; counterpart of the JAX
package's ``tokenizers/bytelevel_bpe.py``).

Re-implementation of the reference's encoders (llm/src/OPTTokenizer.cc,
llm/src/GPTBigCodeTokenizer.cc — both GPT-2 style): text → regex-ish word
split → bytes mapped to printable unicode → rank-ordered pair merges →
vocab lookup. Loads ``vocab.json`` + ``merges.txt`` (the files the reference
ships as opt_vocab.json/opt_merges.txt) or HF ``tokenizer.json``.

The merge runs in the C++ rank merger of the port's ``native/`` when it
is available (as the JAX package's does), else in the same loop in Python;
a merge whose result the vocabulary lacks turns the C++ path off.
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
        self._native = None
        self._native_tried = False

    def _native_merger(self):
        """C++ rank-merge engine over vocab ids (native/src/bpe.cc); None if
        unavailable or a merge references a token missing from the vocab."""
        if self._native_tried:
            return self._native
        self._native_tried = True
        try:
            from tinychatengine_tpu_torch import native
            if not native.available():
                return None
            # Strings the Python merge loop can create as intermediate parts:
            producible = {a + b for (a, b) in self.ranks}
            lefts, rights, merged, prio = [], [], [], []
            for (a, b), rank in self.ranks.items():
                ia, ib, iab = (self.vocab.get(a), self.vocab.get(b),
                               self.vocab.get(a + b))
                if iab is None:
                    # The Python loop APPLIES this merge (creating a string
                    # that later emits unk_id or feeds further merges); the
                    # id-domain table cannot represent it — native would
                    # silently diverge, so disable the native path.
                    return None
                if ia is None or ib is None:
                    # A piece missing from the vocab is only reachable if
                    # some other rule produces it; unreachable rules are
                    # safely dropped, reachable ones force the Python path.
                    if (ia is None and a in producible) or \
                       (ib is None and b in producible):
                        return None
                    continue
                lefts.append(ia)
                rights.append(ib)
                merged.append(iab)
                prio.append(-float(rank))
            self._native = native.NativeMerger(lefts, rights, merged, prio,
                                               native.RANK)
        except Exception:
            self._native = None
        return self._native

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
        merges first, until no pair has a rank. Native C++ merge loop when
        available; identical pure-Python loop otherwise."""
        if word in self._cache:
            return self._cache[word]
        nat = self._native_merger()
        init_ids = None
        if nat is not None:
            init_ids = [self.vocab.get(c) for c in word]
            if any(i is None for i in init_ids):
                init_ids = None  # char outside vocab: python path handles unk
        if init_ids is not None:
            ids = nat.encode(init_ids)
        else:
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
