"""LLaMA-3 BPE — tiktoken-exact byte-level BPE with the llama-3
pre-tokenization (counterpart of the JAX package's
``tokenizers/llama3_bpe.py``).

Pipeline (tiktoken semantics):
  1. split out special-token strings (<|eot_id|> etc.) verbatim,
  2. split the text as the llama-3 pattern does (contractions / letters /
     1-3 digits / punctuation / newlines / spaces: ``LLAMA3_PATTERN``),
  3. per pre-token: UTF-8 bytes → byte-token ids → rank-ordered pair merges.

Step 2 is ``pretokenize``, a scanner over ``unicodedata`` categories that
follows the pattern's alternatives in order: the pattern needs ``\\p{L}``
and ``\\p{N}``, which Python's ``re`` lacks (its nearest form,
``[^\\W\\d_]``, also takes ``No`` and ``Nl`` characters such as ``²``), and
the ``regex`` package is not a dependency of the port. Letters and numbers
are the categories ``L*`` and ``N*`` of the interpreter's Unicode tables;
whitespace is the White_Space property (``WHITESPACE``). The merge runs in
the C++ rank merger of the port's ``native/`` when it is available (as the
JAX package's does), else in the same loop in Python.

Special ids (LLaMA3Generate.cc:183-195): bos 128000 <|begin_of_text|>,
eos 128001 <|end_of_text|>, eot 128009 <|eot_id|>.

Loads a tiktoken .model (base64 ranks — pair rules derived from token
splits, which reproduces tiktoken's merge-by-merged-rank exactly) or HF
tokenizer.json (explicit merges list).
"""

from __future__ import annotations

import base64
import json
import re
import unicodedata
from pathlib import Path

from tinychatengine_tpu_torch.tokenizers.bytelevel_bpe import _BYTE_DEC

BOS_ID = 128000
EOS_ID = 128001
EOT_ID = 128009

# the llama-3 tiktoken pre-tokenization pattern (``regex`` syntax), which
# ``pretokenize`` implements
LLAMA3_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
    r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")

# ``\s`` of the pattern: the Unicode White_Space property (str.isspace also
# takes U+001C..U+001F, which the pattern's ``\s`` does not)
WHITESPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
    + "".join(map(chr, range(0x2000, 0x200b))))
_CRLF = "\r\n"
# (?i:...) under simple case folding: the letters each contraction letter
# matches
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")
_FOLD = {"S": "s", "ſ": "s", "T": "t", "R": "r", "E": "e", "V": "v",
         "M": "m", "L": "l", "D": "d"}

_LETTER, _NUMBER, _SPACE, _OTHER = range(4)


def _classify(c: str) -> int:
    if c in WHITESPACE:
        return _SPACE
    cat = unicodedata.category(c)[0]
    return _LETTER if cat == "L" else _NUMBER if cat == "N" else _OTHER


def pretokenize(text: str) -> list[str]:
    """``regex.findall(LLAMA3_PATTERN, text)``: at each position the first
    alternative that matches, as the pattern orders them. Every character
    is a letter, a number, whitespace or another character, and one of the
    alternatives takes each, so the pieces cover the text."""
    n = len(text)
    kind = [_classify(c) for c in text]
    out = []
    i = 0
    while i < n:
        k = kind[i]
        j = 0
        if text[i] == "'":                      # (?i:'s|'t|...)
            for c in _CONTRACTIONS:
                e = i + 1 + len(c)
                if e <= n and all(_FOLD.get(ch, ch) == want for ch, want
                                  in zip(text[i + 1:e], c)):
                    j = e
                    break
        if not j and (k == _LETTER or (
                i + 1 < n and kind[i + 1] == _LETTER and k != _NUMBER
                and text[i] not in _CRLF)):     # [^\r\n\p{L}\p{N}]?\p{L}+
            j = i if k == _LETTER else i + 1
            while j < n and kind[j] == _LETTER:
                j += 1
        if not j and k == _NUMBER:              # \p{N}{1,3}
            j = i + 1
            while j < n and j < i + 3 and kind[j] == _NUMBER:
                j += 1
        if not j:                               # ' ?[^\s\p{L}\p{N}]+[\r\n]*'
            s = i + 1 if text[i] == " " else i
            if s < n and kind[s] == _OTHER:
                j = s
                while j < n and kind[j] == _OTHER:
                    j += 1
                while j < n and text[j] in _CRLF:
                    j += 1
        if not j:                               # the whitespace alternatives
            e = i
            while e < n and kind[e] == _SPACE:
                e += 1
            last = max(text.rfind("\r", i, e), text.rfind("\n", i, e))
            if last >= 0:                       # \s*[\r\n]+
                j = last + 1
            elif e == n or e - i == 1:          # \s+(?!\S), else \s+
                j = e
            else:
                j = e - 1
        out.append(text[i:j])
        i = j
    return out


class Llama3BPE:
    def __init__(self, tokens: list[bytes], special: dict[str, int] | None = None,
                 merges: list[tuple[bytes, bytes]] | None = None):
        self.id_to_token = tokens
        self.token_to_id = {t: i for i, t in enumerate(tokens) if t}
        self.special = special or {}
        self.bos_id = self.special.get("<|begin_of_text|>", BOS_ID)
        self.eos_id = self.special.get("<|end_of_text|>", EOS_ID)
        self.eot_id = self.special.get("<|eot_id|>", EOT_ID)
        # pair-rule table over ids: (left_id, right_id) -> (rank, merged_id)
        self.pair_ranks = self._build_pair_ranks(merges)
        self._byte_ids = [self.token_to_id.get(bytes([b])) for b in range(256)]
        self._special_pat = None
        if self.special:
            alts = sorted(self.special, key=len, reverse=True)
            self._special_pat = re.compile(
                "(" + "|".join(re.escape(s) for s in alts) + ")")
        self._cache: dict[bytes, list[int]] = {}
        self._CACHE_CAP = 1 << 16  # per-word results; cleared when full
        self._native = None
        self._native_tried = False

    def _build_pair_ranks(self, merges):
        table: dict[tuple[int, int], tuple[int, int]] = {}
        if merges is not None:  # HF tokenizer.json: explicit ordered merges
            for rank, (a, b) in enumerate(merges):
                ia, ib, iab = (self.token_to_id.get(a), self.token_to_id.get(b),
                               self.token_to_id.get(a + b))
                if ia is None or ib is None or iab is None:
                    continue
                key = (ia, ib)
                if key not in table:
                    table[key] = (rank, iab)
            return table
        # tiktoken .model: no merges list. Derive pair rules from token
        # splits: merging the pair whose CONCAT has the lowest rank (the
        # tiktoken algorithm) == pair rules (a, b) -> t for every split of t
        # with both halves in vocab, priority rank(t).
        for t, tid in self.token_to_id.items():
            if len(t) < 2:
                continue
            for cut in range(1, len(t)):
                ia = self.token_to_id.get(t[:cut])
                ib = self.token_to_id.get(t[cut:])
                if ia is None or ib is None:
                    continue
                key = (ia, ib)
                if key not in table or tid < table[key][0]:
                    table[key] = (tid, tid)
        return table

    def _native_merger(self):
        if self._native_tried:
            return self._native
        self._native_tried = True
        try:
            from tinychatengine_tpu_torch import native
            if not native.available() or not self.pair_ranks:
                return None
            lefts = [k[0] for k in self.pair_ranks]
            rights = [k[1] for k in self.pair_ranks]
            merged = [v[1] for v in self.pair_ranks.values()]
            prio = [-float(v[0]) for v in self.pair_ranks.values()]
            self._native = native.NativeMerger(lefts, rights, merged, prio,
                                               native.RANK)
        except Exception:
            self._native = None
        return self._native

    @classmethod
    def load(cls, path: str) -> "Llama3BPE":
        p = Path(path)
        if p.suffix == ".model":  # tiktoken format: base64 token, rank
            tokens: list[bytes] = []
            for line in p.read_text().splitlines():
                if not line.strip():
                    continue
                b64, rank = line.split()
                tok = base64.b64decode(b64)
                rank = int(rank)
                while len(tokens) <= rank:
                    tokens.append(b"")
                tokens[rank] = tok
            # the llama-3 reserved special block sits above the BPE ranks;
            # ids follow the 3.1 naming (step_id/eom_id/python_tag). A 3.0
            # tokenizer.model names the same id range
            # reserved_special_token_2..4 — register those as ALIASES so 3.0
            # prompts still map their special strings to the right ids
            # (bos/eos/eot/header ids are identical across generations)
            names = (["begin_of_text", "end_of_text",
                      "reserved_special_token_0", "reserved_special_token_1",
                      "finetune_right_pad_id", "step_id", "start_header_id",
                      "end_header_id", "eom_id", "eot_id", "python_tag"])
            special = {f"<|{n}|>": len(tokens) + i for i, n in enumerate(names)}
            for alias, canon in (
                    ("reserved_special_token_2", "finetune_right_pad_id"),
                    ("reserved_special_token_3", "step_id"),
                    ("reserved_special_token_4", "eom_id"),
                    ("reserved_special_token_5", "python_tag")):
                special[f"<|{alias}|>"] = special[f"<|{canon}|>"]
            return cls(tokens, special)
        if p.name.endswith("tokenizer.json"):
            data = json.loads(p.read_text())
            vocab = data["model"]["vocab"]
            added = {t["content"]: t["id"] for t in data.get("added_tokens", [])}
            n = max(max(vocab.values()), max(added.values(), default=0)) + 1
            tokens = [b""] * n
            for t, i in vocab.items():
                tokens[i] = _hf_token_to_bytes(t)
            merges = []
            for m in data["model"]["merges"]:
                a, b = m.split(" ") if isinstance(m, str) else m
                merges.append((_hf_token_to_bytes(a), _hf_token_to_bytes(b)))
            return cls(tokens, added, merges)
        raise ValueError(path)

    def _bpe(self, word_bytes: bytes) -> list[int]:
        hit = self._cache.get(word_bytes)
        if hit is not None:
            return hit
        ids = []
        for b in word_bytes:
            tid = self._byte_ids[b]
            if tid is None:
                tid = 0  # vocab without byte coverage (degenerate)
            ids.append(tid)
        nat = self._native_merger()
        if nat is not None:
            ids = nat.encode(ids)
        else:
            while len(ids) > 1:
                best = None
                for i in range(len(ids) - 1):
                    r = self.pair_ranks.get((ids[i], ids[i + 1]))
                    if r is not None and (best is None or r[0] < best[0]):
                        best = (r[0], i, r[1])
                if best is None:
                    break
                _, i, m = best
                ids[i:i + 2] = [m]
        if len(self._cache) >= self._CACHE_CAP:  # bound memory: long-running
            self._cache.clear()                  # servers see unbounded
        self._cache[word_bytes] = ids            # distinct words otherwise
        return ids

    def _encode_plain(self, text: str, out: list[int]):
        for word in pretokenize(text):
            out.extend(self._bpe(word.encode("utf-8")))

    def encode(self, text: str, bos: bool = True,
               parse_special: bool = True) -> list[int]:
        out = [self.bos_id] if bos else []
        if parse_special and self._special_pat is not None:
            for i, seg in enumerate(self._special_pat.split(text)):
                if not seg:
                    continue
                if i % 2 == 1:  # captured special token
                    out.append(self.special[seg])
                else:
                    self._encode_plain(seg, out)
        else:
            self._encode_plain(text, out)
        return out

    def decode(self, ids) -> str:
        specials = set(self.special.values()) | {self.bos_id, self.eos_id, self.eot_id}
        data = b"".join(self.id_to_token[int(i)] for i in ids
                        if int(i) not in specials and int(i) < len(self.id_to_token))
        return data.decode("utf-8", errors="replace")

    @property
    def vocab_size(self) -> int:
        return len(self.id_to_token)


def _hf_token_to_bytes(tok: str) -> bytes:
    """HF llama3 tokenizer.json stores tokens in GPT-2 byte-unicode space."""
    try:
        return bytes(_BYTE_DEC[c] for c in tok)
    except KeyError:
        return tok.encode("utf-8")
