"""Trivial byte tokenizer — demo/testing fallback when no vocab file exists
(zero-egress environments). 256 byte tokens + bos(256)/eos(257)."""

from __future__ import annotations


class ByteTokenizer:
    bos_id = 256
    eos_id = 257
    vocab_size = 258

    def encode(self, text: str, bos: bool = True) -> list[int]:
        out = [self.bos_id] if bos else []
        out.extend(text.encode("utf-8"))
        return out

    def decode(self, ids) -> str:
        return bytes(int(i) for i in ids if int(i) < 256).decode(
            "utf-8", errors="replace")
