"""Streaming-safe token-to-text decoding (counterpart of the JAX package's
``tokenizers/streaming.py``).

Decoding one token at a time breaks multi-byte UTF-8: a byte-fallback or
byte-level token can end mid-character and ``decode([t])`` emits replacement
glyphs (the reference prints raw bytes and has the same mojibake risk,
LLaMA3Generate.cc decode loop). This wrapper buffers the decoded-so-far
token window and only emits the longest valid UTF-8 prefix delta.
"""

from __future__ import annotations


class StreamDecoder:
    """Incremental detokenizer over any tokenizer with decode(ids) -> str.

    feed(token_id) returns the newly-safe text (possibly ""); flush()
    returns whatever remains (with replacement chars if truly malformed).
    """

    def __init__(self, tok):
        self._tok = tok
        self._ids: list[int] = []
        self._emitted = 0  # chars of decode(self._ids) already returned

    def feed(self, token_id: int) -> str:
        self._ids.append(int(token_id))
        text = self._tok.decode(self._ids)
        # hold back a potentially-incomplete tail: if the text ends in a
        # replacement char, the last token(s) may be a partial UTF-8 sequence
        safe_end = len(text)
        while safe_end > self._emitted and text[safe_end - 1] == "�":
            safe_end -= 1
        out = text[self._emitted:safe_end]
        self._emitted = safe_end
        # bound the window: once everything emitted cleanly, restart it
        if self._emitted == len(text) and len(self._ids) > 64:
            self._ids.clear()
            self._emitted = 0
        return out

    def flush(self) -> str:
        text = self._tok.decode(self._ids)
        out = text[self._emitted:]
        self._ids.clear()
        self._emitted = 0
        return out
