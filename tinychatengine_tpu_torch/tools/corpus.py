"""Deterministic local-source corpus for the in-repo accuracy pyramid (copy
of the JAX package's ``tools/corpus.py``).

The reference anchors its accuracy claims to WikiText-2 numbers measured
outside the repo (SURVEY.md §6; README accuracy tables). Nothing is
downloaded: the accuracy pyramid trains and evaluates on text that ships
with the machine: the
Python standard library + site-packages sources (~0.5 GB). Byte-level
tokenization (tokenizers/byte_fallback.py) keeps the pipeline vocab-free,
so perplexity is bits-per-byte-equivalent and directly comparable across
quantization schemes.

The corpus is DETERMINISTIC (sorted file walk, fixed caps), so one
machine's Python installation always gives the same bytes; another
installation gives another corpus.
"""

from __future__ import annotations

import glob
import os
import site
import sysconfig

DEFAULT_ROOTS = tuple([sysconfig.get_paths()["stdlib"]]
                      + list(site.getsitepackages()))

# Files bigger than this are almost always generated tables (unicodedata
# dumps etc.) — they poison a language-modeling corpus with megabytes of
# hex literals.
_MAX_FILE = 256 << 10
_MIN_FILE = 256


def iter_files(roots=DEFAULT_ROOTS):
    for root in roots:
        for path in sorted(glob.iglob(os.path.join(root, "**", "*.py"),
                                      recursive=True)):
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            if _MIN_FILE <= size <= _MAX_FILE:
                yield path


def build_corpus(roots=DEFAULT_ROOTS, max_bytes: int = 64 << 20) -> bytes:
    """Concatenated UTF-8 bytes of the sorted source walk, capped."""
    parts: list[bytes] = []
    total = 0
    for path in iter_files(roots):
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            continue
        parts.append(data)
        parts.append(b"\n\n")
        total += len(data) + 2
        if total >= max_bytes:
            break
    return b"".join(parts)[:max_bytes]


def train_eval_split(corpus: bytes, eval_bytes: int = 1 << 20):
    """Tail of the (sorted) walk is held out — never seen in training."""
    assert len(corpus) > 2 * eval_bytes, "corpus too small for the split"
    return corpus[:-eval_bytes], corpus[-eval_bytes:]
