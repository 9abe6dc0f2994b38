"""Native (C++) host components, loaded with ctypes (counterpart of the JAX
package's ``native/``, whose C++ sources ``src/bpe.cc`` and
``src/loader.cc`` are copied here).

``src/*.cc`` is built at first use with the toolchain's ``g++`` into one
shared library under ``build/tce_native/`` at the root of the checkout
(listed in ``.gitignore``), named by a hash of the sources and flags, and
loaded with ctypes (a plain C ABI). ``TINYCHAT_NO_NATIVE`` set to anything
non-empty turns it off. Everything here degrades gracefully: without g++
or the library, ``available()`` is False and callers take the pure-Python
paths (the tokenizers' merge loops, ``np.fromfile``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tce_native"
GXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _target() -> Path:
    h = hashlib.sha256()
    for src in sorted(_SRC.glob("*.cc")):
        h.update(src.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libtce_native-{h.hexdigest()[:16]}.so"


def _build_library() -> Path | None:
    so = _target()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp),
           *map(str, sorted(_SRC.glob("*.cc")))]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, so)  # atomic: concurrent builders never see half a file
    return so


def load_library():
    """The shared library, building it on first use. None if unavailable
    or turned off by ``TINYCHAT_NO_NATIVE``."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("TINYCHAT_NO_NATIVE"):
            return None
        so = _build_library()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        lib.tce_merger_create.restype = ctypes.c_void_p
        lib.tce_merger_create.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        lib.tce_merger_encode.restype = ctypes.c_int
        lib.tce_merger_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int]
        lib.tce_merger_destroy.argtypes = [ctypes.c_void_p]
        lib.tce_spm_create.restype = ctypes.c_void_p
        lib.tce_spm_create.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int32, ctypes.c_int32]
        lib.tce_spm_encode.restype = ctypes.c_int
        lib.tce_spm_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int]
        lib.tce_spm_destroy.argtypes = [ctypes.c_void_p]
        lib.tce_file_size.restype = ctypes.c_int64
        lib.tce_file_size.argtypes = [ctypes.c_char_p]
        lib.tce_read_file.restype = ctypes.c_int64
        lib.tce_read_file.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int]
        _LIB = lib
        return _LIB


RANK = 0    # GPT-2: lowest-rank pair type, all occurrences, repeat
SCORE = 1   # sentencepiece/llama.cpp: best-score bigram agenda


class NativeMerger:
    """C++ BPE merge loop over int32 symbol ids.

    Rules: (left_id, right_id) -> (merged_id, priority). mode=RANK uses
    priority = -rank; mode=SCORE uses the merged token's vocab score.
    """

    def __init__(self, lefts, rights, merged, priority, mode: int):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        lefts = np.ascontiguousarray(lefts, np.int32)
        rights = np.ascontiguousarray(rights, np.int32)
        merged = np.ascontiguousarray(merged, np.int32)
        priority = np.ascontiguousarray(priority, np.float32)
        self._handle = lib.tce_merger_create(
            lefts.ctypes.data, rights.ctypes.data, merged.ctypes.data,
            priority.ctypes.data, len(lefts), mode)

    def encode(self, ids) -> list[int]:
        arr = np.ascontiguousarray(ids, np.int32)
        if arr.size == 0:
            return []
        out = np.empty(arr.size, np.int32)
        n = self._lib.tce_merger_encode(
            self._handle, arr.ctypes.data, arr.size, out.ctypes.data, out.size)
        assert n >= 0, "output overflow (cannot happen: merges only shrink)"
        return out[:n].tolist()

    def __del__(self):
        lib = getattr(self, "_lib", None)
        h = getattr(self, "_handle", None)
        if lib is not None and h:
            lib.tce_merger_destroy(h)


class NativeSPM:
    """C++ sentencepiece-style encoder: whole-text best-score span merges
    (LLaMATokenizer.cc semantics). tokens: list[bytes]; scores per token."""

    def __init__(self, tokens, scores, byte_fallback_base: int = -1,
                 unk_id: int = 0):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        blob = b"".join(tokens)
        lens = np.asarray([len(t) for t in tokens], np.int32)
        scores = np.ascontiguousarray(scores, np.float32)
        blob_arr = np.frombuffer(blob, np.uint8) if blob else np.empty(0, np.uint8)
        blob_arr = np.ascontiguousarray(blob_arr)
        self._handle = lib.tce_spm_create(
            blob_arr.ctypes.data, lens.ctypes.data, scores.ctypes.data,
            len(tokens), byte_fallback_base, unk_id)

    def encode(self, text_bytes: bytes) -> list[int]:
        if not text_bytes:
            return []
        out = np.empty(len(text_bytes) + 8, np.int32)
        n = self._lib.tce_spm_encode(
            self._handle, text_bytes, len(text_bytes), out.ctypes.data,
            out.size)
        assert n >= 0
        return out[:n].tolist()

    def __del__(self):
        lib = getattr(self, "_lib", None)
        h = getattr(self, "_handle", None)
        if lib is not None and h:
            lib.tce_spm_destroy(h)


def available() -> bool:
    return load_library() is not None


def read_file(path: str, dtype, count: int = -1, offset: int = 0,
              n_threads: int = 8) -> np.ndarray:
    """Parallel-pread a raw binary tensor file (the reference's
    read_to_array, llm/src/utils.cc). Falls back to np.fromfile."""
    lib = load_library()
    dtype = np.dtype(dtype)
    if lib is None:
        return np.fromfile(path, dtype=dtype, count=count, offset=offset)
    size = lib.tce_file_size(path.encode())
    if size < 0:
        raise FileNotFoundError(path)
    nbytes = size - offset if count < 0 else count * dtype.itemsize
    out = np.empty(nbytes // dtype.itemsize, dtype)
    got = lib.tce_read_file(path.encode(), out.ctypes.data, offset,
                            out.nbytes, n_threads)
    if got != out.nbytes:
        raise IOError(f"short read {got} != {out.nbytes} from {path}")
    return out
