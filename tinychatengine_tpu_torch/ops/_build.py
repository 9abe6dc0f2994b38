"""Build the CUDA kernels under ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<source>.cu`` is one shared library with a plain C interface,
compiled at first use for ``sm_90a`` into ``build/tce_torch/`` at the root
of the checkout (listed in ``.gitignore``) under a name keyed by a hash of
its source and flags, and loaded with ``ctypes``. A kernel is named by its
launch counter; the int8-KV attention kernels live in their bf16 kernels'
sources and the GLU kernel in the K-outer kernel's (``SOURCES``).
``build_all`` starts one ``nvcc`` per source at once and waits for all of
them. Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises on a non-zero code. ``LAUNCHES`` counts the launches that
ran on the card; a CUDA graph's capture records what its body added
(``record_launches``) and adds it again at each replay.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tce_torch"
KERNELS = ("int4_matmul", "int4_matmul_a8", "flash_decode", "flash_prefill",
           "flash_decode_paged", "int8_decode", "int4_matmul_fused",
           "flash_decode_int8", "flash_prefill_int8",
           "flash_decode_paged_int8", "int4_matmul_kouter", "int4_matmul_glu",
           "mlp_fused", "int3_matmul")
# kernel -> its source under csrc/ where the two names differ
SOURCES = {"flash_decode_int8": "flash_decode",
           "flash_prefill_int8": "flash_prefill",
           "flash_decode_paged_int8": "flash_decode_paged",
           "int4_matmul_glu": "int4_matmul_kouter"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict[tuple[str, str], ctypes._CFuncPtr] = {}
BUILD_LOG: dict[str, str] = {}  # source -> nvcc's output (ptxas register use)

# launches per kernel: each wrapper adds one where it launches its kernel
LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)
# the counters a captured CUDA graph adds to at every replay: LAUNCHES and
# any that ``counting`` registers (name -> count dicts)
COUNTERS: list[dict] = [LAUNCHES]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def counting(counter: dict):
    """Registers ``counter`` beside LAUNCHES while open, so a graph
    captured meanwhile adds its calls there at every replay."""
    COUNTERS.append(counter)
    try:
        yield counter
    finally:
        COUNTERS.remove(counter)


class LaunchDelta:
    """What one captured body added to each registered counter. The
    capture launched nothing on the card, so ``record_launches`` takes the
    counts back; ``add`` puts them in again at each replay, and the
    counters keep meaning calls that ran on the card."""

    def __init__(self):
        self.deltas: list[tuple[dict, dict]] = []

    def add(self) -> None:
        for counter, delta in self.deltas:
            for name, n in delta.items():
                counter[name] = counter.get(name, 0) + n


@contextlib.contextmanager
def record_launches():
    """Around a capture: yields a ``LaunchDelta`` that holds, on exit, what
    the body added to every registered counter, and restores the counters
    to their values on entry (also when the body raises)."""
    before = [(c, dict(c)) for c in COUNTERS]
    delta = LaunchDelta()
    try:
        yield delta
    finally:
        for counter, snap in before:
            d = {k: v - snap.get(k, 0) for k, v in counter.items()
                 if v != snap.get(k, 0)}
            if d:
                delta.deltas.append((counter, d))
            counter.clear()
            counter.update(snap)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return found


def source(name: str) -> str:
    """The ``csrc/<source>.cu`` that holds kernel ``name``."""
    return SOURCES.get(name, name)


def _target(src: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{src}.cu").read_bytes())
    for common in sorted(CSRC.glob("*.cuh")):
        h.update(common.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src}-{h.hexdigest()[:16]}.so"


def build_all(names=KERNELS) -> dict[str, Path]:
    """Compile the source of every named kernel that is not built yet, one
    ``nvcc`` process per source, all started together. Returns source ->
    library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {s: _target(s) for s in dict.fromkeys(map(source, names))}
    procs = {}
    for n, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True),
                    tmp, out)
    errors = []
    for n, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        BUILD_LOG[n] = stdout + stderr
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{stdout}{stderr}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library that holds kernel ``name``, built if needed."""
    src = source(name)
    lib = _LIBS.get(src)
    if lib is None:
        lib = ctypes.CDLL(str(build_all((name,))[src]))
        _LIBS[src] = lib
    return lib


def bind(name: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    """C entry point ``fn`` of kernel ``name`` with its argument types set
    (``c_void_p`` for pointers and the stream, so no pointer is cut)."""
    f = _FNS.get((name, fn))
    if f is None:
        f = getattr(load(name), fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _FNS[(name, fn)] = f
    return f


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")
