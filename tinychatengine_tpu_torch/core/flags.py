"""The TINYCHAT_* environment-flag registry — the port's whole switch
surface, in one place (counterpart of the JAX package's ``core/flags.py``,
whose flags are named TCE_*).

Every recognized flag is declared HERE, and ``warn_unknown_flags()`` (run
once at package import) warns about any TINYCHAT_* variable in the
environment that is not registered: a mistyped switch must be loud, not
silently inert.

Readers still consume os.environ directly at their use sites (some are
read at import time, some per call); this module is the registry and the
typo guard, not an indirection layer.
"""

from __future__ import annotations

import os
import warnings

PREFIX = "TINYCHAT_"

# name -> (default, one-line effect, when to touch)
KNOWN_FLAGS: dict[str, tuple[str, str, str]] = {
    "TINYCHAT_DECODE_FUSED": (
        "0",
        "read at import by ops/int4_matmul.py: '1' sets FUSED_DECODE, the "
        "fused norm-prologue / RoPE-bias-residual int4 decode "
        "(int4_matmul_fused) in llama.forward and gptbigcode.forward",
        "A/B runs of the fused W4A16 decode; off by default, as in JAX",
    ),
    "TINYCHAT_DECODE_KOUTER": (
        "(empty)",
        "read at import by ops/int4_matmul.py: fills DECODE_KOUTER, the "
        "shapes routed to the K-outer int4 kernel: 'K,N:bn,bk;...'",
        "A/B runs of the K-outer route; empty by default, as in JAX",
    ),
    "TINYCHAT_NO_NATIVE": (
        "(empty)",
        "read once, at the first use of native/: any non-empty value turns "
        "off the C++ library (the tokenizers' merges, read_file), so the "
        "pure-Python paths run",
        "A/B runs of the tokenizers' Python merges, or a machine whose g++ "
        "builds a library that misbehaves",
    ),
    "TINYCHAT_STT_CMD": (
        "(empty)",
        "speech-to-text command for voice chat (writes the transcript to "
        "the file after -f) — whisper.cpp-style protocol (tools/speech.py)",
        "configuring voice chat (chat.py -v)",
    ),
    "TINYCHAT_TTS_CMD": (
        "(empty)",
        "text-to-speech command for voice chat (text on stdin) — "
        "piper-style protocol (tools/speech.py)",
        "configuring voice chat (chat.py -v)",
    ),
}


def warn_unknown_flags(environ=None) -> list[str]:
    """Warn (via warnings) about unrecognized TINYCHAT_* environment
    variables; returns the offending names."""
    env = os.environ if environ is None else environ
    unknown = sorted(k for k in env if k.startswith(PREFIX)
                     and k not in KNOWN_FLAGS)
    for name in unknown:
        warnings.warn(
            f"unrecognized environment flag {name!r} — known {PREFIX}* "
            f"flags: {', '.join(sorted(KNOWN_FLAGS))} (see README "
            f"'Environment flags'); a typo here silently disables the "
            f"intended switch", RuntimeWarning, stacklevel=2)
    return unknown
