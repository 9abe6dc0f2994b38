"""Speech I/O glue for voice chat — the sts_utils equivalent (counterpart
of the JAX package's ``tools/speech.py``).

The reference's voicechat mode (``./chat -v``) shells out to whisper.cpp's
``stream`` binary for STT and piper/espeak for TTS, glued with temp files
(llm/application/sts_utils/{listen,speak}, chat.cc:264-273,
LLaMA3Generate.cc:13-17,209-253). This module reproduces that protocol:

- ``listen()``  — run an STT command, read the transcript from its tmpfile;
- ``Speaker``   — sentence-buffered TTS: generated text streams in token by
  token, and each completed sentence is spoken (the reference speaks per
  sentence inside the decode loop, LLaMA3Generate.cc:209-253).

Binaries are discovered on $PATH (or via $TINYCHAT_STT_CMD /
$TINYCHAT_TTS_CMD); everything no-ops with a warning when they're absent,
so the chat CLI's ``--voice`` flag degrades to text.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

SENTENCE_ENDS = (".", "!", "?", "\n", ";")


def _stt_cmd() -> list[str] | None:
    env = os.environ.get("TINYCHAT_STT_CMD")
    if env:
        return env.split()
    for name in ("stream", "whisper-stream"):  # whisper.cpp stream binary
        if shutil.which(name):
            return [name]
    return None


def _tts_cmd() -> list[str] | None:
    env = os.environ.get("TINYCHAT_TTS_CMD")
    if env:
        return env.split()
    if shutil.which("piper"):
        return ["piper"]
    if shutil.which("espeak"):
        return ["espeak"]
    return None


def available() -> dict:
    return {"stt": _stt_cmd() is not None, "tts": _tts_cmd() is not None}


def listen(timeout_s: float = 30.0) -> str:
    """Capture one utterance via the STT binary (sts_utils/listen protocol:
    binary writes the transcript to a file we read back)."""
    cmd = _stt_cmd()
    if cmd is None:
        print("[voice] no STT binary (whisper.cpp `stream`) on PATH — "
              "type instead:", file=sys.stderr)
        return input()
    with tempfile.NamedTemporaryFile(mode="r", suffix=".txt") as f:
        subprocess.run(cmd + ["-f", f.name], timeout=timeout_s, check=False,
                       stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        return f.read().strip()


class Speaker:
    """Sentence-buffered TTS sink for streamed generation."""

    def __init__(self):
        self._cmd = _tts_cmd()
        self._buf: list[str] = []
        if self._cmd is None:
            print("[voice] no TTS binary (piper/espeak) on PATH — "
                  "output is text only", file=sys.stderr)

    def feed(self, piece: str):
        """Feed a decoded token's text; speaks on sentence boundaries."""
        if self._cmd is None:
            return
        self._buf.append(piece)
        if piece.endswith(SENTENCE_ENDS):
            self.flush()

    def flush(self):
        if self._cmd is None or not self._buf:
            return
        sentence = "".join(self._buf).strip()
        self._buf.clear()
        if not sentence:
            return
        try:
            subprocess.run(self._cmd, input=sentence.encode(), check=False,
                           stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                           timeout=60)
        except (OSError, subprocess.SubprocessError):
            self._cmd = None  # binary broke; degrade to text
