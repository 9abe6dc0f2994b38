"""The port's TINYCHAT_* environment-flag registry (core/flags.py): CPU
twins of the four cases of tests/test_flags.py over the port's names.
Every TINYCHAT_* name read in the port's tree, its scripts and
chip_smoke.py is registered; an unregistered one warns, at package import
too; no port file reads a TCE_* name."""

import pathlib
import re
import subprocess
import sys
import warnings

from tinychatengine_tpu_torch.core.flags import KNOWN_FLAGS, warn_unknown_flags

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _port_sources():
    return (sorted((ROOT / "tinychatengine_tpu_torch").rglob("*.py"))
            + [ROOT / "chip_smoke.py", ROOT / "scripts" / "bench_torch.py",
               ROOT / "scripts" / "decode_gap.py"])


def test_registry_covers_every_flag_read_in_the_tree():
    used, legacy = set(), set()
    for f in _port_sources():
        text = f.read_text()
        used |= set(re.findall(r"TINYCHAT_[A-Z_]+", text))
        legacy |= set(re.findall(r"\bTCE_[A-Z_]+", text))
    assert {"TINYCHAT_DECODE_FUSED", "TINYCHAT_DECODE_KOUTER",
            "TINYCHAT_STT_CMD", "TINYCHAT_TTS_CMD"} <= used
    missing = used - set(KNOWN_FLAGS)
    assert not missing, f"flags read but not registered: {sorted(missing)}"
    assert not legacy, f"the port reads TCE_* names: {sorted(legacy)}"
    assert all(k.startswith("TINYCHAT_") for k in KNOWN_FLAGS)


def test_unknown_flag_warns():
    env = {"TINYCHAT_DECODE_FUSEDD": "1", "TINYCHAT_DECODE_FUSED": "1",
           "TCE_NO_CTXCAP": "1", "PATH": "/bin"}
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        bad = warn_unknown_flags(env)
    assert bad == ["TINYCHAT_DECODE_FUSEDD"]
    assert any("TINYCHAT_DECODE_FUSEDD" in str(w.message) for w in rec)


def test_known_flags_do_not_warn():
    env = {k: "1" for k in KNOWN_FLAGS}
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        bad = warn_unknown_flags(env)
    assert bad == [] and not rec


def test_import_time_warning_fires():
    """The guard runs at package import: a subprocess with a typo'd flag
    prints the RuntimeWarning."""
    r = subprocess.run(
        [sys.executable, "-W", "always::RuntimeWarning", "-c",
         "import tinychatengine_tpu_torch"],
        capture_output=True, text=True, timeout=120,
        env={"TINYCHAT_TYPO_FLAG": "1", "PATH": "/usr/bin:/bin",
             "PYTHONPATH": str(ROOT)},
    )
    assert r.returncode == 0, r.stderr
    assert "TINYCHAT_TYPO_FLAG" in r.stderr
