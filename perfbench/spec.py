"""Finds the benchmark's parts by name.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; each
is a data file (``configs/<name>.json``, ``traffic/<name>.json``). A
metric, end-to-end or per layer, is read by ``metrics/<name>.py`` (a
function ``read(rec)`` returning a number, or None where it finds nothing
to read). A kernel class of the rooflines is every
``kernel_classes/<class>.json`` and ``kernel_classes/<class>.<kernel>.json``
(each a list of regular expressions matched against the profiler's kernel
names), so a later kernel joins a class through a file of its own. The
limits of a cell's comparison are ``limits/<cell>.json``. ``peaks.json``
holds the card's published rates. A model family is two modules found by
the configuration's ``family``: ``families/<family>.py`` (its sizes, the
tensors its weights are made as, its work counts and the port's build of
it) and ``reference/<family>.py`` (its plain reference), each loaded from
the run's root.
"""

from __future__ import annotations

import functools
import hashlib
import importlib.util
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(repo: Path = REPO) -> dict:
    return _json(repo / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(name: str, root: Path = HERE) -> dict:
    return _json(root / "configs" / f"{name}.json")


def traffic(name: str, root: Path = HERE) -> dict:
    return _json(root / "traffic" / f"{name}.json")


def limits(cell: str, root: Path = HERE) -> dict:
    return _json(root / "limits" / f"{cell}.json")


def peaks(root: Path = HERE) -> dict:
    return _json(root / "peaks.json")


def kernel_classes(root: Path = HERE) -> dict:
    """class -> compiled patterns, from every file of the class."""
    out: dict[str, list] = {}
    for path in sorted((root / "kernel_classes").glob("*.json")):
        cls = path.name.split(".", 1)[0]
        out.setdefault(cls, []).extend(
            re.compile(p) for p in _json(path)["patterns"])
    return out


def _load(name: str, path: Path):
    """The module at ``path``, registered in ``sys.modules`` as ``name``
    (a dataclass looks its module up there)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


def reader(metric: str, root: Path = HERE):
    """``read`` of ``metrics/<metric>.py``, else of the reader named by
    the metric's name before its first dot."""
    path = root / "metrics" / f"{metric}.py"
    if not path.exists():
        path = root / "metrics" / f"{metric.split('.', 1)[0]}.py"
    return _load("perfbench_metric_" + re.sub(r"\W", "_", metric), path).read


@functools.cache
def _family_part(part: str, name: str, root: Path):
    """Named after its path, so two roots' modules of a family stay
    apart."""
    path = Path(root).resolve() / part / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no model family {name!r}: {path} does not exist")
    key = hashlib.blake2b(str(path).encode(), digest_size=6).hexdigest()
    return _load(f"perfbench_{part}_{name}_{key}", path)


def family(name: str, root: Path = HERE):
    """The module ``families/<name>.py`` under ``root``, loaded once a
    process."""
    return _family_part("families", name, root)


def reference(name: str, root: Path = HERE):
    """The plain reference ``reference/<name>.py`` under ``root``, loaded
    once a process."""
    return _family_part("reference", name, root)


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end ones without
    tracing, its per-layer ones with (an entry without ``workloads``
    belongs to every cell)."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]
