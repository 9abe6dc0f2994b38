"""What the benchmark may load: nothing whose top-level module name is
``jax``, ``jaxlib``, ``flax`` or ``tinychatengine_tpu`` anywhere, and
nothing of the port in the reference's side (weights, reference, compare).
Names are compared whole: ``tinychatengine_tpu_torch`` is the port, not
the JAX package."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import run

BENCH_DIR = Path(__file__).resolve().parent.parent
REPO = BENCH_DIR.parent
PORT = "tinychatengine_tpu_torch"


def _top_level_imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({n.split('.')[0] for n in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_forbidden_names_are_whole_names():
    assert "tinychatengine_tpu_torch" not in run.FORBIDDEN
    assert {"jax", "jaxlib", "flax", "tinychatengine_tpu"} == set(run.FORBIDDEN)


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH_DIR) for p in
                                        BENCH_DIR.rglob("*.py")),
                         ids=str)
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not _top_level_imports(BENCH_DIR / path) & set(run.FORBIDDEN)


def test_the_reference_side_loads_nothing_of_the_port():
    loaded = _loaded("import perfbench.compare, perfbench.weights, "
                     "perfbench.reference.llama, "
                     "perfbench.reference.gptbigcode, perfbench.work, "
                     "perfbench.traffic, perfbench.model")
    assert PORT not in loaded
    assert not loaded & set(run.FORBIDDEN)


FAMILIES = sorted(p.stem for p in (BENCH_DIR / "families").glob("*.py"))


def _module_level_imports(path: Path) -> set:
    """Top-level names imported outside every function and class."""
    names = set()
    todo = list(ast.parse(path.read_text()).body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        else:
            todo.extend(ast.iter_child_nodes(node))
    return names


@pytest.mark.parametrize("family", FAMILIES)
def test_a_family_imports_the_port_only_inside_functions(family):
    path = BENCH_DIR / "families" / f"{family}.py"
    assert PORT not in _module_level_imports(path)
    assert not _top_level_imports(path) & set(run.FORBIDDEN)


@pytest.mark.parametrize("family", FAMILIES)
def test_a_familys_sizes_weights_and_work_load_nothing_of_the_port(family):
    """Each configuration of the family sized, its weights' shapes and one
    decode and one prefill call counted, its reference loaded: the port
    stays unloaded."""
    loaded = _loaded(
        "import json\n"
        "from perfbench import spec, work\n"
        "from perfbench.model import model_from_config\n"
        "from perfbench.weights import Weights\n"
        "n = 0\n"
        "for p in sorted((spec.HERE / 'configs').glob('*.json')):\n"
        "    c = json.loads(p.read_text())\n"
        f"    if c['family'] != {family!r}:\n"
        "        continue\n"
        "    m = model_from_config(p.stem, c)\n"
        "    w = Weights(m, 1, 'cpu')\n"
        "    assert all(w.model.shape(x[0]) for x in m.linears())\n"
        "    work.decode_call(m, [7, 9], spec.peaks(), 2)\n"
        "    work.prefill_call(m, [(0, 40)], 1, spec.peaks(), 64)\n"
        f"    spec.reference({family!r})\n"
        "    n += 1\n"
        "assert n\n")
    assert PORT not in loaded
    assert not loaded & set(run.FORBIDDEN)


def test_an_unknown_family_names_the_file_it_looked_for():
    from perfbench import spec
    from perfbench.model import model_from_config
    c = dict(spec.config("mistral_7b-w4a8"), family="no_such_family")
    with pytest.raises(ValueError, match=r"families/no_such_family\.py"):
        model_from_config("x", c)
    with pytest.raises(ValueError, match=r"reference/no_such_family\.py"):
        spec.reference("no_such_family")


@pytest.mark.parametrize("cell", ["tiny_llama.chat",
                                  "tiny_starcoder.complete"])
def test_a_whole_rehearsal_loads_no_jax(tiny, cell):
    """A run in a process of its own (pytest's plugins may load JAX in
    this one): the port is loaded, JAX and its package are not, and the
    run's own check agrees."""
    repo, root = tiny
    loaded = _loaded(
        "import time\n"
        "from pathlib import Path\n"
        "from perfbench import run, spec\n"
        f"bench = spec.benchmark(Path({str(repo)!r}))\n"
        f"run.execute(bench, spec.workload(bench, {cell!r}), 5, 1.0, False,"
        f" 'cpu', time.perf_counter(), root=Path({str(root)!r}))\n"
        "assert run.forbidden_modules() == []\n")
    assert PORT in loaded
    assert not loaded & set(run.FORBIDDEN)


def test_the_command_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "mistral_7b-w4a8.solo", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode == 2 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr
