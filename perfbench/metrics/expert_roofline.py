"""Bound of the expert matmuls' work in the profiled slice over the device
time of their kernels (kernel_classes/expert*), in %. The work is counted
from the port's own expert counts filed during the traced calls (the
``serve.experts`` and ``serve.experts.prefill`` spans: the (layer, expert)
weight sets read and the routed pairs), at the widths of the run's
configuration. A record names no configuration, so it is found by what
the run filed: among the files of ``configs/``, those whose family counts
expert work (``expert_sets``, ``expert_bound``) and whose weight sets equal
the serving engine's (``serve.engine`` b, layers x experts); they must all
give one bound, else the metric reads None."""

from pathlib import Path

from perfbench import spans, spec
from perfbench.model import model_from_config

ROOT = Path(__file__).resolve().parent.parent
NAMES = ("serve.experts", "serve.experts.prefill")


def _bounds(sets: int) -> list:
    """``expert_bound`` of each configuration with ``sets`` weight sets,
    bound to its sizes."""
    out = []
    for path in sorted((ROOT / "configs").glob("*.json")):
        c = spec.config(path.stem, ROOT)
        fam = spec.family(c["family"], ROOT)
        if not hasattr(fam, "expert_bound"):
            continue
        m = model_from_config(path.stem, c, ROOT)
        if fam.expert_sets(m) == sets:
            out.append(lambda a, b, fam=fam, m=m: fam.expert_bound(
                m, a, b, spec.peaks(ROOT)))
    return out


def read(rec):
    t = rec.trace
    if t is None or not t.class_s.get("expert") or not rec.traced_calls:
        return None
    sp = spans.load(rec)
    if sp is None:
        return None
    engines = [s for s in sp if s.name == "serve.engine"]
    if not engines or not engines[-1].b:
        return None
    calls = [(round(c.t0 * 1e9), round(c.t1 * 1e9))
             for c in rec.traced_calls]
    counted = [(s.a, s.b) for s in sp if s.name in NAMES
               and any(a <= s.start <= b for a, b in calls)]
    found = {sum(f(a, b) for a, b in counted)
             for f in _bounds(engines[-1].b)}
    if len(found) != 1:
        return None
    bound = found.pop()
    return 100.0 * bound / t.class_s["expert"] if bound else None
