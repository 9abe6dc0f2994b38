"""The share of the expert weights a decode tick reads: over the window's
decode ticks, the (layer, expert) weight sets read (``serve.experts`` a)
over ticks x the model's weight sets (``serve.engine`` b: layers x
experts), in %."""

from perfbench import spans


def read(rec):
    sp = spans.load(rec)
    if sp is None:
        return None
    engines = [s for s in sp if s.name == "serve.engine"
               and s.start <= round(rec.t_open * 1e9)]
    sets = engines[-1].b if engines else 0
    ticks = sum(s.a for s in spans.window(rec, sp, "serve.decode"))
    read_ = sum(s.a for s in spans.window(rec, sp, "serve.experts"))
    if not sets or not ticks or not read_:
        return None
    return 100.0 * read_ / (ticks * sets)
