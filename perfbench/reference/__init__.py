"""Plain f32 references, one module per family (``<family>.logits``)."""

from __future__ import annotations

import importlib


def family(name: str):
    """The reference module of a model family."""
    return importlib.import_module(f"perfbench.reference.{name}")
