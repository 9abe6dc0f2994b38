"""Plain f32 references, one module per family (``<family>.logits``),
loaded by ``spec.reference`` from the run's benchmark directory."""
