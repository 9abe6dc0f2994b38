"""The benchmark of the PyTorch/CUDA port (``tinychatengine_tpu_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line. Everything that belongs to one configuration, model
family, traffic mix, metric, kernel class or cell lives in a file of its
own, found by its name (``spec``): ``configs/<config>.json``,
``families/<family>.py``, ``reference/<family>.py``,
``traffic/<mix>.json``, ``metrics/<metric>.py``,
``kernel_classes/<class>[.<kernel>].json`` and ``limits/<cell>.json``.

Nothing here imports JAX or the JAX package; the plain reference
(``reference/``, ``weights``, ``compare``) and the families' sizes and
work counts import nothing of the port.
"""
