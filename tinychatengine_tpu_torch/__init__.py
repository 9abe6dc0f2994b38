"""PyTorch/CUDA port of tinychatengine_tpu for one NVIDIA H100.

Same layers as the JAX package (core, quant, ops, models, generation,
tools, utils, tokenizers). The Pallas kernels of the main path are
hand-written CUDA C++ for sm_90a under ``csrc/``, built with ``nvcc`` at
first use (``ops/_build.py``); every kernel has a plain PyTorch version in
the same module, which runs for tensors that lie on the CPU.

Entry points (``Engine``, ``init_random_params``, ``load_checkpoint``)
default to ``device="cuda"`` and raise when no GPU is present.
"""
