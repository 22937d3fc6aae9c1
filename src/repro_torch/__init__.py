"""FT K-means on an NVIDIA H100: the PyTorch + CUDA port of ``repro``.

Same layout as the reference package (``hw``, ``kernels``, ``core``,
``api``, ``batch``, ``data``, ``dist``, and the LM stack's ``configs``,
``ft``, ``models``, ``serve``, ``launch``); hand-written CUDA kernels for
Hopper under ``csrc/``, each with a plain PyTorch version that CPU tensors
run.
"""
