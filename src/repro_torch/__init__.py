"""PyTorch/CUDA port of the SpecOffload serving system (``repro``).

Imports ``torch`` and ``numpy`` only: nothing of JAX and nothing of the
JAX package, whose module names it keeps so each counterpart is easy to
find.  Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; on CUDA tensors every kernel of the serving path is a
hand-written Hopper kernel (``csrc/``), on CPU tensors its plain PyTorch
version (``kernels/ref.py``).
"""
