"""PyTorch/CUDA port of the SmoothQuant+ reproduction (``src/repro`` is the
JAX reference).  The package mirrors the reference layout (``configs/``,
``core/``, ``kernels/``, ``models/``, ``serving/``, ``launch/``) and never
imports ``jax`` or ``repro``.  Its hand-written Hopper kernels live in
``csrc/`` and are built with ``nvcc`` at first use (``kernels/_build.py``).
"""
