"""PyTorch/CUDA port of dcd_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout (``config``, ``data``, ``ops``, ``models``,
``engine``, ``utils``, and ``csrc`` for the CUDA sources) and imports
nothing of it. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
