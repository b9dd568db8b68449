"""The plain reference of the benchmark: a frozen copy of the DGDE detector,
its clamped deformable convolution, the postprocess, the loss and the
optimizer chain, in plain PyTorch.

It imports nothing of the program under test (``dcd_tpu_torch``), nothing of
the JAX package and no JAX: it reads the configuration file's numbers and
works every weight and target out again from the inputs that the harness
hands to both sides. ``tests/test_pb_imports.py`` holds it to that.
"""
