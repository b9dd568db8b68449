"""Geometry, NMS and the deformable conv (plain versions and the CUDA kernel wrapper)."""
