"""Geometry, NMS, the deformable conv and the decoder's upsampling (plain versions and
the CUDA kernel wrappers)."""
