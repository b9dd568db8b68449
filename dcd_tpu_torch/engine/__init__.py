"""Inference entry points and post-processing."""
