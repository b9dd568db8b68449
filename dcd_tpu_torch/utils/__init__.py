"""Kernel build and weight carry."""
