"""Detector modules: DLA-34 backbone with deformable decoder, heads."""
