"""Roofline terms of a step: compute, HBM and collective seconds at the
H100's constants (``analyze``)."""
