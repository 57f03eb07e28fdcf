"""Intersection and the hand-written kernels behind it."""
