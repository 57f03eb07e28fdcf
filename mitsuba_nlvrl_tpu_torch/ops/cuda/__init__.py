"""Hopper kernels bound with ctypes, each beside its plain version."""
