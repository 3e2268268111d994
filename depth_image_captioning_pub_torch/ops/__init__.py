"""Functional compute primitives on tensors, and the CUDA kernel wrappers."""
