"""Hand-written CUDA kernels (``csrc/``): Python wrappers, plain versions.

Each wrapper takes the plain PyTorch version for tensors on the CPU and
launches its kernel (or raises) for tensors on a CUDA device; each keeps a
launch counter, ``LAUNCHES``, that grows by one per kernel launch.
"""
