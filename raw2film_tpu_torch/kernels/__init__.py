"""Build and bind the hand-written CUDA kernels of ``csrc/``."""
