"""Hand-written CUDA kernels (``csrc/``), their plain versions and the
dispatch layer."""
