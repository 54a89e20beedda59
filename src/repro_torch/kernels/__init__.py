"""Direct-access kernels (CUDA sources in csrc/) and their plain versions."""
