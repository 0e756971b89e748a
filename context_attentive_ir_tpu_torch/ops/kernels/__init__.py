"""Hand-written CUDA kernels (``csrc/``), each beside its plain PyTorch
version and with a launch count on its wrapper."""
