"""Hand-written CUDA kernels for Hopper (sources in `../csrc`), their
wrappers, and their plain PyTorch versions."""
