"""The port's CUDA kernels, their plain PyTorch versions and dispatch."""
