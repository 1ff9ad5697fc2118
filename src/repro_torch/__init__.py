"""PyTorch/CUDA port of the GraphX reproduction (the JAX package `repro` is
the reference).  Kernels are hand-written CUDA C++ under `csrc/`, built
with nvcc at first use; entry points run on the card unless the caller
passes device="cpu"."""
