"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), their plain
PyTorch versions, the oracles and the dispatching ops."""
