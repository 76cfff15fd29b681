"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), their plain
PyTorch versions, the attention oracle and the dispatching ops."""
