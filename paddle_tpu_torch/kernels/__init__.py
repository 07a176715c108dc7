"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version. Nothing here builds or loads at import: a kernel's
shared library is compiled on its first launch on a CUDA tensor."""
