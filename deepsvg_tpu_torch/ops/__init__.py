"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``embedding`` (K1), ``layer`` (K2) and ``head`` (K3). A wrapper
takes the plain version for CPU tensors and launches its kernel for CUDA
tensors; the kernels are built by ``_build`` at first use."""
