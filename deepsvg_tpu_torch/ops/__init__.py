"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``embedding`` (K1 and its backward K6), ``layer`` (K2, in a short
and a long form), ``head`` (K3), ``layer_vjp`` (K4), ``ce`` (K5, K8),
``stack_vjp`` (K7) and ``decode`` (K9). A wrapper takes the plain version
for CPU tensors and launches its kernel for CUDA tensors; the kernels are
built by ``_build`` at first use."""
