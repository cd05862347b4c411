"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``embedding`` (K1 and its backward K6), ``layer`` (K2, in a short
and a long form), ``head`` (K3), ``layer_vjp`` (K4, in a short and a long
form, each in the saved and the recompute mode), ``ce`` (K5, K8), ``stack_vjp`` (K7), ``decode`` (K9), ``attention``
(K10, the attention block alone: the JAX package's public ``fused_mha``) and
``attention_vjp`` (K11, its differentiable form with dropout:
``fused_mha_train``). Every kernel takes bfloat16 or float32 operands (all of
one type): the float32 forms multiply in TF32 with float32 sums, K1 sums
exactly, K6 takes either type of ``dy``. A wrapper takes the plain version
for CPU tensors and launches its kernel for CUDA tensors; the kernels are
built by ``_build`` at first use. The inference kernels (K1, K2's three
forms, K3, K9) are ``torch.library`` operators (``deepsvg::embedding``,
``layer``, ``layer_f32``, ``layer_long``, ``head_argmax``, ``decode_step``):
``torch.export`` keeps them as calls in its graphs (``serving.py``), and a
call through an exported program counts its launches as a direct one does."""
