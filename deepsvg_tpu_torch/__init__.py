"""deepsvg_tpu_torch — the PyTorch/CUDA port of ``deepsvg_tpu`` for NVIDIA Hopper.

The package mirrors the JAX package's layout so each module has an obvious
counterpart:

- ``deepsvg_tpu_torch.svgtensor`` — constants, masks and host-side packing;
- ``deepsvg_tpu_torch.data``      — the synthetic icon generator;
- ``deepsvg_tpu_torch.models``    — config, flax-checkpoint reader, weight
  bridge, the SVG Transformer modules, the loss and matching, and greedy
  sampling (one-shot, and the autoregressive decode with its KV caches);
- ``deepsvg_tpu_torch.training``  — the training step, optimizer, runtime
  and CLI;
- ``deepsvg_tpu_torch.ops``       — hand-written CUDA kernels (embedding,
  fused transformer layer, head+argmax, the training kernels, the
  autoregressive decode step), each with its plain PyTorch twin.

Only ``torch`` and ``numpy`` are imported. Kernels dispatch on the tensor's
device: a CPU tensor takes the plain version, a CUDA tensor launches the
kernel or raises.
"""

__version__ = "0.1.0"
