"""Float32 master parameters, cast at use.

Every ``nn.Parameter`` of the port is float32, as in flax; ``compute_dtype``
is applied where a weight is used. When training (``deterministic=False``)
the cast is part of the graph, so the gradient reaches the float32 leaf. At
inference the cast copy is made once and reused until the parameter changes
(an in-place update or a weight load bumps its version; ``.to(device)`` moves
its storage), so a forward launches no cast kernels.
"""
from __future__ import annotations

import torch
from torch import nn


def cast_at_use(module: nn.Module, name: str, param: torch.Tensor, dtype, store=None,
                deterministic: bool = True) -> torch.Tensor:
    """``param`` rounded to ``dtype`` and held in ``store`` (default
    ``dtype``): float32 activations take bfloat16-rounded weights as float32."""
    store = store or dtype
    if param.dtype == dtype == store:
        return param
    if not deterministic:
        return param.to(dtype).to(store)
    cache = module.__dict__.setdefault("_cast_cache", {})
    key = (name, dtype, store)
    stamp = (param._version, param.data_ptr(), param.device)
    hit = cache.get(key)
    if hit is None or hit[0] != stamp:
        with torch.no_grad():
            hit = (stamp, param.detach().to(dtype).to(store).contiguous())
        cache[key] = hit
    return hit[1]


class DropoutRng:
    """The randomness of one training step, drawn from one explicit
    ``torch.Generator`` on the host: an int32 seed for each kernel call (the
    kernels hash it with the element's coordinates, ``ops/dropout.py``; no
    device synchronisation), and the masks of the dropout sites outside the
    kernels, from a generator on the tensors' device that is seeded from the
    host generator at first use."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self._device_generators: dict = {}

    def seed(self) -> int:
        return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self.generator))

    def dropout(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if rate <= 0.0:
            return x
        gen = self._device_generators.get(x.device)
        if gen is None:
            gen = torch.Generator(device=x.device)
            gen.manual_seed(self.seed())
            self._device_generators[x.device] = gen
        keep = torch.rand(x.shape, device=x.device, generator=gen) >= rate
        return x * (keep.to(x.dtype) * (1.0 / (1.0 - rate)))


class Linear(nn.Linear):
    """``nn.Linear`` with float32 masters that computes in ``compute_dtype``
    (flax ``nn.Dense(dtype=...)``: input and parameters cast, output in it)."""

    def __init__(self, in_features: int, out_features: int, compute_dtype=torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype

    def forward(self, x, deterministic: bool = True):
        dt = self.compute_dtype
        return nn.functional.linear(
            x.to(dt), cast_at_use(self, "weight", self.weight, dt, deterministic=deterministic),
            cast_at_use(self, "bias", self.bias, dt, deterministic=deterministic))
