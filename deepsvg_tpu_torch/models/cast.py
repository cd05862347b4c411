"""Float32 master parameters, cast at use.

Every ``nn.Parameter`` of the port is float32, as in flax; ``compute_dtype``
is applied where a weight is used. When training (``deterministic=False``)
the cast is part of the graph, so the gradient reaches the float32 leaf. At
inference the cast copy is made once and reused until the parameter changes
(an in-place update or a weight load bumps its version; ``.to(device)`` moves
its storage), so a forward launches no cast kernels. Under ``torch.export``
the cached copy is a constant of the exported program (``serving.py`` runs
the function once before it traces it); a copy made while tracing is an
operation of the graph and is not kept.
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
        if torch.compiler.is_compiling():
            return hit[1]
        cache[key] = hit
    return hit[1]


class DropoutRng:
    """The randomness of one training step, drawn from one explicit
    ``torch.Generator`` on the host: an int32 seed for each kernel call (the
    kernels hash it with the element's coordinates, ``ops/dropout.py``; no
    device synchronisation), and the masks of the dropout sites outside the
    kernels and the VAE's noise, from a generator on the tensors' device that
    is seeded from the host generator at first use."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self._device_generators: dict = {}

    @classmethod
    def fixed(cls, seed: int = 0) -> "DropoutRng":
        """A generator with a fixed seed: the VAE's noise at evaluation and
        sampling, as the JAX package's ``key(0)`` there."""
        return cls(torch.Generator().manual_seed(seed))

    def seed(self) -> int:
        return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self.generator))

    def _device_generator(self, device) -> torch.Generator:
        gen = self._device_generators.get(device)
        if gen is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(self.seed())
            self._device_generators[device] = gen
        return gen

    def dropout(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if rate <= 0.0:
            return x
        keep = torch.rand(x.shape, device=x.device,
                          generator=self._device_generator(x.device)) >= rate
        return x * (keep.to(x.dtype) * (1.0 / (1.0 - rate)))

    def normal(self, shape, dtype, device) -> torch.Tensor:
        """Standard normal noise of ``shape``, drawn in float32 and rounded
        to ``dtype``."""
        return torch.randn(shape, device=device,
                           generator=self._device_generator(device)).to(dtype)


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
