"""Train state and the training and evaluation steps, counterparts of
``deepsvg_tpu/training/trainer.py``.

One step is: batch from its wire format, forward with dropout through the
training kernels, loss, backward, global-norm clip, AdamW, all on the model's
device with no synchronisation with the host (the results come back as
tensors; read them when you need them).

The optimizer follows optax, not ``torch.optim``'s defaults:
``clip_by_global_norm`` scales by ``clip / max(norm, clip)``; AdamW
(``b1=0.9, b2=0.999, eps=1e-8``) decays every leaf, LayerNorm and biases
included, by adding ``weight_decay * p`` to the Adam direction before the
``-lr`` scale; the schedule is read at the count before it is incremented;
:func:`delayed_start` freezes the inner state and gives zero updates until
its start step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch import nn

from ..data.loader import decompress_batch
from ..models.cast import DropoutRng
from ..models.loss import svg_loss
from ..models.model import SVGTransformer


class Optimizer:
    """Global-norm clip, then AdamW, optionally gated to start at a step.
    ``update`` changes the parameters and the state in place."""

    def __init__(self, lr_schedule: Callable[[int], float], grad_clip: float = 1.0,
                 weight_decay: float = 0.01, start_step: int = 0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr_schedule, self.grad_clip, self.weight_decay = lr_schedule, grad_clip, weight_decay
        self.start_step, self.b1, self.b2, self.eps = start_step, b1, b2, eps

    def init(self, params: list) -> dict:
        return {"mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params],
                "count": 0,        # AdamW steps taken (and the schedule's count)
                "calls": 0}        # calls of update, which the start gate counts

    @torch.no_grad()
    def update(self, params: list, grads: list, state: dict) -> torch.Tensor:
        """One step. Returns the gradients' global norm before clipping."""
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        calls = state["calls"]
        state["calls"] = calls + 1
        if calls < self.start_step:
            return norm
        scale = self.grad_clip / torch.clamp(norm, min=self.grad_clip)
        grads = torch._foreach_mul(grads, scale)
        count = state["count"]
        state["count"] = count + 1
        torch._foreach_mul_(state["mu"], self.b1)
        torch._foreach_add_(state["mu"], grads, alpha=1 - self.b1)
        torch._foreach_mul_(state["nu"], self.b2)
        torch._foreach_addcmul_(state["nu"], grads, grads, value=1 - self.b2)
        c1, c2 = 1 - self.b1 ** (count + 1), 1 - self.b2 ** (count + 1)
        denom = torch._foreach_div(state["nu"], c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        direction = torch._foreach_div(state["mu"], c1)
        torch._foreach_div_(direction, denom)
        torch._foreach_add_(direction, params, alpha=self.weight_decay)
        torch._foreach_add_(params, direction, alpha=-float(self.lr_schedule(count)))
        return norm


class MultiOptimizer:
    """One :class:`Optimizer` per label, each over the parameters that
    ``labels`` (name -> label) gives it, with its own clip, schedule and start
    step: the multi-optimizer list of the reference trainer."""

    def __init__(self, members: dict, labels: dict | Callable):
        self.members, self.labels = members, labels

    def bind(self, names: list) -> None:
        labels = self.labels(names) if callable(self.labels) else self.labels
        self.index = {label: [i for i, n in enumerate(names) if labels[n] == label]
                      for label in self.members}

    def init(self, params: list) -> dict:
        return {label: opt.init([params[i] for i in self.index[label]])
                for label, opt in self.members.items()}

    def update(self, params: list, grads: list, state: dict) -> torch.Tensor:
        norms = [opt.update([params[i] for i in self.index[label]],
                            [grads[i] for i in self.index[label]], state[label])
                 for label, opt in self.members.items()]
        return torch.linalg.vector_norm(torch.stack(norms))


def make_optimizer(lr_schedule: Callable[[int], float], grad_clip: float = 1.0,
                   weight_decay: float = 0.01, start_step: int = 0) -> Optimizer:
    """AdamW with global-norm clipping; ``start_step`` gates it as
    :func:`delayed_start` does."""
    return Optimizer(lr_schedule, grad_clip, weight_decay, start_step)


def delayed_start(opt: Optimizer, start_step: int) -> Optimizer:
    """``opt`` gated to begin at ``start_step``: until then the parameters do
    not move and the moments and the schedule's count stay frozen."""
    return Optimizer(opt.lr_schedule, opt.grad_clip, opt.weight_decay, start_step,
                     opt.b1, opt.b2, opt.eps)


def make_optimizers(members: dict, param_labels: dict | Callable) -> MultiOptimizer:
    """``members[label]`` is an :class:`Optimizer` or the keyword arguments of
    :func:`make_optimizer`; ``param_labels`` maps each parameter name to its
    label (a dict, or a function of the list of names)."""
    return MultiOptimizer({label: make_optimizer(**spec) if isinstance(spec, dict) else spec
                           for label, spec in members.items()}, param_labels)


@dataclasses.dataclass
class TrainState:
    """The model (its float32 parameters), the optimizer state, the step
    count and the one generator that all of a step's randomness comes from."""

    model: SVGTransformer
    opt_state: dict
    step: int
    generator: torch.Generator

    def parameters(self) -> list:
        return [p for _, p in self.model.named_parameters()]


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Initialise as the flax modules do: LeCun-normal kernels, zero biases,
    unit LayerNorm scales, embedding tables and the argument-embedding
    projection with fan-in-scaled normals (gain sqrt 2)."""
    normal = lambda p, std: p.copy_(torch.randn(p.shape, generator=generator) * std)  # noqa: E731
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("norm1", "norm2"):
            p[0].fill_(1.0)
            p[1].zero_()
        elif "embed" in leaf and p.dim() == 2:                 # lookup tables
            normal(p, math.sqrt(2.0 / p.shape[1]))
        elif name.endswith("embed_fcn.weight"):
            normal(p, math.sqrt(2.0 / p.shape[1]))
        elif ".norm." in name or name.startswith("norm."):
            p.fill_(1.0) if leaf == "weight" else p.zero_()
        elif leaf == "weight":
            normal(p, math.sqrt(1.0 / p.shape[1]))
        else:
            p.zero_()


def create_train_state(model: SVGTransformer, optimizer, seed: int = 42,
                       init: bool = True) -> TrainState:
    """A fresh state: parameters initialised from ``seed`` (unless ``init`` is
    false: the model keeps the weights it has), zero moments, step 0, and the
    step generator seeded with ``seed + 2``."""
    if init:
        init_parameters(model, torch.Generator().manual_seed(seed))
    names = [n for n, _ in model.named_parameters()]
    if isinstance(optimizer, MultiOptimizer):
        optimizer.bind(names)
    state = TrainState(model, {}, 0, torch.Generator().manual_seed(seed + 2))
    state.opt_state = optimizer.init(state.parameters())
    return state


def train_step(state: TrainState, batch: dict, weights: dict, optimizer,
               model_args: list):
    """One training step on ``batch`` (a dict of tensors on the model's
    device, wire or canonical dtypes). Updates ``state`` in place and returns
    it with the loss terms and ``grad_norm`` (before clipping), as tensors."""
    model = state.model
    batch = decompress_batch(batch)
    args = [batch[k] for k in model_args]
    rng = DropoutRng(state.generator) if model.cfg.dropout > 0.0 else None
    params = state.parameters()
    for p in params:
        p.grad = None
    out = model(*args, return_tgt=True, deterministic=False, fused_ce=True, rng=rng)
    res = svg_loss(out, weights, model.cfg)
    res["loss"].backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    res = {k: v.detach() for k, v in res.items()}
    res["grad_norm"] = optimizer.update(params, grads, state.opt_state)
    state.step += 1
    return state, res


def _scalars(results: list) -> dict:
    """K steps' results -> one ``[K]`` tensor per scalar key."""
    return {k: torch.stack([r[k] for r in results]) for k, v in results[0].items()
            if v.dim() == 0}


def train_multi_step(state: TrainState, batches: dict, weights_fn, optimizer,
                     model_args: list):
    """K training steps on a stacked batch dict ``{key: [K, ...]}``, the
    loss weights of each from ``weights_fn(step)`` at the step count before
    it. Counterpart of ``jit_train_multi_step``: a Python loop, no
    synchronisation with the host. Each result is a ``[K]`` tensor."""
    results = []
    for k in range(next(iter(batches.values())).shape[0]):
        state, res = train_step(state, {key: v[k] for key, v in batches.items()},
                                weights_fn(state.step), optimizer, model_args)
        results.append(res)
    return state, _scalars(results)


AUG_SEED = 0xA9


def gather_batch(data: dict, icon_idx: torch.Tensor, step: int, n_augs: int = 1,
                 item_shapes: dict | None = None) -> dict:
    """One step's batch from the resident corpus ``data`` (``{key: [M,
    ...]}``, rows flattened when ``item_shapes`` is given) by its icon
    indices ``[B]``, on the device. With ``n_augs > 1`` each item's
    augmentation variant is drawn uniformly on the device from a generator
    seeded by ``(AUG_SEED, step)``: the draw is a function of the step, as in
    the JAX package, but not its bits."""
    flat = icon_idx.long()
    if n_augs > 1:
        gen = torch.Generator(device=flat.device)
        gen.manual_seed(AUG_SEED * 1_000_003 + step)
        aug = torch.randint(0, n_augs, flat.shape, device=flat.device, generator=gen)
        flat = flat * n_augs + aug
    batch = {k: v.index_select(0, flat) for k, v in data.items()}
    if item_shapes:
        batch = {k: v.reshape(v.shape[:1] + tuple(item_shapes[k])) for k, v in batch.items()}
    return batch


def train_resident_multi_step(state: TrainState, data: dict, icon_idx: torch.Tensor,
                              weights_fn, optimizer, model_args: list, n_augs: int = 1,
                              item_shapes: dict | None = None):
    """K training steps whose batches are gathered on the device from the
    resident corpus ``data`` (``data/resident.py``) by ``icon_idx [K, B]``,
    the only data that crosses from the host. Counterpart of
    ``jit_train_resident_multi_step``. Each result is a ``[K]`` tensor."""
    results = []
    for k in range(icon_idx.shape[0]):
        batch = gather_batch(data, icon_idx[k], state.step, n_augs, item_shapes)
        state, res = train_step(state, batch, weights_fn(state.step), optimizer, model_args)
        results.append(res)
    return state, _scalars(results)


@torch.no_grad()
def eval_step(state: TrainState, batch: dict, weights: dict, model_args: list,
              fused_ce: bool = True) -> dict:
    """Forward and loss without dropout or update."""
    batch = decompress_batch(batch)
    args = [batch[k] for k in model_args]
    out = state.model(*args, return_tgt=True, deterministic=True, fused_ce=fused_ce)
    return svg_loss(out, weights, state.model.cfg)
