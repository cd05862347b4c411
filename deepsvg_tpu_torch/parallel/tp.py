"""Tensor-parallel training over a 2-D (data x model) mesh, counterpart of
``deepsvg_tpu/parallel/tp.py``.

Megatron's split of each transformer layer over the ``model`` axis: the QKV
and FF-in products are column-parallel (their output features, and their
biases, split across the ranks, QKV by heads, so that each rank attends over
its own heads), the out-projection and FF-out row-parallel (their input
features split, their biases whole); the AdamW moments follow their
parameters; everything else is replicated. The batch is split over
``data``, as in data parallelism.

The JAX package's TP partitions plain XLA ops with GSPMD and refuses its
Pallas kernels, which GSPMD cannot split. Here each rank runs the layer's
plain PyTorch math on its shards, on any device, with Megatron's two
operators around it (:class:`CopyToModel` at a column-parallel input: the
identity forward, an all-reduce of the gradient backward;
:class:`ReduceFromModel` at a row-parallel output: an all-reduce forward,
the identity backward), so TP needs ``all_reduce`` alone, which gloo also
takes on CUDA tensors. The dropout masks hash each element's coordinates in
the whole layer (``ops/dropout.py``), so a shard draws the masks the whole
layer draws. TP is its own entry point: :func:`make_tp_train_step` takes
the state from :func:`shard_state_tp` and refuses whole layers, and the
kernel path (``train_step``, data parallelism) refuses sharded ones.
"""
from __future__ import annotations

import copy

import torch
import torch.distributed as dist
from torch import nn

from ..ops.layer import _layer_norm_f32, _mm
from ..ops.dropout import (
    SITE_ATTN_OUT, SITE_ATTN_PROB, SITE_FF_HIDDEN, SITE_FF_OUT, dropout_factor)
from ..training.trainer import MultiOptimizer, TrainState, loss_and_grads

# Megatron's layer split (models/layers.py parameter names, nn.Linear layout
# [out, in]): the dimension a parameter is split along over "model". qkv is
# column-parallel (the JAX kernel's columns are these rows), split head by
# head within q, k and v; ff1 column-parallel; out_proj and ff2 row-parallel,
# their biases replicated (a row-parallel output is whole after its
# all-reduce). Unmatched parameters are replicated.
TP_RULES = (
    ("qkv.weight", 0),
    ("qkv.bias", 0),
    ("ff1.weight", 0),
    ("ff1.bias", 0),
    ("ff2.weight", 1),
    ("out_proj.weight", 1),
)


def _dim_for(name: str):
    for suffix, dim in TP_RULES:
        if name.endswith(suffix):
            return dim
    return None


def state_tp_shardings(state: TrainState, mesh, model_axis: str = "model") -> dict:
    """``{parameter name: dim}``: the dimension each parameter, and each of
    its optimizer moments, is split along over ``model_axis``; None where it
    is replicated."""
    return {name: _dim_for(name) for name, _ in state.model.named_parameters()}


def _shard(t: torch.Tensor, name: str, dim, rank: int, size: int) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim``; qkv's rows are taken head
    by head within q, k and v (three equal parts, each split in ``size``)."""
    if dim is None:
        return t.clone()
    if t.shape[dim] % (3 * size if name.endswith(("qkv.weight", "qkv.bias")) else size):
        raise ValueError(f"{name} of shape {tuple(t.shape)} does not split over {size} ranks")
    if name.endswith(("qkv.weight", "qkv.bias")):
        parts = t.reshape((3, size, -1) + tuple(t.shape[1:]))
        return parts[:, rank].reshape((-1,) + tuple(t.shape[1:])).clone()
    return t.chunk(size, dim)[rank].clone()


def _unshard(blocks: list, name: str, dim) -> torch.Tensor:
    """The whole tensor from every rank's block (:func:`_shard` undone)."""
    if name.endswith(("qkv.weight", "qkv.bias")):
        parts = [b.reshape((3, -1) + tuple(b.shape[1:])) for b in blocks]
        return torch.cat(parts, dim=1).reshape((-1,) + tuple(blocks[0].shape[1:]))
    return torch.cat(blocks, dim)


class _ModelAxis:
    """A layer's place on the model axis: the group, this rank, its size."""

    def __init__(self, group):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)

    def layer_train(self, layer, x, seq_bias, mask, causal, deterministic, rng):
        if deterministic:
            raise ValueError("a tensor-parallel layer runs the training step alone "
                             "(make_tp_train_step); inference takes whole layers")
        rate = layer.dropout if rng is not None else 0.0
        seed = rng.seed() if rate > 0.0 else 0
        return tp_layer_train(x, seq_bias, *layer.masters(), mask, seed, layer.n_heads,
                              causal, rate, layer.compute_dtype, self)


class CopyToModel(torch.autograd.Function):
    """Megatron's ``f`` at a column-parallel input: the identity forward,
    the gradient summed over the model axis backward (each rank's shard
    contributes its part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        total = g.float().contiguous()
        dist.all_reduce(total, group=ctx.group)
        return total.to(g.dtype), None


class ReduceFromModel(torch.autograd.Function):
    """Megatron's ``g`` at a row-parallel output: the ranks' partial sums
    summed forward, the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        total = x.float().contiguous()
        dist.all_reduce(total, group=group)
        return total.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_layer_train(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask,
                   seed: int, n_heads: int, causal: bool, rate: float, weight_dtype,
                   axis: _ModelAxis):
    """The training layer (``ops/layer_vjp.py:layer_train_reference``, the
    plain version of K4) on this rank's shards: ``wqkv``/``bqkv`` its heads'
    rows, ``w1``/``b1`` its FF units, ``wo``/``w2`` their input columns; the
    masters cast to ``weight_dtype`` where they are used. Returns the whole
    layer's output on every rank of the model axis."""
    b, s, d = x.shape
    dt = x.dtype
    hd = d // n_heads
    heads = n_heads // axis.size
    dl, fl = heads * hd, w1.shape[0]
    ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2 = (
        w.to(weight_dtype) for w in (ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2))
    dev = x.device
    drop = rate > 0.0
    if drop:
        rows = torch.arange(b * s, device=dev).reshape(b, s, 1)
        # the whole layer's coordinates of this rank's heads and FF units
        prob_rows = torch.arange(b * n_heads * s, device=dev).reshape(b, n_heads, s, 1)
        prob_rows = prob_rows[:, axis.rank * heads:(axis.rank + 1) * heads]
        factor = lambda site, cols: dropout_factor(seed, site, rows, cols, rate)  # noqa: E731
    xf = x.float()
    xn = CopyToModel.apply(_layer_norm_f32(xf, ln1).to(dt), axis.group)
    qkv = (_mm(xn, wqkv) + bqkv.float()).to(dt)
    q, k, v = (qkv[..., i * dl:(i + 1) * dl].reshape(b, s, heads, hd).transpose(1, 2)
               for i in range(3))
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (hd ** -0.5)
    scores = scores + mask.float()[:, None, None, :]
    if causal:
        upper = torch.ones(s, s, dtype=torch.bool, device=dev).triu(1)
        scores = scores.masked_fill(upper, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    e = torch.exp(scores - m)
    p = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if drop:
        p = p * dropout_factor(seed, SITE_ATTN_PROB, prob_rows, torch.arange(s, device=dev),
                               rate)
    ctx = torch.matmul(p.to(dt).float(), v.float()).to(dt)
    ctx = ctx.transpose(1, 2).reshape(b, s, dl)
    a = ReduceFromModel.apply(_mm(ctx, wo), axis.group) + bo.float()
    if drop:
        a = a * factor(SITE_ATTN_OUT, torch.arange(d, device=dev))
    xf = xf + a
    if seq_bias is not None:
        xf = xf + seq_bias.float()[:, None, :]
    xn2 = CopyToModel.apply(_layer_norm_f32(xf, ln2).to(dt), axis.group)
    h = torch.relu(_mm(xn2, w1) + b1.float())
    if drop:
        h = h * factor(SITE_FF_HIDDEN, torch.arange(axis.rank * fl, (axis.rank + 1) * fl,
                                                    device=dev))
    ff = ReduceFromModel.apply(_mm(h.to(dt), w2), axis.group) + b2.float()
    if drop:
        ff = ff * factor(SITE_FF_OUT, torch.arange(d, device=dev))
    return (xf + ff).to(dt)


def shard_state_tp(state: TrainState, mesh, model_axis: str = "model") -> TrainState:
    """A copy of ``state`` whose layers hold this rank's shards over
    ``model_axis`` (:data:`TP_RULES`), with the optimizer's moments split
    alike; the model is marked so that the kernel path refuses it."""
    if "mu" not in state.opt_state:
        raise ValueError("shard_state_tp splits one AdamW state (make_optimizer); a "
                         "MultiOptimizer's states are not split")
    group = mesh.get_group(model_axis)
    axis = _ModelAxis(group)
    model = copy.deepcopy(state.model)
    dims = state_tp_shardings(state, mesh, model_axis)
    names = [name for name, _ in model.named_parameters()]
    for name in names:
        owner, leaf = model, name
        if "." in name:
            path, leaf = name.rsplit(".", 1)
            owner = model.get_submodule(path)
        p = getattr(owner, leaf)
        owner._parameters[leaf] = nn.Parameter(
            _shard(p.detach(), name, dims[name], axis.rank, axis.size))
    for layer in model.modules():
        if hasattr(layer, "tp") and hasattr(layer, "masters"):
            layer.tp = axis
    model.__dict__["tp_shards"] = axis
    opt = dict(state.opt_state)
    for key in ("mu", "nu"):
        opt[key] = [_shard(t, n, dims[n], axis.rank, axis.size)
                    for t, n in zip(state.opt_state[key], names)]
    gen = torch.Generator().set_state(state.generator.get_state())
    return TrainState(model, opt, state.step, gen)


def gather_params_tp(state: TrainState) -> dict:
    """``{parameter name: tensor}``, the whole parameters of a sharded
    state, gathered from every rank of its model axis (each rank gets them
    all)."""
    axis = state.model.__dict__["tp_shards"]
    out = {}
    for name, p in state.model.named_parameters():
        dim = _dim_for(name)
        if dim is None:
            out[name] = p.detach().clone()
            continue
        blocks = [torch.empty_like(p) for _ in range(axis.size)]
        dist.all_gather(blocks, p.detach().contiguous(), group=axis.group)
        out[name] = _unshard(blocks, name, dim)
    return out


def make_tp_train_step(model, optimizer, model_args, mesh, state: TrainState,
                       data_axis: str = "data", model_axis: str = "model"):
    """The tensor-parallel train step ``step(state, batch, weights)`` on a
    state from :func:`shard_state_tp` and this rank's rows of the batch
    (``shard_batch`` over ``data_axis``): the single-device step's
    semantics, the global batch's loss, the global gradient norm for the
    clip (the shards' squares summed over ``model_axis``), the same AdamW
    on each shard. The argument cross-entropy is the plain one, as the JAX
    package's XLA path computes it. Refuses whole layers."""
    axis = state.model.__dict__.get("tp_shards")
    if axis is None:
        raise ValueError("make_tp_train_step runs the layers' plain math on their shards: "
                         "this state holds whole layers, which the kernels train "
                         "(train_step, make_parallel_train_step); split it with "
                         "shard_state_tp first")
    if isinstance(optimizer, MultiOptimizer):
        raise ValueError("make_tp_train_step takes one AdamW optimizer (make_optimizer)")
    data_group = mesh.get_group(data_axis)
    split = [_dim_for(name) is not None for name, _ in state.model.named_parameters()]

    def step(state: TrainState, batch: dict, weights: dict):
        res, grads = loss_and_grads(state, batch, weights, model_args, data_group,
                                    fused_ce=False)
        sq = [g.float().pow(2).sum() for g in grads]
        sharded = torch.stack([v for v, s in zip(sq, split) if s]).sum()
        dist.all_reduce(sharded, group=axis.group)
        whole = torch.stack([v for v, s in zip(sq, split) if not s]).sum()
        norm = torch.sqrt(sharded + whole)
        res["grad_norm"] = optimizer.update(state.parameters(), grads, state.opt_state, norm)
        state.step += 1
        return state, res

    return step
