"""Transformer building blocks (batch-first ``[B, S, D]``).

Counterparts of ``deepsvg_tpu/models/layers.py``: the pre-LN encoder layer,
the decoder layer with the latent injected as a per-layer linear broadcast
(no cross-attention), the stacks with their final LayerNorm, and the
learned positional table. Each layer runs as one fused kernel: at inference
(``deterministic=True``) K2 (``ops/layer.py``), when training K4
(``ops/layer_vjp.py``) with dropout inside the kernel and the dropout of the
per-sequence injection outside it. On CPU tensors those are the plain
versions. A sequence goes to the kernels at its own length (the JAX package
pads S to a multiple of 8 for the TPU; that is not part of the contract):
K2 and K4 take their short form up to 32 rows (float32 K4: 16) and their
long form up to 256, Sketchformer's encoder at S = 242 and its causal
decoder at S = 241 included.

When training, a stack of short sequences (the hierarchical E2 and D2, S = 8)
runs all its layers as one fused kernel pair, K7 (``ops/stack_vjp.py``),
where :func:`use_stack_fused` says so: the JAX package's gate, unchanged,
because it also decides the activations' type (below).

Parameters are float32; ``compute_dtype`` is applied at use (``cast.py``).
A layer's activations keep the type they come in: the hierarchical encoder
gets the float32 pooled output of the first stage and runs float32
activations against weights rounded to ``compute_dtype`` at inference and,
when training, where the gate is false. Where it is true, the stack runs in
``compute_dtype`` and casts its result back, as the JAX package's stack path
does. A stack's final LayerNorm computes in float32 from float32 parameters
and returns ``compute_dtype``.

The decoder stack also runs one token of an autoregressive decode against
per-layer key/value caches (:meth:`DecoderStack.decode_step`, the JAX
package's ``decode_index`` mode and ``_attention_cached``): plain PyTorch
operations in the compute type, the residual rounded to it after each sum as
XLA does there. On the card the greedy decode takes kernel K9 instead
(``ops/decode.py``), which runs the whole stack for the token in one launch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import layer as layer_ops
from ..ops import layer_vjp, stack_vjp
from ..ops.layer import LN_EPS
from .cast import DropoutRng, cast_at_use


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = LN_EPS, out_dtype=None) -> torch.Tensor:
    """LayerNorm computed in float32, returned in ``out_dtype`` (default
    ``x``'s)."""
    return F.layer_norm(x.float(), x.shape[-1:], scale.float(), bias.float(),
                        eps).to(out_dtype or x.dtype)


def key_padding_to_additive(key_padding_mask: torch.Tensor | None):
    """``[B, S]`` bool (True = masked) -> additive ``[B, S]`` float32."""
    if key_padding_mask is None:
        return None
    zeros = torch.zeros(key_padding_mask.shape, dtype=torch.float32,
                        device=key_padding_mask.device)
    return zeros.masked_fill(key_padding_mask, float("-inf"))


def use_stack_fused(deterministic: bool, n_layers: int, b: int, s: int) -> bool:
    """Whether a stack's training forward takes K7: the JAX package's gate
    (``deepsvg_tpu/models/layers.py:_use_stack_fused``) as it is. Training,
    more than one layer, sequences of at most 16 (padded to a multiple of 8)
    and at most 512 rows (the recipe batch B=60 at S=8 gives 480; the TPU
    kernel's backward did not fit its scoped memory at 1,024)."""
    s_pad = -(-s // 8) * 8
    return not deterministic and n_layers > 1 and s_pad <= 16 and b * s_pad <= 512


def stacked_train(layers, x, seq_biases, mask, causal: bool, rng: DropoutRng | None):
    """The layers of a stack as one K7 call, counterpart of the JAX
    package's ``_stacked_train``: ``x`` cast to the compute type and the
    result cast back, ``seq_biases [L, B, D]`` (dropout applied) or zeros,
    one seed for the stack."""
    first = layers[0]
    dt = first.compute_dtype
    in_dtype = x.dtype
    x = x.to(dt)
    if seq_biases is None:
        seq_biases = torch.zeros((len(layers),) + x.shape[:1] + x.shape[2:], dtype=dt,
                                 device=x.device)
    rate = first.dropout if rng is not None else 0.0
    seed = rng.seed() if rate > 0.0 else 0
    masters = [torch.stack(ws) for ws in zip(*(layer.masters() for layer in layers))]
    out = stack_vjp.fused_stack_train(x, seq_biases.to(dt), *masters, mask, seed,
                                      first.n_heads, causal, rate, dt)
    return out.to(in_dtype)


class LayerNorm(nn.LayerNorm):
    """A stack's final LayerNorm (flax ``norm/{scale,bias}``): float32
    parameters and arithmetic, output in ``compute_dtype``."""

    def __init__(self, d_model: int, eps: float, compute_dtype=torch.float32):
        super().__init__(d_model, eps=eps)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps, self.compute_dtype)


class EncoderLayerImproved(nn.Module):
    """Pre-LN encoder layer. ``norm1``/``norm2`` are stacked ``[2, D]``
    (row 0 scale, row 1 bias); ``qkv`` holds q|k|v fused."""

    def __init__(self, d_model: int, n_heads: int, dim_feedforward: int,
                 dropout: float = 0.0, compute_dtype=torch.float32):
        super().__init__()
        d = d_model
        self.n_heads = n_heads
        self.dropout = dropout
        self.compute_dtype = compute_dtype
        self.norm1 = nn.Parameter(torch.stack([torch.ones(d), torch.zeros(d)]))
        self.qkv = nn.Linear(d, 3 * d)
        self.out_proj = nn.Linear(d, d)
        self.norm2 = nn.Parameter(torch.stack([torch.ones(d), torch.zeros(d)]))
        self.ff1 = nn.Linear(d, dim_feedforward)
        self.ff2 = nn.Linear(dim_feedforward, d)

    def masters(self):
        """The ten float32 parameters in the fused layer's argument order."""
        return (self.norm1, self.qkv.weight, self.qkv.bias, self.out_proj.weight,
                self.out_proj.bias, self.norm2, self.ff1.weight, self.ff1.bias,
                self.ff2.weight, self.ff2.bias)

    def weights(self, act_dtype):
        """The parameters as the inference kernel reads them: rounded to
        ``compute_dtype``, stored in the activations' type (cached)."""
        return tuple(cast_at_use(self, str(i), p, self.compute_dtype, act_dtype)
                     for i, p in enumerate(self.masters()))

    def _run(self, x, seq_bias, mask, causal, deterministic, rng):
        if deterministic:
            return layer_ops.fused_layer(x, seq_bias, *self.weights(x.dtype), mask,
                                         self.n_heads, causal)
        rate = self.dropout if rng is not None else 0.0
        seed = rng.seed() if rate > 0.0 else 0
        return layer_vjp.fused_layer_train(x, seq_bias, *self.masters(), mask, seed,
                                           self.n_heads, causal, rate, self.compute_dtype)

    def forward(self, src, mask, deterministic: bool = True, rng: DropoutRng | None = None):
        """``mask [B, S]``: additive float32 over keys."""
        return self._run(src, None, mask, False, deterministic, rng)


class DecoderLayerGlobalImproved(EncoderLayerImproved):
    """Pre-LN decoder layer: ``tgt += glob(z)`` broadcast over the sequence
    after the attention block, in place of cross-attention. The injection is
    a small ``[B, D]`` product left to ``F.linear`` (the JAX wrapper leaves it
    to XLA); when training, its dropout is applied here, outside the kernel,
    and its gradient comes back as the kernel's ``dseq_bias``."""

    def __init__(self, d_model: int, n_heads: int, dim_feedforward: int, dim_z: int,
                 dropout: float = 0.0, compute_dtype=torch.float32):
        super().__init__(d_model, n_heads, dim_feedforward, dropout, compute_dtype)
        self.glob = nn.Linear(dim_z, d_model)

    def injection(self, z, deterministic: bool = True):
        """``glob(z) [B, D]`` in the compute type, before its dropout."""
        dt = self.compute_dtype
        wg = cast_at_use(self, "wg", self.glob.weight, dt, deterministic=deterministic)
        bg = cast_at_use(self, "bg", self.glob.bias, dt, deterministic=deterministic)
        return F.linear(z.to(dt), wg, bg)

    def forward(self, tgt, z, mask, causal: bool = False, deterministic: bool = True,
                rng: DropoutRng | None = None):
        seq_bias = self.injection(z, deterministic)
        if not deterministic and rng is not None:
            seq_bias = rng.dropout(seq_bias, self.dropout)
        return self._run(tgt, seq_bias.to(tgt.dtype), mask, causal, deterministic, rng)

    def decode_step(self, tgt, z, kcache, vcache, index: int, key_pad):
        """One token ``tgt [B, D]`` at position ``index`` (compute type):
        its key and value go into ``kcache``/``vcache [B, T, D]`` at
        ``index`` (in place), and its query attends over positions
        ``0..index`` with the additive ``key_pad [B, T]``."""
        b, d = tgt.shape
        h = self.n_heads
        hd = d // h
        ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2 = self.weights(tgt.dtype)
        qkv = F.linear(layer_norm(tgt, ln1[0], ln1[1]), wqkv, bqkv)
        q, k_t, v_t = qkv[:, :d], qkv[:, d:2 * d], qkv[:, 2 * d:]
        kcache[:, index] = k_t
        vcache[:, index] = v_t
        qh = (q.reshape(b, h, hd) * hd ** -0.5).float()
        kh = kcache[:, :index + 1].reshape(b, index + 1, h, hd).float()
        scores = torch.einsum("bhd,bkhd->bhk", qh, kh) + key_pad[:, None, :index + 1]
        prob = torch.softmax(scores, dim=-1).to(tgt.dtype)
        vh = vcache[:, :index + 1].reshape(b, index + 1, h, hd)
        ctx = torch.einsum("bhk,bkhd->bhd", prob, vh).reshape(b, d)
        tgt = tgt + F.linear(ctx, wo, bo)
        tgt = tgt + self.injection(z).to(tgt.dtype)
        hidden = torch.relu(F.linear(layer_norm(tgt, ln2[0], ln2[1]), w1, b1))
        return tgt + F.linear(hidden, w2, b2)


class EncoderStack(nn.Module):
    """N encoder layers + final LayerNorm."""

    def __init__(self, n_layers: int, d_model: int, n_heads: int,
                 dim_feedforward: int, dropout: float = 0.0, compute_dtype=torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayerImproved(d_model, n_heads, dim_feedforward, dropout, compute_dtype)
            for _ in range(n_layers))
        self.norm = LayerNorm(d_model, LN_EPS, compute_dtype)

    def forward(self, src, mask, deterministic: bool = True, rng: DropoutRng | None = None):
        """``mask [B, S]``: additive float32 over keys."""
        b, s, _ = src.shape
        if use_stack_fused(deterministic, len(self.layers), b, s):
            src = stacked_train(self.layers, src, None, mask, False, rng)
        else:
            for layer in self.layers:
                src = layer(src, mask, deterministic, rng)
        return self.norm(src)


class DecoderStack(nn.Module):
    """N latent-conditioned decoder layers + final LayerNorm."""

    def __init__(self, n_layers: int, d_model: int, n_heads: int,
                 dim_feedforward: int, dim_z: int, dropout: float = 0.0,
                 compute_dtype=torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayerGlobalImproved(d_model, n_heads, dim_feedforward, dim_z, dropout,
                                       compute_dtype)
            for _ in range(n_layers))
        self.norm = LayerNorm(d_model, LN_EPS, compute_dtype)

    def forward(self, tgt, z, deterministic: bool = True, rng: DropoutRng | None = None,
                key_pad=None, causal: bool = False):
        """The one-shot decoders attend over every query position; the
        autoregressive decoder's teacher forcing is ``causal`` with the
        additive ``key_pad [B, S]`` over its keys."""
        mask = (key_pad if key_pad is not None else
                torch.zeros(tgt.shape[:2], dtype=torch.float32, device=tgt.device))
        b, s, _ = tgt.shape
        if use_stack_fused(deterministic, len(self.layers), b, s):
            # the latent's injection into each layer [L, B, D], one dropout
            # draw over all of them
            biases = torch.stack([layer.injection(z, False) for layer in self.layers])
            if rng is not None:
                biases = rng.dropout(biases, self.layers[0].dropout)
            tgt = stacked_train(self.layers, tgt, biases, mask, causal, rng)
        else:
            for layer in self.layers:
                tgt = layer(tgt, z, mask, causal, deterministic, rng)
        return self.norm(tgt)

    def decode_step(self, x, z, caches, index: int, key_pad):
        """One token ``x [B, D]`` through every layer, with ``caches`` the
        per-layer ``(k, v)`` pairs ``[B, T, D]`` (written at ``index``), then
        the final LayerNorm."""
        for layer, (kc, vc) in zip(self.layers, caches):
            x = layer.decode_step(x, z, kc, vc, index, key_pad)
        return self.norm(x)


class PositionalEncodingLUT(nn.Module):
    """Learned positional table added to the input, then dropout."""

    def __init__(self, max_len: int, d_model: int, dropout: float = 0.0,
                 compute_dtype=torch.float32):
        super().__init__()
        self.dropout = dropout
        self.compute_dtype = compute_dtype
        self.pos_embed = nn.Parameter(torch.zeros(max_len, d_model))

    def table(self, deterministic: bool = True):
        return cast_at_use(self, "pos_embed", self.pos_embed, self.compute_dtype,
                           deterministic=deterministic)

    def forward(self, x, deterministic: bool = True, rng: DropoutRng | None = None):
        x = x + self.table(deterministic)[:x.shape[-2]]
        if not deterministic and rng is not None:
            x = rng.dropout(x, self.dropout)
        return x
