"""Transformer building blocks (batch-first ``[B, S, D]``), inference only.

Counterparts of ``deepsvg_tpu/models/layers.py``: the pre-LN encoder layer,
the decoder layer with the latent injected as a per-layer linear broadcast
(no cross-attention), the stacks with their final LayerNorm, and the
learned positional table. Each layer runs as one fused kernel
(``ops/layer.py``); on CPU tensors that is the plain version.

Only the deterministic inference branches are ported; dropout, the
training kernels and the KV-cached decode step come with later slices.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import layer as layer_ops
from ..ops.layer import LN_EPS


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm computed in float32, returned in ``x``'s dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], scale.float(), bias.float(),
                        eps).to(x.dtype)


def key_padding_to_additive(key_padding_mask: torch.Tensor | None):
    """``[B, S]`` bool (True = masked) -> additive ``[B, S]`` float32."""
    if key_padding_mask is None:
        return None
    zeros = torch.zeros(key_padding_mask.shape, dtype=torch.float32,
                        device=key_padding_mask.device)
    return zeros.masked_fill(key_padding_mask, float("-inf"))


class LayerNorm(nn.LayerNorm):
    """A stack's final LayerNorm (flax ``norm/{scale,bias}``), in float32."""

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class EncoderLayerImproved(nn.Module):
    """Pre-LN encoder layer. ``norm1``/``norm2`` are stacked ``[2, D]``
    (row 0 scale, row 1 bias); ``qkv`` holds q|k|v fused."""

    def __init__(self, d_model: int, n_heads: int, dim_feedforward: int):
        super().__init__()
        d = d_model
        self.n_heads = n_heads
        self.norm1 = nn.Parameter(torch.stack([torch.ones(d), torch.zeros(d)]))
        self.qkv = nn.Linear(d, 3 * d)
        self.out_proj = nn.Linear(d, d)
        self.norm2 = nn.Parameter(torch.stack([torch.ones(d), torch.zeros(d)]))
        self.ff1 = nn.Linear(d, dim_feedforward)
        self.ff2 = nn.Linear(dim_feedforward, d)

    def attention_weights(self):
        return (self.norm1, self.qkv.weight, self.qkv.bias, self.out_proj.weight,
                self.out_proj.bias)

    def ff_weights(self):
        return (self.norm2, self.ff1.weight, self.ff1.bias, self.ff2.weight,
                self.ff2.bias)

    def forward(self, src, mask):
        """``mask [B, S]``: additive float32 over keys."""
        return layer_ops.fused_encoder_layer(
            src, *self.attention_weights(), *self.ff_weights(), mask, self.n_heads)


class DecoderLayerGlobalImproved(EncoderLayerImproved):
    """Pre-LN decoder layer: ``tgt += glob(z)`` broadcast over the sequence
    after the attention block, in place of cross-attention."""

    def __init__(self, d_model: int, n_heads: int, dim_feedforward: int,
                 dim_z: int):
        super().__init__(d_model, n_heads, dim_feedforward)
        self.glob = nn.Linear(dim_z, d_model)

    def forward(self, tgt, z, mask):
        return layer_ops.fused_decoder_layer(
            tgt, z, *self.attention_weights(), self.glob.weight, self.glob.bias,
            *self.ff_weights(), mask, self.n_heads)


class EncoderStack(nn.Module):
    """N encoder layers + final LayerNorm."""

    def __init__(self, n_layers: int, d_model: int, n_heads: int,
                 dim_feedforward: int):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayerImproved(d_model, n_heads, dim_feedforward)
            for _ in range(n_layers))
        self.norm = LayerNorm(d_model, eps=LN_EPS)

    def forward(self, src, mask):
        """``mask [B, S]``: additive float32 over keys."""
        for layer in self.layers:
            src = layer(src, mask)
        return self.norm(src)


class DecoderStack(nn.Module):
    """N latent-conditioned decoder layers + final LayerNorm."""

    def __init__(self, n_layers: int, d_model: int, n_heads: int,
                 dim_feedforward: int, dim_z: int):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayerGlobalImproved(d_model, n_heads, dim_feedforward, dim_z)
            for _ in range(n_layers))
        self.norm = LayerNorm(d_model, eps=LN_EPS)

    def forward(self, tgt, z):
        """The one-shot decoders attend over every query position."""
        mask = torch.zeros(tgt.shape[:2], dtype=torch.float32, device=tgt.device)
        for layer in self.layers:
            tgt = layer(tgt, z, mask)
        return self.norm(tgt)


class PositionalEncodingLUT(nn.Module):
    """Learned positional table added to the input (dropout is identity at
    inference)."""

    def __init__(self, max_len: int, d_model: int):
        super().__init__()
        self.pos_embed = nn.Parameter(torch.zeros(max_len, d_model))

    def forward(self, x):
        return x + self.pos_embed[:x.shape[-2]].to(x.dtype)
