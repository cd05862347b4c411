"""The SVG Transformer, hierarchical one-shot inference (batch-first).

Counterpart of ``deepsvg_tpu/models/model.py`` for the flagship
``hierarchical_ordered`` path:

  E1 (per-path encoder) -> masked mean pool -> hierarchical PE -> E2 (over
  the path latents, visibility-masked) -> visibility-weighted pool -> ResNet
  -> linear bottleneck -> D2 (learned group queries, latent injected per
  layer) -> HierarchFCN (visibility + per-path latents) -> D1 (learned
  command queries) -> FCN heads.

The variants this port does not run yet raise ``NotImplementedError`` when
the model is built, naming the ``ROADMAP.md`` item that ports them.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops import head as head_ops
from ..svgtensor import masks as M
from .config import ModelConfig
from .embeddings import ConstEmbedding, SVGEmbedding
from .layers import DecoderStack, EncoderStack, PositionalEncodingLUT, key_padding_to_additive

_UNSUPPORTED = (
    (lambda c: c.use_vae, "the VAE bottleneck"),
    (lambda c: c.label_condition, "label conditioning"),
    (lambda c: c.pred_mode != "one_shot" or c.rel_targets,
     "autoregressive decoding and relative targets"),
    (lambda c: c.model_type != "transformer", "the LSTM encoder and decoder"),
    (lambda c: c.self_match, "Hungarian self-match"),
    (lambda c: c.encode_stages != 2 or c.decode_stages != 2,
     "one-stage encoding or decoding"),
)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a variant outside the ported slice."""
    for test, what in _UNSUPPORTED:
        if test(cfg):
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP.md, queue 1, item 8 "
                "'Model variants')")


def _masked_mean(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Mean of ``x [B, S, D]`` over S weighted by ``weight [B, S]``, in f32."""
    w = weight.to(torch.float32)
    return (x.float() * w[..., None]).sum(dim=1) / w.sum(dim=1, keepdim=True).clamp_min(1.0)


class ResNet(nn.Module):
    """Four residual blocks ``z + relu(linear_i(z))``."""

    def __init__(self, d_model: int):
        super().__init__()
        self.linears = nn.ModuleList(nn.Linear(d_model, d_model) for _ in range(4))

    def forward(self, z):
        for linear in self.linears:
            z = z + torch.relu(linear(z))
        return z


class Bottleneck(nn.Module):
    """The flagship's plain linear bottleneck (``use_vae=False``)."""

    def __init__(self, d_model: int, dim_z: int):
        super().__init__()
        self.bottleneck = nn.Linear(d_model, dim_z)

    def forward(self, z):
        return self.bottleneck(z)


class FCN(nn.Module):
    """Command and argument heads.

    ``argmax=True`` returns first-index argmax ids through kernel K3
    (``ops/head.py``) without forming the argument logits. The kernel reads
    the heads in a padded per-slot layout, kept as buffers that :meth:`pack`
    rebuilds from the heads at every weight load (``load_flax_params`` and
    ``load_state_dict``); ``.to()`` moves and casts them with the rest of the
    module. A change to the heads by other means must call :meth:`pack`.
    """

    def __init__(self, d_model: int, n_commands: int, n_args: int, args_dim: int):
        super().__init__()
        self.n_commands, self.n_args, self.args_dim = n_commands, n_args, args_dim
        self.command_fcn = nn.Linear(d_model, n_commands)
        self.args_fcn = nn.Linear(d_model, n_args * args_dim)
        self.register_buffer("w_packed", torch.empty(0), persistent=False)
        self.register_buffer("b_packed", torch.empty(0), persistent=False)
        self.pack()
        self.register_load_state_dict_post_hook(lambda module, _keys: module.pack())

    @torch.no_grad()
    def pack(self) -> None:
        self.w_packed, self.b_packed = head_ops.pack_head(
            self.command_fcn.weight, self.command_fcn.bias, self.args_fcn.weight,
            self.args_fcn.bias, self.n_args)

    def forward(self, out, argmax: bool = False):
        lead = out.shape[:-1]
        if argmax:
            ids = head_ops.fused_head_argmax(
                out.reshape(-1, out.shape[-1]).contiguous(), self.w_packed,
                self.b_packed, self.n_commands, self.n_args, self.args_dim)
            return ids[:, 0].reshape(lead), ids[:, 1:].reshape(lead + (self.n_args,))
        cmd_logits = self.command_fcn(out)
        args_logits = self.args_fcn(out).reshape(lead + (self.n_args, self.args_dim))
        return cmd_logits, args_logits


class HierarchFCN(nn.Module):
    """Per-group visibility logits and path latents."""

    def __init__(self, d_model: int, dim_z: int):
        super().__init__()
        self.visibility_fcn = nn.Linear(d_model, 2)
        self.z_fcn = nn.Linear(d_model, dim_z)

    def forward(self, out):
        return self.visibility_fcn(out), self.z_fcn(out)


class Encoder(nn.Module):
    """Two-stage encoder: ``commands [N, G, S]``, ``args [N, G, S, n_args]``
    -> ``z [N, d_model]``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.embedding = SVGEmbedding(cfg, cfg.max_seq_len)
        self.encoder = EncoderStack(cfg.n_layers, d, cfg.n_heads, cfg.dim_feedforward)
        self.hierarchical_PE = PositionalEncodingLUT(cfg.max_num_groups, d)
        self.hierarchical_encoder = EncoderStack(cfg.n_layers, d, cfg.n_heads,
                                                 cfg.dim_feedforward)

    def forward(self, commands, args):
        n, g, s = commands.shape
        dtype = self.embedding.command_embed.dtype
        vis = M.visibility_mask(commands)                     # [N, G]
        commands_f = commands.reshape(n * g, s)
        args_f = args.reshape(n * g, s, args.shape[-1])
        pad = M.padding_mask(commands_f)                      # [N*G, S]
        key_pad = key_padding_to_additive(M.key_padding_mask(commands_f))

        src = self.embedding(commands_f, args_f)
        memory = self.encoder(src, key_pad)
        z = _masked_mean(memory, pad).reshape(n, g, -1)          # float32

        # JAX keeps the E2 input and stream in float32 here; the layer kernel
        # takes the compute dtype, so the sum is rounded once (ROADMAP.md,
        # "Faults")
        src2 = self.hierarchical_PE(z).to(dtype)
        memory2 = self.hierarchical_encoder(src2, key_padding_to_additive(~vis))
        return _masked_mean(memory2, vis).to(dtype)


class Decoder(nn.Module):
    """Two-stage one-shot decoder: ``z [N, dim_z]`` -> command and argument
    outputs ``[N, G, S+1, ...]`` and visibility logits ``[N, G, 2]``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.hierarchical_embedding = ConstEmbedding(cfg, cfg.n_groups_prop)
        self.hierarchical_decoder = DecoderStack(cfg.n_layers_decode, d, cfg.n_heads,
                                                 cfg.dim_feedforward, cfg.dim_z)
        self.hierarchical_fcn = HierarchFCN(d, cfg.dim_z)
        self.embedding = ConstEmbedding(cfg, cfg.max_seq_len + 1)
        self.decoder = DecoderStack(cfg.n_layers_decode, d, cfg.n_heads,
                                    cfg.dim_feedforward, cfg.dim_z)
        self.fcn = FCN(d, cfg.n_commands, cfg.n_args, cfg.args_dim_out)

    def forward(self, z, argmax_head: bool = False):
        n = z.shape[0]
        out = self.hierarchical_decoder(self.hierarchical_embedding(n), z)
        visibility_logits, z_groups = self.hierarchical_fcn(out)   # [N, P, *]
        zb = z_groups.reshape(-1, z_groups.shape[-1])               # [N*P, dim_z]
        out = self.decoder(self.embedding(zb.shape[0]), zb)
        cmd, args = self.fcn(out, argmax=argmax_head)
        return cmd.reshape((n, -1) + cmd.shape[1:]), \
            args.reshape((n, -1) + args.shape[1:]), visibility_logits


class SVGTransformer(nn.Module):
    """The hierarchical one-shot SVG Transformer (inference)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.resnet = ResNet(cfg.d_model) if cfg.use_resnet else None
        self.bottleneck = Bottleneck(cfg.d_model, cfg.dim_z)
        self.decoder = Decoder(cfg)

    def encode(self, commands, args):
        """Input -> latent ``z [N, dim_z]``."""
        z = self.encoder(commands, args)
        if self.resnet is not None:
            z = self.resnet(z)
        return self.bottleneck(z)

    def forward(self, commands_enc=None, args_enc=None, z=None,
                argmax_head: bool = False) -> dict:
        """Encode (unless ``z`` is given) and decode in one shot. Returns
        ``command_logits`` / ``args_logits`` or, with ``argmax_head``,
        ``command_ids`` / ``args_ids``, plus ``visibility_logits``."""
        if z is None:
            z = self.encode(commands_enc, args_enc)
        cmd, args, visibility_logits = self.decoder(z, argmax_head)
        if argmax_head:
            return {"command_ids": cmd, "args_ids": args,
                    "visibility_logits": visibility_logits}
        return {"command_logits": cmd, "args_logits": args,
                "visibility_logits": visibility_logits}
