"""The SVG Transformer, hierarchical and one-shot (batch-first): inference and
the training forward.

Counterpart of ``deepsvg_tpu/models/model.py`` for the flagship
``hierarchical_ordered`` path:

  E1 (per-path encoder) -> masked mean pool -> hierarchical PE -> E2 (over
  the path latents, visibility-masked) -> visibility-weighted pool -> ResNet
  -> linear bottleneck -> D2 (learned group queries, latent injected per
  layer) -> HierarchFCN (visibility + per-path latents) -> D1 (learned
  command queries) -> FCN heads.

``deterministic=False`` is the training forward: every layer runs the
differentiable kernel K4, the embedding K1 with K6 as its backward, dropout
sits where flax has it (embedding output, the two positional encodings, the
decoders' learned queries, the latent injection of each decoder layer, and
the four sites inside each layer), and with ``fused_ce`` the argument head's
cross-entropy comes straight from the decoder states through kernel K5.
Parameters are float32 and cast to ``cfg.compute_dtype`` at use
(``cast.py``).

The variants this port does not run yet raise ``NotImplementedError`` when
the model is built, naming the ``ROADMAP.md`` item that ports them.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops import ce as ce_ops
from ..ops import head as head_ops
from ..svgtensor import masks as M
from .cast import DropoutRng, Linear, cast_at_use
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
    """Four residual blocks ``z + relu(linear_i(z))`` (no dropout, as in flax)."""

    def __init__(self, d_model: int, compute_dtype=torch.float32):
        super().__init__()
        self.linears = nn.ModuleList(Linear(d_model, d_model, compute_dtype)
                                     for _ in range(4))

    def forward(self, z, deterministic: bool = True):
        for linear in self.linears:
            z = z + torch.relu(linear(z, deterministic))
        return z


class Bottleneck(nn.Module):
    """The flagship's plain linear bottleneck (``use_vae=False``)."""

    def __init__(self, d_model: int, dim_z: int, compute_dtype=torch.float32):
        super().__init__()
        self.bottleneck = Linear(d_model, dim_z, compute_dtype)

    def forward(self, z, deterministic: bool = True):
        return self.bottleneck(z, deterministic)


class FCN(nn.Module):
    """Command and argument heads.

    ``argmax=True`` returns first-index argmax ids through kernel K3
    (``ops/head.py``) without forming the argument logits; ``ce_targets``
    returns, in place of the argument logits, their per-token, per-slot
    cross-entropy through kernel K5 (``ops/ce.py``). K3 reads the heads in a
    padded per-slot layout (:attr:`w_packed`, :attr:`b_packed`), built from
    the heads in the compute dtype and rebuilt whenever a head changes.
    """

    def __init__(self, d_model: int, n_commands: int, n_args: int, args_dim: int,
                 compute_dtype=torch.float32):
        super().__init__()
        self.n_commands, self.n_args, self.args_dim = n_commands, n_args, args_dim
        self.compute_dtype = compute_dtype
        self.command_fcn = nn.Linear(d_model, n_commands)
        self.args_fcn = nn.Linear(d_model, n_args * args_dim)

    def _heads(self):
        return (self.command_fcn.weight, self.command_fcn.bias, self.args_fcn.weight,
                self.args_fcn.bias)

    def pack(self):
        """The padded per-slot copy of the heads (cached until a head changes)."""
        stamp = tuple((p._version, p.data_ptr()) for p in self._heads())
        hit = self.__dict__.get("_packed")
        if hit is None or hit[0] != stamp:
            with torch.no_grad():
                hit = (stamp, head_ops.pack_head(
                    *(p.detach().to(self.compute_dtype) for p in self._heads()), self.n_args))
            self.__dict__["_packed"] = hit
        return hit[1]

    w_packed = property(lambda self: self.pack()[0])
    b_packed = property(lambda self: self.pack()[1])

    def forward(self, out, argmax: bool = False, ce_targets=None,
                deterministic: bool = True):
        lead = out.shape[:-1]
        dt = self.compute_dtype
        if argmax:
            ids = head_ops.fused_head_argmax(
                out.reshape(-1, out.shape[-1]).contiguous(), self.w_packed,
                self.b_packed, self.n_commands, self.n_args, self.args_dim)
            return ids[:, 0].reshape(lead), ids[:, 1:].reshape(lead + (self.n_args,))
        wc, bc, wa, ba = (cast_at_use(self, str(i), p, dt, deterministic=deterministic)
                          for i, p in enumerate(self._heads()))
        cmd_logits = nn.functional.linear(out, wc, bc)
        if ce_targets is not None:
            return cmd_logits, ce_ops.args_ce(out, self.args_fcn.weight, self.args_fcn.bias,
                                              ce_targets, dt)
        args_logits = nn.functional.linear(out, wa, ba)
        return cmd_logits, args_logits.reshape(lead + (self.n_args, self.args_dim))


class HierarchFCN(nn.Module):
    """Per-group visibility logits and path latents."""

    def __init__(self, d_model: int, dim_z: int, compute_dtype=torch.float32):
        super().__init__()
        self.visibility_fcn = Linear(d_model, 2, compute_dtype)
        self.z_fcn = Linear(d_model, dim_z, compute_dtype)

    def forward(self, out, deterministic: bool = True):
        return self.visibility_fcn(out, deterministic), self.z_fcn(out, deterministic)


class Encoder(nn.Module):
    """Two-stage encoder: ``commands [N, G, S]``, ``args [N, G, S, n_args]``
    -> ``z [N, d_model]``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.d_model, getattr(torch, cfg.compute_dtype)
        self.compute_dtype = dt
        self.embedding = SVGEmbedding(cfg, cfg.max_seq_len)
        self.encoder = EncoderStack(cfg.n_layers, d, cfg.n_heads, cfg.dim_feedforward,
                                    cfg.dropout, dt)
        self.hierarchical_PE = PositionalEncodingLUT(cfg.max_num_groups, d, cfg.dropout, dt)
        self.hierarchical_encoder = EncoderStack(cfg.n_layers, d, cfg.n_heads,
                                                 cfg.dim_feedforward, cfg.dropout, dt)

    def forward(self, commands, args, deterministic: bool = True,
                rng: DropoutRng | None = None):
        n, g, s = commands.shape
        vis = M.visibility_mask(commands)                     # [N, G]
        commands_f = commands.reshape(n * g, s)
        args_f = args.reshape(n * g, s, args.shape[-1])
        pad = M.padding_mask(commands_f)                      # [N*G, S]
        key_pad = key_padding_to_additive(M.key_padding_mask(commands_f))

        src = self.embedding(commands_f, args_f, deterministic, rng)
        memory = self.encoder(src, key_pad, deterministic, rng)
        z = _masked_mean(memory, pad).reshape(n, g, -1)          # float32

        # the second stage keeps the float32 pooled latents as its activations
        src2 = self.hierarchical_PE(z, deterministic, rng)
        memory2 = self.hierarchical_encoder(src2, key_padding_to_additive(~vis),
                                            deterministic, rng)
        return _masked_mean(memory2, vis).to(self.compute_dtype)


class Decoder(nn.Module):
    """Two-stage one-shot decoder: ``z [N, dim_z]`` -> command and argument
    outputs ``[N, G, S+1, ...]`` and visibility logits ``[N, G, 2]``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.d_model, getattr(torch, cfg.compute_dtype)
        self.hierarchical_embedding = ConstEmbedding(cfg, cfg.n_groups_prop)
        self.hierarchical_decoder = DecoderStack(cfg.n_layers_decode, d, cfg.n_heads,
                                                 cfg.dim_feedforward, cfg.dim_z,
                                                 cfg.dropout, dt)
        self.hierarchical_fcn = HierarchFCN(d, cfg.dim_z, dt)
        self.embedding = ConstEmbedding(cfg, cfg.max_seq_len + 1)
        self.decoder = DecoderStack(cfg.n_layers_decode, d, cfg.n_heads,
                                    cfg.dim_feedforward, cfg.dim_z, cfg.dropout, dt)
        self.fcn = FCN(d, cfg.n_commands, cfg.n_args, cfg.args_dim_out, dt)

    def forward(self, z, argmax_head: bool = False, ce_targets=None,
                deterministic: bool = True, rng: DropoutRng | None = None):
        """``ce_targets [N, G, S+1, n_args]`` int (already ``tgt + 1``)."""
        n = z.shape[0]
        out = self.hierarchical_decoder(self.hierarchical_embedding(n, deterministic, rng),
                                        z, deterministic, rng)
        visibility_logits, z_groups = self.hierarchical_fcn(out, deterministic)  # [N, P, *]
        zb = z_groups.reshape(-1, z_groups.shape[-1])               # [N*P, dim_z]
        out = self.decoder(self.embedding(zb.shape[0], deterministic, rng), zb,
                           deterministic, rng)
        if ce_targets is not None:
            ce_targets = ce_targets.reshape((-1,) + ce_targets.shape[2:])
        cmd, args = self.fcn(out, argmax=argmax_head, ce_targets=ce_targets,
                             deterministic=deterministic)
        return cmd.reshape((n, -1) + cmd.shape[1:]), \
            args.reshape((n, -1) + args.shape[1:]), visibility_logits


class SVGTransformer(nn.Module):
    """The hierarchical one-shot SVG Transformer."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dt = getattr(torch, cfg.compute_dtype)
        self.encoder = Encoder(cfg)
        self.resnet = ResNet(cfg.d_model, dt) if cfg.use_resnet else None
        self.bottleneck = Bottleneck(cfg.d_model, cfg.dim_z, dt)
        self.decoder = Decoder(cfg)

    def encode(self, commands, args, deterministic: bool = True,
               rng: DropoutRng | None = None):
        """Input -> latent ``z [N, dim_z]``."""
        z = self.encoder(commands, args, deterministic, rng)
        if self.resnet is not None:
            z = self.resnet(z, deterministic)
        return self.bottleneck(z, deterministic)

    def forward(self, commands_enc=None, args_enc=None, commands_dec=None, args_dec=None,
                z=None, return_tgt: bool = False, deterministic: bool = True,
                argmax_head: bool = False, fused_ce: bool = False,
                rng: DropoutRng | None = None) -> dict:
        """Encode (unless ``z`` is given) and decode in one shot.

        Returns ``command_logits`` and ``args_logits`` (or, with
        ``argmax_head``, ``command_ids`` / ``args_ids``; or, with ``fused_ce``
        and ``return_tgt``, ``args_ce``: the argument cross-entropy against
        ``args_dec[..., 1:, :] + 1``), plus ``visibility_logits`` and, with
        ``return_tgt``, the targets ``tgt_commands`` / ``tgt_args``, which is
        what :func:`models.loss.svg_loss` reads. ``deterministic=False`` is
        the training forward; ``rng`` supplies its dropout (none: no dropout).
        """
        if z is None:
            z = self.encode(commands_enc, args_enc, deterministic, rng)
        use_fused_ce = fused_ce and return_tgt
        ce_targets = (args_dec[..., 1:, :] + 1).to(torch.int32) if use_fused_ce else None
        cmd, args, visibility_logits = self.decoder(z, argmax_head, ce_targets,
                                                    deterministic, rng)
        if argmax_head:
            res = {"command_ids": cmd, "args_ids": args}
        else:
            res = {"command_logits": cmd,
                   "args_ce" if use_fused_ce else "args_logits": args}
        res["visibility_logits"] = visibility_logits
        if return_tgt:
            res["tgt_commands"], res["tgt_args"] = commands_dec, args_dec
        return res
