"""The SVG Transformer (batch-first): inference and the training forward.

Counterpart of ``deepsvg_tpu/models/model.py`` for the two-stage one-shot
models (the flagship ``hierarchical_ordered``, the VAE ``hierarchical`` of
the icons config, and ``hierarchical_self_matching``) and the one-stage
autoregressive ``sketchformer``. The two-stage path:

  E1 (per-path encoder) -> masked mean pool -> hierarchical PE (not with
  self-match) -> E2 (over the path latents, visibility-masked) ->
  visibility-weighted pool -> ResNet -> linear bottleneck or VAE -> D2
  (learned group queries, latent injected per layer) -> HierarchFCN
  (visibility + per-path latents) -> D1 (learned command queries) -> FCN
  heads.

With ``self_match`` and targets, the proposals are matched to the target
paths (``matching.py``): with ``fused_ce`` the pairwise argument cost comes
from kernel K8 and the targets are permuted, otherwise the logits are.

``deterministic=False`` is the training forward: every layer runs the
differentiable kernel K4, the embedding K1 with K6 as its backward, dropout
sits where flax has it (embedding output, the two positional encodings, the
decoders' learned queries, the latent injection of each decoder layer, and
the four sites inside each layer), and with ``fused_ce`` the argument head's
cross-entropy comes straight from the decoder states through kernel K5.
Parameters are float32 and cast to ``cfg.compute_dtype`` at use
(``cast.py``).

The one-stage autoregressive models (Sketchformer: ``encode_stages=1``,
``pred_mode="autoregressive"``, ``rel_targets``) encode the whole icon as
one sequence with the group-index embedding and decode it token by token:
the teacher-forced forward runs the decoder causally over the shifted
targets, :meth:`SVGTransformer.decode_step` one token against the key/value
caches (``models/sample.py`` drives the greedy decode). The variants this
port does not run yet (labels, LSTM, one-stage one-shot decoding) raise
``NotImplementedError`` when the model is built, naming the ``ROADMAP.md``
item that ports them.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops import ce as ce_ops
from ..ops import head as head_ops
from ..svgtensor import masks as M
from . import matching
from .cast import DropoutRng, Linear, cast_at_use
from .config import ModelConfig
from .embeddings import ConstEmbedding, SVGEmbedding
from .layers import DecoderStack, EncoderStack, PositionalEncodingLUT, key_padding_to_additive

_UNSUPPORTED = (
    (lambda c: c.label_condition, "label conditioning"),
    (lambda c: c.model_type != "transformer", "the LSTM encoder and decoder"),
    (lambda c: c.encode_stages not in (1, 2), "decoding without an encoder"),
    (lambda c: c.pred_mode == "one_shot" and c.decode_stages != 2,
     "one-stage one-shot decoding"),
    (lambda c: c.pred_mode == "autoregressive" and c.decode_stages != 1,
     "two-stage autoregressive decoding"),
)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a variant outside the ported slice."""
    for test, what in _UNSUPPORTED:
        if test(cfg):
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP.md, queue 1, items 3-6)")


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


class VAE(nn.Module):
    """Gaussian reparametrised bottleneck: ``mu``, ``logsigma`` and, when
    sampling, ``z = mu + exp(logsigma / 2) * eps`` with ``eps`` drawn in the
    compute type from ``rng`` (:meth:`DropoutRng.normal`)."""

    def __init__(self, d_model: int, dim_z: int, compute_dtype=torch.float32):
        super().__init__()
        self.enc_mu_fcn = Linear(d_model, dim_z, compute_dtype)
        self.enc_sigma_fcn = Linear(d_model, dim_z, compute_dtype)

    def forward(self, z, sample: bool = True, deterministic: bool = True,
                rng: DropoutRng | None = None):
        mu = self.enc_mu_fcn(z, deterministic)
        logsigma = self.enc_sigma_fcn(z, deterministic)
        if not sample:
            return mu, mu, logsigma
        if rng is None:
            raise ValueError("the VAE samples its latent: pass an rng (DropoutRng), or "
                             "sample_vae=False")
        sigma = torch.exp(logsigma / 2.0)
        eps = rng.normal(sigma.shape, sigma.dtype, sigma.device)
        return mu + sigma * eps, mu, logsigma


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
                deterministic: bool = True, raw: bool = False):
        """``raw``: the command logits alone (the fused self-match reads the
        argument head through its kernels)."""
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
            return cmd_logits, self.args_ce(out, ce_targets)
        if raw:
            return cmd_logits, None
        args_logits = nn.functional.linear(out, wa, ba)
        return cmd_logits, args_logits.reshape(lead + (self.n_args, self.args_dim))

    def args_ce(self, out, targets):
        """The argument head's cross-entropy against ``targets`` through K5."""
        return ce_ops.args_ce(out, self.args_fcn.weight, self.args_fcn.bias, targets,
                              self.compute_dtype)


class HierarchFCN(nn.Module):
    """Per-group visibility logits and path latents."""

    def __init__(self, d_model: int, dim_z: int, compute_dtype=torch.float32):
        super().__init__()
        self.visibility_fcn = Linear(d_model, 2, compute_dtype)
        self.z_fcn = Linear(d_model, dim_z, compute_dtype)

    def forward(self, out, deterministic: bool = True):
        return self.visibility_fcn(out, deterministic), self.z_fcn(out, deterministic)


class Encoder(nn.Module):
    """E1 (+ E2) encoder: ``commands [N, G, S]``, ``args [N, G, S, n_args]``
    -> ``z [N, d_model]``.

    Two-stage: E1 over the N*G paths, masked mean pool, E2 over the path
    latents, visibility-weighted pool (``compute_dtype``). One-stage
    (``encode_stages == 1``, G = 1): E1 over the whole icon as one sequence
    with the group-index embedding, and its masked mean pool (float32), as
    the JAX package returns it."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.d_model, getattr(torch, cfg.compute_dtype)
        self.compute_dtype = dt
        self.two_stage = cfg.encode_stages == 2
        seq_len = cfg.max_seq_len if self.two_stage else cfg.max_total_len
        self.embedding = SVGEmbedding(cfg, seq_len, use_group=not self.two_stage)
        self.encoder = EncoderStack(cfg.n_layers, d, cfg.n_heads, cfg.dim_feedforward,
                                    cfg.dropout, dt)
        if self.two_stage:
            # self-match leaves the paths unordered: no position table over them
            self.hierarchical_PE = (None if cfg.self_match else
                                    PositionalEncodingLUT(cfg.max_num_groups, d, cfg.dropout,
                                                          dt))
            self.hierarchical_encoder = EncoderStack(cfg.n_layers, d, cfg.n_heads,
                                                     cfg.dim_feedforward, cfg.dropout, dt)

    def forward(self, commands, args, deterministic: bool = True,
                rng: DropoutRng | None = None):
        n, g, s = commands.shape
        commands_f = commands.reshape(n * g, s)
        args_f = args.reshape(n * g, s, args.shape[-1])
        pad = M.padding_mask(commands_f)                      # [N*G, S]
        key_pad = key_padding_to_additive(M.key_padding_mask(commands_f))
        groups = None if self.two_stage else M.group_mask(commands_f)

        src = self.embedding(commands_f, args_f, groups, deterministic, rng)
        memory = self.encoder(src, key_pad, deterministic, rng)
        z = _masked_mean(memory, pad).reshape(n, g, -1)          # float32
        if not self.two_stage:
            return z[:, 0]

        # the second stage keeps the float32 pooled latents as its activations
        vis = M.visibility_mask(commands)                     # [N, G]
        src2 = z if self.hierarchical_PE is None else self.hierarchical_PE(z, deterministic, rng)
        memory2 = self.hierarchical_encoder(src2, key_padding_to_additive(~vis),
                                            deterministic, rng)
        return _masked_mean(memory2, vis).to(self.compute_dtype)


class Decoder(nn.Module):
    """The decoder: ``z [N, dim_z]`` -> command and argument outputs.

    Two-stage one-shot: outputs ``[N, G, S+1, ...]`` and visibility logits
    ``[N, G, 2]``. One-stage autoregressive: the embedded target tokens
    ``commands [N, 1, S]``, ``args [N, 1, S, n_args]`` (relative arguments
    with ``rel_targets``) through the causal decoder stack, outputs
    ``[N, 1, S, ...]`` and no visibility logits."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.d_model, getattr(torch, cfg.compute_dtype)
        self.autoregressive = cfg.pred_mode == "autoregressive"
        if self.autoregressive:
            self.embedding = SVGEmbedding(cfg, cfg.max_total_len, rel_args=cfg.rel_targets,
                                          use_group=True, group_len=cfg.max_total_len)
        else:
            self.hierarchical_embedding = ConstEmbedding(cfg, cfg.n_groups_prop)
            self.hierarchical_decoder = DecoderStack(cfg.n_layers_decode, d, cfg.n_heads,
                                                     cfg.dim_feedforward, cfg.dim_z,
                                                     cfg.dropout, dt)
            self.hierarchical_fcn = HierarchFCN(d, cfg.dim_z, dt)
            self.embedding = ConstEmbedding(cfg, cfg.max_seq_len + 1)
        self.decoder = DecoderStack(cfg.n_layers_decode, d, cfg.n_heads,
                                    cfg.dim_feedforward, cfg.dim_z, cfg.dropout, dt)
        self.fcn = FCN(d, cfg.n_commands, cfg.n_args, cfg.args_dim_out, dt)

    def _autoregressive(self, z, commands, args, deterministic, rng):
        commands_f = commands.reshape(-1, commands.shape[-1])
        args_f = args.reshape(commands_f.shape + args.shape[-1:])
        src = self.embedding(commands_f, args_f, M.group_mask(commands_f), deterministic, rng)
        key_pad = key_padding_to_additive(M.key_padding_mask(commands_f))
        return self.decoder(src, z, deterministic, rng, key_pad, causal=True)

    def decode_step(self, z, cmd_t, args_t, groups_t, index: int, caches, key_pad):
        """One token per sequence at position ``index`` (``cmd_t [N]``,
        ``args_t [N, n_args]``, ``groups_t [N]`` its running moveto count)
        through the cached decoder stack (``caches``: per-layer ``(k, v)``
        ``[N, T, D]``, written at ``index``; ``key_pad [N, T]``) -> the
        logits for the next position, ``[N, n_commands]`` and
        ``[N, n_args, args_dim_out]``."""
        x = self.embedding.token(cmd_t, args_t, groups_t, index)
        return self.fcn(self.decoder.decode_step(x, z, caches, index, key_pad))

    def forward(self, z, argmax_head: bool = False, ce_targets=None,
                deterministic: bool = True, rng: DropoutRng | None = None,
                match_targets=None, commands=None, args=None):
        """``ce_targets [N, G, S+1, n_args]`` int (already ``tgt + 1``);
        ``commands``/``args``: the autoregressive decoder's input tokens.

        ``match_targets = (commands [N, G, S+1], args [N, G, S+1, n_args])``
        is the fused self-match: the proposals are matched to the targets
        (the pairwise argument cost through K8), the targets are permuted to
        the proposals' order (CE is elementwise in the pairing, so scoring
        the permuted targets equals permuting the logits), and the argument
        CE against them comes through K5. Returns the command logits, the
        argument CE, the visibility logits and the permuted targets."""
        n = z.shape[0]
        if self.autoregressive:
            out, visibility_logits = self._autoregressive(z, commands, args, deterministic,
                                                          rng), None
        else:
            out = self.hierarchical_decoder(
                self.hierarchical_embedding(n, deterministic, rng), z, deterministic, rng)
            visibility_logits, z_groups = self.hierarchical_fcn(out, deterministic)
            zb = z_groups.reshape(-1, z_groups.shape[-1])               # [N*P, dim_z]
            out = self.decoder(self.embedding(zb.shape[0], deterministic, rng), zb,
                               deterministic, rng)
        if match_targets is not None:
            tgt_c, tgt_a = match_targets
            fcn = self.fcn
            cmd_logits, _ = fcn(out, deterministic=deterministic, raw=True)
            cmd_logits = cmd_logits.reshape((n, -1) + cmd_logits.shape[1:])  # [N, P, S, C]
            assignment = matching.fused_perfect_matching(
                out.reshape((n, -1) + out.shape[1:]), fcn.args_fcn.weight, fcn.args_fcn.bias,
                cmd_logits, visibility_logits, tgt_c, tgt_a, self.cfg, fcn.compute_dtype)
            inv = torch.argsort(assignment, dim=1).long()                     # [N, P]
            tgt_c = torch.take_along_dim(tgt_c, inv[:, :, None], dim=1)
            tgt_a = torch.take_along_dim(tgt_a, inv[:, :, None, None], dim=1)
            ce_targets = (tgt_a[..., 1:, :] + 1).to(torch.int32)             # [N, P, S, n_args]
            ce = fcn.args_ce(out, ce_targets.reshape((-1,) + ce_targets.shape[2:]))
            return cmd_logits, ce.reshape((n, -1) + ce.shape[1:]), visibility_logits, \
                (tgt_c, tgt_a)
        if ce_targets is not None:
            ce_targets = ce_targets.reshape((-1,) + ce_targets.shape[2:])
        cmd, args = self.fcn(out, argmax=argmax_head, ce_targets=ce_targets,
                             deterministic=deterministic)
        return cmd.reshape((n, -1) + cmd.shape[1:]), \
            args.reshape((n, -1) + args.shape[1:]), visibility_logits


class SVGTransformer(nn.Module):
    """The SVG Transformer: hierarchical one-shot, or one-stage
    autoregressive."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dt = getattr(torch, cfg.compute_dtype)
        self.encoder = Encoder(cfg)
        self.resnet = ResNet(cfg.d_model, dt) if cfg.use_resnet else None
        if cfg.use_vae:
            self.vae = VAE(cfg.d_model, cfg.dim_z, dt)
        else:
            self.bottleneck = Bottleneck(cfg.d_model, cfg.dim_z, dt)
        self.decoder = Decoder(cfg)

    def decode_step(self, z, cmd_t, args_t, groups_t, index: int, caches, key_pad):
        """One KV-cached step of the autoregressive decoder: the token at
        ``index`` in, the logits for the next position out (see
        :meth:`Decoder.decode_step`)."""
        return self.decoder.decode_step(z, cmd_t, args_t, groups_t, index, caches, key_pad)

    def encode(self, commands, args, deterministic: bool = True,
               rng: DropoutRng | None = None, sample_vae: bool = True):
        """Input -> ``(z [N, dim_z], mu, logsigma)``; ``mu`` and ``logsigma``
        are None without the VAE. The VAE samples ``z`` from ``rng`` unless
        ``sample_vae`` is false (then ``z = mu``)."""
        z = self.encoder(commands, args, deterministic, rng)
        if self.resnet is not None:
            z = self.resnet(z, deterministic)
        if self.cfg.use_vae:
            return self.vae(z, sample_vae, deterministic, rng)
        return self.bottleneck(z, deterministic), None, None

    def forward(self, commands_enc=None, args_enc=None, commands_dec=None, args_dec=None,
                z=None, return_tgt: bool = False, deterministic: bool = True,
                argmax_head: bool = False, fused_ce: bool = False,
                rng: DropoutRng | None = None) -> dict:
        """Encode (unless ``z`` is given) and decode: in one shot, or, for
        the autoregressive decoder, teacher-forced on ``commands_dec`` /
        ``args_dec`` (without their last position when ``return_tgt``).

        Returns ``command_logits`` and ``args_logits`` (or, with
        ``argmax_head``, ``command_ids`` / ``args_ids``; or, with ``fused_ce``
        and ``return_tgt``, ``args_ce``: the argument cross-entropy against
        ``args_dec[..., 1:, :] + 1``), plus ``visibility_logits`` (two-stage
        decoders) and, with
        ``return_tgt``, the targets ``tgt_commands`` / ``tgt_args`` and, for
        the VAE, ``mu`` / ``logsigma``, which is what
        :func:`models.loss.svg_loss` reads. With ``self_match`` and
        ``return_tgt`` the proposals are matched to the targets: ``fused_ce``
        permutes the targets (and ``args_ce`` is against them), otherwise the
        logits are permuted. ``deterministic=False`` is the training forward;
        ``rng`` supplies its dropout (none: no dropout) and the VAE's noise.
        """
        mu = logsigma = None
        if z is None:
            z, mu, logsigma = self.encode(commands_enc, args_enc, deterministic, rng)
        use_fused_ce = fused_ce and return_tgt
        fused_match = use_fused_ce and self.cfg.self_match
        ce_targets = ((args_dec[..., 1:, :] + 1).to(torch.int32)
                      if use_fused_ce and not fused_match else None)
        dec_in = (None, None)
        if self.cfg.pred_mode == "autoregressive":
            # teacher forcing: the targets without their last position
            dec_in = ((commands_dec[..., :-1], args_dec[..., :-1, :]) if return_tgt
                      else (commands_dec, args_dec))
        out = self.decoder(z, argmax_head, ce_targets, deterministic, rng,
                           (commands_dec, args_dec) if fused_match else None, *dec_in)
        cmd, args, visibility_logits = out[:3]
        if fused_match:
            commands_dec, args_dec = out[3]
        elif return_tgt and self.cfg.self_match:
            assignment = matching.perfect_matching(cmd, args, visibility_logits, commands_dec,
                                                   args_dec, self.cfg)
            cmd, args, visibility_logits = matching.apply_assignment(
                assignment, cmd, args, visibility_logits)
        if argmax_head:
            res = {"command_ids": cmd, "args_ids": args}
        else:
            res = {"command_logits": cmd,
                   "args_ce" if use_fused_ce else "args_logits": args}
        if self.cfg.decode_stages == 2:
            res["visibility_logits"] = visibility_logits
        if return_tgt:
            res["tgt_commands"], res["tgt_args"] = commands_dec, args_dec
            if self.cfg.use_vae:
                res["mu"], res["logsigma"] = mu, logsigma
        return res
