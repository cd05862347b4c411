"""The SVG Transformer (batch-first): inference and the training forward.

Counterpart of ``deepsvg_tpu/models/model.py`` for every variant it builds:
the two-stage one-shot models (the flagship ``hierarchical_ordered``, the
VAE ``hierarchical`` of the icons config, ``hierarchical_self_matching``,
and the fonts config's label-conditioned ``hierarchical``), the one-stage
one-shot model (``one_stage_one_shot``), the one-stage autoregressive
``sketchformer`` and ``sketchrnn``, two-stage autoregressive decoding and
the decode-only model. The two-stage path:

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

The one-stage models (``encode_stages=1``) encode the whole icon as one
sequence with the group-index embedding. The one-stage one-shot decoder
(``decode_stages=1``) runs one stack over ``max_total_len + 1`` constant
queries with the latent injected in every layer (the long forms of the
layer kernels at S = 241), and has no visibility head. The autoregressive
models (Sketchformer: ``pred_mode="autoregressive"``, ``rel_targets``)
decode token by token: the teacher-forced forward runs the decoder causally
over the shifted targets, :meth:`SVGTransformer.decode_step` one token
against the key/value caches (``models/sample.py`` drives the decode).

With ``label_condition`` the encoder and the decoder each have a label
embedding (``embeddings.LabelEmbedding``), injected into every layer by its
``glob2`` (``layers.py``): per path in E1 and D1, per sample in E2 and D2.

The LSTM variants (``model_type="lstm"``, SketchRNN: ``config.sketchrnn()``)
replace E1 by a bidirectional LSTM read at the last valid token
(:class:`LSTMEncoder`) and, when autoregressive, D1 by an LSTM whose initial
state comes from the latent (:class:`LSTMDecoder`). The cells are flax's
``OptimizedLSTMCell`` in plain PyTorch operations (no kernel backs them in
the JAX package either) and compute in float32 whatever ``compute_dtype``
says, as flax promotes their bfloat16 inputs to the float32 parameters. The
JAX package's LSTM decoder fails in bfloat16 (its scan's carry changes
type), so an autoregressive LSTM model refuses any other ``compute_dtype``.

Two-stage autoregressive decoding runs D2 and the visibility and path-latent
heads, then D1 causally over the N x G paths' shifted targets with each
path's latent injected (``num_groups_proposal`` must equal
``max_num_groups``, as the JAX package's fold assumes). The decode-only
model (``encode_stages=0``) has a decoder alone and decodes a given ``z``.

What the JAX package cannot do, the port refuses with an error that says
why: a cached decode step of an LSTM model, and (``models/sample.py``) the
cached samplers of an LSTM model and every sampler of a two-stage
autoregressive model; the decode-only model cannot be trained
(``training/trainer.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import ce as ce_ops
from ..ops import head as head_ops
from ..svgtensor import masks as M
from . import matching
from .cast import DropoutRng, Linear, cast_at_use
from .config import ModelConfig
from .embeddings import ConstEmbedding, LabelEmbedding, SVGEmbedding
from .layers import DecoderStack, EncoderStack, PositionalEncodingLUT, key_padding_to_additive

def check_config(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a configuration the model cannot be built
    from: unknown stages or types, a two-stage autoregressive decoder with
    ``num_groups_proposal`` unlike ``max_num_groups``, or an autoregressive
    LSTM decoder in another type than float32."""
    if cfg.encode_stages not in (0, 1, 2) or cfg.decode_stages not in (1, 2):
        raise ValueError(f"encode_stages must be 0, 1 or 2 and decode_stages 1 or 2, not "
                         f"{cfg.encode_stages} and {cfg.decode_stages}")
    if cfg.model_type not in ("transformer", "lstm"):
        raise ValueError(f"unknown model_type {cfg.model_type!r}")
    if cfg.pred_mode not in ("one_shot", "autoregressive"):
        raise ValueError(f"unknown pred_mode {cfg.pred_mode!r}")
    autoregressive = cfg.pred_mode == "autoregressive"
    if autoregressive and cfg.decode_stages == 2 and cfg.n_groups_prop != cfg.max_num_groups:
        raise ValueError(
            f"two-stage autoregressive decoding decodes one proposal per target path: "
            f"num_groups_proposal ({cfg.n_groups_prop}) must equal max_num_groups "
            f"({cfg.max_num_groups})")
    if autoregressive and cfg.model_type == "lstm" and cfg.compute_dtype != "float32":
        raise ValueError(
            f"the autoregressive LSTM decoder runs in float32 only: its cells compute in "
            f"float32, and the JAX package's fails with compute_dtype "
            f"{cfg.compute_dtype!r} (its scan's carry changes type); set compute_dtype "
            f"'float32'")


def check_sampler(cfg: ModelConfig, cached: bool = True) -> None:
    """Raise ``ValueError`` where the JAX package's token-by-token samplers
    fail: every sampler of a two-stage autoregressive model (a shape error
    where the paths are folded) and, ``cached``, the KV-cached ones of an
    LSTM model (its cached step is a transformer stack, whose parameters the
    model lacks). They are faults of the reference, reproduced as errors,
    not repaired."""
    if cfg.pred_mode != "autoregressive":
        return
    if cfg.decode_stages == 2:
        raise ValueError("a two-stage autoregressive model cannot be sampled: the JAX "
                         "package's samplers fail on it (a shape error where the paths are "
                         "folded); its teacher-forced forward and training run")
    if cached and cfg.model_type == "lstm":
        raise ValueError("an LSTM model has no KV-cached decode step (the JAX package's "
                         "is a transformer's and fails on it): decode with "
                         "autoregressive_sample, which re-runs the forward at every step")


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
            if not torch.compiler.is_compiling():        # kept as cast_at_use keeps
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


class LSTMCell(nn.Module):
    """flax's ``OptimizedLSTMCell`` in float32: input kernels ``ii``,
    ``if``, ``ig``, ``io`` without bias and hidden kernels ``hi``, ``hf``,
    ``hg``, ``ho`` with one, gates in the order i, f, g, o; ``c' = f c + i
    g`` and ``h' = o tanh(c')`` with sigmoid gates and a tanh candidate."""

    GATES = ("i", "f", "g", "o")

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.features = features
        self.inputs = nn.ModuleDict({f"i{g}": nn.Linear(in_features, features, bias=False)
                                     for g in self.GATES})
        self.hidden = nn.ModuleDict({f"h{g}": nn.Linear(features, features)
                                     for g in self.GATES})

    def weights(self):
        """The gates' kernels side by side: input ``[4H, in]``, hidden
        ``[4H, H]`` and its bias ``[4H]``."""
        return (torch.cat([self.inputs[f"i{g}"].weight for g in self.GATES]),
                torch.cat([self.hidden[f"h{g}"].weight for g in self.GATES]),
                torch.cat([self.hidden[f"h{g}"].bias for g in self.GATES]))

    @staticmethod
    def step(x_gates, c, h, w_h, b_h):
        """One step from the input side's gates ``x_gates [B, 4H]`` and the
        carry ``(c, h)``; the hidden side's gates are added to the input
        side's, as flax sums them."""
        gates = F.linear(h, w_h, b_h) + x_gates
        i, f, _, o = torch.sigmoid(gates).chunk(4, dim=-1)
        g = torch.tanh(gates[..., 2 * h.shape[-1]:3 * h.shape[-1]])
        c = f * c + i * g
        return c, o * torch.tanh(c)

    def scan(self, x, c, h):
        """The cell over ``x [B, S, in]`` from the carry ``(c, h)``: one
        product for the input side of all steps, then a loop over the steps.
        Returns the outputs ``[B, S, H]``."""
        w_i, w_h, b_h = self.weights()
        x_gates = F.linear(x, w_i)
        outs = []
        for t in range(x.shape[1]):
            c, h = self.step(x_gates[:, t], c, h, w_h, b_h)
            outs.append(h)
        return torch.stack(outs, dim=1)


class LSTMEncoder(nn.Module):
    """The bidirectional LSTM in E1's place (``d_model / 2`` features a
    direction, flax ``OptimizedLSTMCell_0`` forward and ``_1`` backward),
    read at the last valid token ``len - 1`` (``len = seq_lens``, position 0
    when it is 0): the concatenated directions, float32.

    The JAX package's backward direction reverses each sequence within its
    valid length, so its output at ``len - 1`` is one cell step on that token
    from a zero carry, which is all that is computed here; a sequence of
    length 0 is reversed whole, and its output at position 0 is the last of
    a run over all of it. (A bidirectional ``nn.LSTM`` or packed sequences
    would read the backward state after the whole sequence instead.)"""

    def __init__(self, d_model: int):
        super().__init__()
        self.cells = nn.ModuleList([LSTMCell(d_model, d_model // 2),
                                    LSTMCell(d_model, d_model // 2)])

    def forward(self, src, seq_lens):
        x = src.float()
        b = x.shape[0]
        fwd, bwd = self.cells
        zeros = x.new_zeros(b, fwd.features)
        last = (seq_lens.long() - 1).clamp_min(0)
        rows = torch.arange(b, device=x.device)
        out_f = fwd.scan(x, zeros, zeros)[rows, last]
        w_i, w_h, b_h = bwd.weights()
        _, out_b = bwd.step(F.linear(x[rows, last], w_i), zeros, zeros, w_h, b_h)
        empty = seq_lens == 0
        if bool(empty.any()):
            out_b = out_b.clone()
            z_e = zeros[empty]
            out_b[empty] = bwd.scan(x[empty].flip(1), z_e, z_e)[:, -1]
        return torch.cat([out_f, out_b], dim=-1)


class LSTMDecoder(nn.Module):
    """The autoregressive LSTM decoder: its initial state from the latent,
    ``h, c = split(tanh(fc_hc(z)), 2)`` (``fc_hc`` in the compute type, h
    the first half), then one cell of ``d_model`` features over the embedded
    targets, teacher-forced. Returns ``[B, S, d_model]`` float32."""

    def __init__(self, d_model: int, dim_z: int, compute_dtype=torch.float32):
        super().__init__()
        self.fc_hc = Linear(dim_z, 2 * d_model, compute_dtype)
        self.cell = LSTMCell(d_model, d_model)

    def forward(self, src, z, deterministic: bool = True):
        h, c = torch.tanh(self.fc_hc(z, deterministic)).float().chunk(2, dim=-1)
        return self.cell.scan(src.float(), c, h)


class Encoder(nn.Module):
    """E1 (+ E2) encoder: ``commands [N, G, S]``, ``args [N, G, S, n_args]``
    -> ``z [N, d_model]``.

    Two-stage: E1 over the N*G paths, masked mean pool, E2 over the path
    latents, visibility-weighted pool (``compute_dtype``). One-stage
    (``encode_stages == 1``, G = 1): E1 over the whole icon as one sequence
    with the group-index embedding, and its masked mean pool (float32), as
    the JAX package returns it. With ``label_condition``, ``label [N]``'s
    embedding is injected into every layer: E1 per path, E2 per sample. The
    LSTM variants run :class:`LSTMEncoder` in E1's place (float32, read at
    each sequence's last valid token, no pooling)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.d_model, getattr(torch, cfg.compute_dtype)
        self.compute_dtype = dt
        self.two_stage = cfg.encode_stages == 2
        dim_label = cfg.dim_label if cfg.label_condition else None
        self.label_embedding = LabelEmbedding(cfg) if cfg.label_condition else None
        seq_len = cfg.max_seq_len if self.two_stage else cfg.max_total_len
        self.embedding = SVGEmbedding(cfg, seq_len, use_group=not self.two_stage)
        self.lstm = cfg.model_type == "lstm"
        self.encoder = (LSTMEncoder(d) if self.lstm else
                        EncoderStack(cfg.n_layers, d, cfg.n_heads, cfg.dim_feedforward,
                                     cfg.dropout, dt, dim_label))
        if self.two_stage:
            # self-match leaves the paths unordered: no position table over them
            self.hierarchical_PE = (None if cfg.self_match else
                                    PositionalEncodingLUT(cfg.max_num_groups, d, cfg.dropout,
                                                          dt))
            self.hierarchical_encoder = EncoderStack(cfg.n_layers, d, cfg.n_heads,
                                                     cfg.dim_feedforward, cfg.dropout, dt,
                                                     dim_label)

    def forward(self, commands, args, label=None, deterministic: bool = True,
                rng: DropoutRng | None = None):
        n, g, s = commands.shape
        label_emb = (self.label_embedding(label, deterministic)
                     if self.label_embedding is not None else None)
        commands_f = commands.reshape(n * g, s)
        args_f = args.reshape(n * g, s, args.shape[-1])
        pad = M.padding_mask(commands_f)                      # [N*G, S]
        key_pad = key_padding_to_additive(M.key_padding_mask(commands_f))
        groups = None if self.two_stage else M.group_mask(commands_f)

        src = self.embedding(commands_f, args_f, groups, deterministic, rng)
        if self.lstm:
            z = self.encoder(src, pad.sum(dim=1).to(torch.int32))      # float32
        else:
            l1 = None if label_emb is None else label_emb.repeat_interleave(g, dim=0)
            memory = self.encoder(src, key_pad, deterministic, rng, l1)
            z = _masked_mean(memory, pad)                               # float32
        z = z.reshape(n, g, -1)
        if not self.two_stage:
            return z[:, 0]

        # the second stage keeps the float32 pooled latents as its activations
        vis = M.visibility_mask(commands)                     # [N, G]
        src2 = z if self.hierarchical_PE is None else self.hierarchical_PE(z, deterministic, rng)
        memory2 = self.hierarchical_encoder(src2, key_padding_to_additive(~vis),
                                            deterministic, rng, label_emb)
        return _masked_mean(memory2, vis).to(self.compute_dtype)


class Decoder(nn.Module):
    """The decoder: ``z [N, dim_z]`` -> command and argument outputs.

    Two-stage one-shot: outputs ``[N, G, S+1, ...]`` and visibility logits
    ``[N, G, 2]``. One-stage one-shot: one stack over ``max_total_len + 1``
    constant queries with ``z`` injected, outputs ``[N, 1, max_total_len + 1,
    ...]`` and no visibility logits (no ``hierarchical_*`` modules).
    One-stage autoregressive: the embedded target tokens ``commands [N, 1,
    S]``, ``args [N, 1, S, n_args]`` (relative arguments with
    ``rel_targets``) through the causal decoder stack, outputs ``[N, 1, S,
    ...]`` and no visibility logits. With ``label_condition``, the decoder's
    own label embedding is injected into every layer beside ``z``.

    Two-stage autoregressive: D2 and the heads, then the targets ``[N, G, S]``
    through the causal decoder, path by path, each with its latent from
    HierarchFCN; outputs ``[N, G, S, ...]`` and visibility logits. The
    autoregressive LSTM decoder (:class:`LSTMDecoder`) takes the place of the
    causal stack; its outputs are float32."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.d_model, getattr(torch, cfg.compute_dtype)
        self.autoregressive = cfg.pred_mode == "autoregressive"
        self.two_stage = cfg.decode_stages == 2
        dim_label = cfg.dim_label if cfg.label_condition else None
        self.label_embedding = LabelEmbedding(cfg) if cfg.label_condition else None
        if self.two_stage:
            self.hierarchical_embedding = ConstEmbedding(cfg, cfg.n_groups_prop)
            self.hierarchical_decoder = DecoderStack(cfg.n_layers_decode, d, cfg.n_heads,
                                                     cfg.dim_feedforward, cfg.dim_z,
                                                     cfg.dropout, dt, dim_label)
            self.hierarchical_fcn = HierarchFCN(d, cfg.dim_z, dt)
        if self.autoregressive:
            self.embedding = SVGEmbedding(cfg, cfg.max_total_len, rel_args=cfg.rel_targets,
                                          use_group=True, group_len=cfg.max_total_len)
        else:
            self.embedding = ConstEmbedding(cfg, cfg.max_seq_len + 1 if self.two_stage
                                            else cfg.max_total_len + 1)
        self.lstm = self.autoregressive and cfg.model_type == "lstm"
        self.decoder = (LSTMDecoder(d, cfg.dim_z, dt) if self.lstm else
                        DecoderStack(cfg.n_layers_decode, d, cfg.n_heads, cfg.dim_feedforward,
                                     cfg.dim_z, cfg.dropout, dt, dim_label))
        self.fcn = FCN(d, cfg.n_commands, cfg.n_args, cfg.args_dim_out, dt)

    def label(self, label, deterministic: bool = True):
        """``label [N]``'s embedding ``[N, dim_label]``, or None without labels."""
        if self.label_embedding is None:
            return None
        return self.label_embedding(label, deterministic)

    def _autoregressive(self, z, commands, args, deterministic, rng, label_emb):
        commands_f = commands.reshape(-1, commands.shape[-1])
        args_f = args.reshape(commands_f.shape + args.shape[-1:])
        src = self.embedding(commands_f, args_f, M.group_mask(commands_f), deterministic, rng)
        if self.lstm:
            return self.decoder(src, z, deterministic)
        key_pad = key_padding_to_additive(M.key_padding_mask(commands_f))
        return self.decoder(src, z, deterministic, rng, key_pad, causal=True,
                            label_emb=label_emb)

    def decode_step(self, z, cmd_t, args_t, groups_t, index: int, caches, key_pad,
                    label=None):
        """One token per sequence at position ``index`` (``cmd_t [N]``,
        ``args_t [N, n_args]``, ``groups_t [N]`` its running moveto count)
        through the cached decoder stack (``caches``: per-layer ``(k, v)``
        ``[N, T, D]``, written at ``index``; ``key_pad [N, T]``; ``label
        [N]`` for a label-conditioned model) -> the logits for the next
        position, ``[N, n_commands]`` and ``[N, n_args, args_dim_out]``."""
        check_sampler(self.cfg)
        x = self.embedding.token(cmd_t, args_t, groups_t, index)
        return self.fcn(self.decoder.decode_step(x, z, caches, index, key_pad,
                                                 self.label(label)))

    def forward(self, z, argmax_head: bool = False, ce_targets=None,
                deterministic: bool = True, rng: DropoutRng | None = None,
                match_targets=None, commands=None, args=None, label=None):
        """``ce_targets [N, G, S+1, n_args]`` int (already ``tgt + 1``);
        ``commands``/``args``: the autoregressive decoder's input tokens;
        ``label [N]``: the class labels of a label-conditioned model.

        ``match_targets = (commands [N, G, S+1], args [N, G, S+1, n_args])``
        is the fused self-match: the proposals are matched to the targets
        (the pairwise argument cost through K8), the targets are permuted to
        the proposals' order (CE is elementwise in the pairing, so scoring
        the permuted targets equals permuting the logits), and the argument
        CE against them comes through K5. Returns the command logits, the
        argument CE, the visibility logits and the permuted targets."""
        n = z.shape[0]
        label_emb = self.label(label, deterministic)
        visibility_logits, zb = None, z
        if self.two_stage:
            out = self.hierarchical_decoder(
                self.hierarchical_embedding(n, deterministic, rng), z, deterministic, rng,
                label_emb=label_emb)
            visibility_logits, z_groups = self.hierarchical_fcn(out, deterministic)
            zb = z_groups.reshape(-1, z_groups.shape[-1])               # [N*P, dim_z]
        # the label per sequence of the last stack
        lb = (None if label_emb is None
              else label_emb.repeat_interleave(zb.shape[0] // n, dim=0))
        if self.autoregressive:
            out = self._autoregressive(zb, commands, args, deterministic, rng, lb)
        else:
            out = self.decoder(self.embedding(zb.shape[0], deterministic, rng), zb,
                               deterministic, rng, label_emb=lb)
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
    """The SVG Transformer: one or two stages to encode (or none: the
    decode-only model, ``encode_stages=0``, which has no encoder, ResNet or
    bottleneck and decodes a given ``z``) and to decode, one-shot or
    autoregressive, transformer or LSTM; label-conditioned with
    ``label_condition``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        check_config(cfg)
        self.cfg = cfg
        dt = getattr(torch, cfg.compute_dtype)
        self.encoder = self.resnet = None
        if cfg.encode_stages > 0:
            self.encoder = Encoder(cfg)
            self.resnet = ResNet(cfg.d_model, dt) if cfg.use_resnet else None
            if cfg.use_vae:
                self.vae = VAE(cfg.d_model, cfg.dim_z, dt)
            else:
                self.bottleneck = Bottleneck(cfg.d_model, cfg.dim_z, dt)
        self.decoder = Decoder(cfg)

    def decode_step(self, z, cmd_t, args_t, groups_t, index: int, caches, key_pad,
                    label=None):
        """One KV-cached step of the autoregressive decoder: the token at
        ``index`` in, the logits for the next position out (see
        :meth:`Decoder.decode_step`)."""
        return self.decoder.decode_step(z, cmd_t, args_t, groups_t, index, caches, key_pad,
                                        label)

    def encode(self, commands, args, label=None, deterministic: bool = True,
               rng: DropoutRng | None = None, sample_vae: bool = True):
        """Input (and ``label [N]`` for a label-conditioned model) -> ``(z
        [N, dim_z], mu, logsigma)``; ``mu`` and ``logsigma`` are None without
        the VAE. The VAE samples ``z`` from ``rng`` unless ``sample_vae`` is
        false (then ``z = mu``)."""
        if self.encoder is None:
            raise ValueError("the decode-only model (encode_stages=0) has no encoder: pass "
                             "the latent z to decode")
        z = self.encoder(commands, args, label, deterministic, rng)
        if self.resnet is not None:
            z = self.resnet(z, deterministic)
        if self.cfg.use_vae:
            return self.vae(z, sample_vae, deterministic, rng)
        return self.bottleneck(z, deterministic), None, None

    def forward(self, commands_enc=None, args_enc=None, commands_dec=None, args_dec=None,
                label=None, z=None, return_tgt: bool = False, deterministic: bool = True,
                argmax_head: bool = False, fused_ce: bool = False,
                rng: DropoutRng | None = None) -> dict:
        """Encode (unless ``z`` is given) and decode: in one shot, or, for
        the autoregressive decoder, teacher-forced on ``commands_dec`` /
        ``args_dec`` (without their last position when ``return_tgt``).
        ``label [N]``: the class labels of a label-conditioned model (its
        encoder's and its decoder's; the fifth argument, as the dataset keys
        of ``ModelConfig.get_model_args`` list it).

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
            z, mu, logsigma = self.encode(commands_enc, args_enc, label, deterministic, rng)
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
                           (commands_dec, args_dec) if fused_match else None, *dec_in,
                           label=label)
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
