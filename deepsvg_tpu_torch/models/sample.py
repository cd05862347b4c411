"""Sampling, counterpart of ``deepsvg_tpu/models/sample.py``.

One-shot: one forward, then the ids: greedy through the fused head+argmax
(kernel K3 on the card), or, given a ``torch.Generator``, drawn at a
temperature from the logits (:func:`sample_categorical`); then the
visibility threshold of a two-stage decoder, and :func:`make_valid`.

Autoregressive (Sketchformer): the decoder runs token by token over a
buffer of ``max_total_len + 1`` positions that starts with SOS. Each step
embeds the token at position ``i``, runs it through the decoder stack
against per-layer key/value caches, takes the command and arguments for
position ``i + 1`` (greedy, or drawn), applies :func:`make_valid`, and masks
the keys from the first generated EOS on. :func:`autoregressive_sample_fused`
runs the stack as kernel K9 and, greedy, the heads as K3 (one launch each
per step; with a generator the logits come from ``F.linear`` over K9's
output, as the JAX package computes them outside its kernels);
:func:`autoregressive_sample_cached` is the module path in plain PyTorch
operations, the JAX package's cached scan; :func:`autoregressive_sample`
re-runs the teacher-forced forward over the whole buffer at every step.
:func:`greedy_sample` takes the fused path for CUDA tensors and the cached
scan for CPU tensors (which is what the JAX package dispatches); neither
turns into the other. Relative targets are made absolute at the end.

What the JAX package's samplers cannot do, the port refuses with an error
(``models/model.py:check_sampler``): an autoregressive LSTM model
(SketchRNN) decodes through :func:`autoregressive_sample` alone, and a
two-stage autoregressive model is not sampled at all. The decode-only model
(``encode_stages=0``) decodes a given ``z``.

Without a generator every sampler is greedy (the JAX package's ``key=None``,
the limit T -> 0). With one, each command and each argument is a Gumbel-max
draw from ``softmax(logits / temperature)``, the commands of a position
before its arguments, all from that generator: JAX keys and PyTorch
generators cannot draw the same samples, so the two packages agree in
distribution, and at a small temperature in the greedy ids.

A VAE model samples its latent from a fixed generator, as the JAX package
does with ``key(0)``. A label-conditioned model takes ``label [N]``.
"""
from __future__ import annotations

import torch

from ..ops import decode as decode_ops
from ..ops import head as head_ops
from ..svgtensor.constants import CMD_EOS, CMD_M, CMD_SOS, PAD_VAL
from ..svgtensor.masks import cmd_args_mask, padding_mask
from ..svgtensor.tensor import make_absolute
from .cast import DropoutRng
from .config import ModelConfig
from .model import SVGTransformer, check_sampler


def sample_categorical(logits: torch.Tensor, temperature: float = 0.0001,
                       generator: torch.Generator | None = None) -> torch.Tensor:
    """A draw from ``softmax(logits / temperature)`` over the last axis, by
    Gumbel-max: the uniform noise comes from ``generator`` on its device and
    is moved to the logits'. Without a generator, the argmax (the limit
    T -> 0, as the JAX package's ``key=None``)."""
    if generator is None:
        return logits.argmax(dim=-1)
    u = torch.rand(logits.shape, generator=generator, device=generator.device)
    gumbel = -torch.log(-torch.log(u)).to(logits.device)     # u = 0 gives -inf
    return (logits.float() / temperature + gumbel).argmax(dim=-1)


def threshold_sample(logits: torch.Tensor, threshold: float = 0.5,
                     temperature: float = 1.0) -> torch.Tensor:
    """P(class 1) > threshold, the probability at ``temperature``."""
    return torch.softmax(logits.float() / temperature, dim=-1)[..., 1] > threshold


def make_valid(commands: torch.Tensor, args: torch.Tensor,
               visibility: torch.Tensor | None = None):
    """Set the arguments a command does not use to PAD; replace each
    invisible group by an empty path (a moveto, then EOS)."""
    if visibility is not None:
        s = commands.shape[-1]
        empty = torch.full((s,), CMD_EOS, dtype=commands.dtype, device=commands.device)
        empty[0] = CMD_M
        commands = torch.where(visibility[..., None], commands, empty)
        args = torch.where(visibility[..., None, None], args,
                           torch.full_like(args, float(PAD_VAL)))
    used = cmd_args_mask(commands.device, torch.bool)[commands.long()]
    return commands, torch.where(used, args, torch.full_like(args, float(PAD_VAL)))


def _finalize_args(cfg: ModelConfig, commands, args):
    """Undo the relative argument encoding (the decoded classes are deltas
    shifted by ``args_dim - 1``)."""
    if cfg.rel_targets:
        used = cmd_args_mask(commands.device, torch.bool)[commands.long()]
        args = make_absolute(commands, torch.where(used, args - (cfg.args_dim - 1), args))
    return commands, args


@torch.no_grad()
def one_shot_sample(model: SVGTransformer, commands_enc=None, args_enc=None,
                    z=None, label=None, temperature: float = 0.0001,
                    generator: torch.Generator | None = None,
                    visibility_threshold: float = 0.7):
    """One-shot decode of ``commands_enc [N, G, S]`` / ``args_enc [N, G, S,
    n_args]`` (or of a given latent ``z [N, dim_z]``), with ``label [N]``
    for a label-conditioned model: greedy through K3's fused argmax, or,
    with ``generator``, drawn at ``temperature`` from the logits.

    Returns ``commands [N, G, S_dec]`` int32 and ``args [N, G, S_dec, n_args]``
    float32 with PAD -1, on the model's device (G = 1, S_dec =
    ``max_total_len + 1`` for the one-stage model).
    """
    cfg = model.cfg
    # a VAE samples its latent from a fixed generator (the JAX package's key(0))
    rng = DropoutRng.fixed() if cfg.use_vae and z is None else None
    greedy = generator is None
    res = model(commands_enc, args_enc, label=label, z=z, argmax_head=greedy, rng=rng)
    if greedy:
        commands_y, args_y = res["command_ids"], res["args_ids"]
    else:
        commands_y = sample_categorical(res["command_logits"], temperature, generator)
        args_y = sample_categorical(res["args_logits"], temperature, generator)
    commands_y = commands_y.to(torch.int32)
    args_y = (args_y - 1).to(torch.float32)             # undo the PAD shift
    visibility_y = (threshold_sample(res["visibility_logits"], visibility_threshold)
                    if cfg.decode_stages == 2 else None)
    commands_y, args_y = make_valid(commands_y, args_y, visibility_y)
    return _finalize_args(cfg, commands_y, args_y)


def _decode(cfg: ModelConfig, n: int, device, step):
    """The autoregressive loop over ``max_total_len`` steps. ``step(cmd_t,
    args_t, groups_t, i, key_pad)`` embeds and decodes the tokens at
    position ``i`` and returns the ids for ``i + 1`` (greedy or drawn):
    commands ``[n]`` and argument classes ``[n, n_args]``. Returns
    ``commands [n, 1, L]`` int32 and ``args [n, 1, L, n_args]`` float32
    (PAD -1), without SOS, absolute."""
    length = cfg.max_total_len + 1
    cmds = torch.full((n, length), CMD_EOS, dtype=torch.int32, device=device)
    cmds[:, 0] = CMD_SOS
    args = torch.full((n, length, cfg.n_args), float(PAD_VAL), device=device)
    key_pad = torch.zeros((n, length), device=device)
    eos_seen = torch.zeros(n, dtype=torch.bool, device=device)
    groups = torch.zeros(n, dtype=torch.int32, device=device)
    for i in range(cfg.max_total_len):
        cmd_t = cmds[:, i]
        groups += cmd_t == CMD_M
        cmd_new, args_new = step(cmd_t, args[:, i], groups, i, key_pad)
        cmd_new = cmd_new.to(torch.int32)
        _, args_new = make_valid(cmd_new, args_new.to(torch.float32) - 1)  # undo the PAD shift
        eos_seen |= cmd_new == CMD_EOS
        key_pad[:, i + 1] = torch.where(eos_seen, float("-inf"), 0.0)
        cmds[:, i + 1] = cmd_new
        args[:, i + 1] = args_new
    return _finalize_args(cfg, cmds[:, None, 1:], args[:, None, 1:])


@torch.no_grad()
def autoregressive_sample_cached(model: SVGTransformer, z, label=None,
                                 temperature: float = 0.0001,
                                 generator: torch.Generator | None = None):
    """KV-cached decode of ``z [N, dim_z]`` (and ``label [N]``) through the
    module path (:meth:`SVGTransformer.decode_step`, plain PyTorch
    operations), greedy or, with ``generator``, drawn at ``temperature``: the
    counterpart of the JAX package's ``autoregressive_sample_cached``."""
    cfg = model.cfg
    check_sampler(cfg)
    n, dev = z.shape[0], z.device
    dt = getattr(torch, cfg.compute_dtype)
    shape = (n, cfg.max_total_len + 1, cfg.d_model)
    caches = [(torch.zeros(shape, dtype=dt, device=dev), torch.zeros(shape, dtype=dt, device=dev))
              for _ in range(cfg.n_layers_decode)]

    def step(cmd_t, args_t, groups_t, i, key_pad):
        cmd_logits, args_logits = model.decode_step(z, cmd_t, args_t, groups_t, i, caches,
                                                    key_pad, label)
        return (sample_categorical(cmd_logits, temperature, generator),
                sample_categorical(args_logits, temperature, generator))
    return _decode(cfg, n, dev, step)


def _decoder_stacks(model: SVGTransformer):
    """The autoregressive decoder's weights as kernel K9 reads them: each
    kind stacked over the layers (``nn.Linear`` layout) and the final
    LayerNorm ``[2, D]``, rounded to the compute type."""
    dec = model.decoder.decoder
    dt = getattr(torch, model.cfg.compute_dtype)
    stacks = [torch.stack(ws).contiguous()
              for ws in zip(*(layer.weights(dt) for layer in dec.layers))]
    lnf = torch.stack([dec.norm.weight, dec.norm.bias]).to(dt)
    return (*stacks, lnf)


@torch.no_grad()
def autoregressive_sample_fused(model: SVGTransformer, z, label=None,
                                temperature: float = 0.0001,
                                generator: torch.Generator | None = None):
    """Decode of ``z [N, dim_z]`` (and ``label [N]``) with the whole decoder
    stack of a step in one call of :func:`ops.decode.fused_decode_step`
    (kernel K9 on the card; each layer's ``seq_bias`` is the latent's
    injection plus the label's) and, greedy, the heads in one call of
    :func:`ops.head.fused_head_argmax` (K3); with ``generator``, the logits
    by ``F.linear`` over K9's output and a draw at ``temperature``. The
    token's embedding, the cache writes (one slice assignment for all
    layers), :func:`make_valid` and the key-padding update are plain
    PyTorch. On CPU tensors K9 and K3 are their plain versions."""
    cfg = model.cfg
    check_sampler(cfg)
    n, dev = z.shape[0], z.device
    dt = getattr(torch, cfg.compute_dtype)
    dec = model.decoder
    emb, fcn = dec.embedding, dec.fcn
    stacks = _decoder_stacks(model)
    label_emb = dec.label(label)
    seq_bias = torch.stack([
        layer.injection(z).to(dt) if label_emb is None
        else layer.injection(z).to(dt) + layer.label_injection(label_emb).to(dt)
        for layer in dec.decoder.layers])
    kcache = torch.zeros((cfg.n_layers_decode, n, cfg.max_total_len + 1, cfg.d_model),
                         dtype=dt, device=dev)
    vcache = torch.zeros_like(kcache)

    def step(cmd_t, args_t, groups_t, i, key_pad):
        x = emb.token(cmd_t, args_t, groups_t, i)
        y, k_new, v_new = decode_ops.fused_decode_step(x, seq_bias, *stacks, kcache, vcache,
                                                       key_pad, i, cfg.n_heads)
        kcache[:, :, i] = k_new
        vcache[:, :, i] = v_new
        if generator is None:
            ids = head_ops.fused_head_argmax(y, fcn.w_packed, fcn.b_packed, cfg.n_commands,
                                             cfg.n_args, cfg.args_dim_out)
            return ids[:, 0], ids[:, 1:]
        cmd_logits, args_logits = fcn(y)
        return (sample_categorical(cmd_logits, temperature, generator),
                sample_categorical(args_logits, temperature, generator))
    return _decode(cfg, n, dev, step)


@torch.no_grad()
def autoregressive_sample(model: SVGTransformer, z, label=None, temperature: float = 0.0001,
                          generator: torch.Generator | None = None):
    """Decode that re-runs the teacher-forced forward (causal, over the
    whole buffer) at every step and reads the logits at the current
    position, greedy or drawn: the JAX package's ``autoregressive_sample``,
    the oracle of the cached decodes, and the one sampler of an LSTM model
    (each step re-runs its LSTM over the whole buffer)."""
    cfg = model.cfg
    check_sampler(cfg, cached=False)
    n, dev = z.shape[0], z.device
    length = cfg.max_total_len + 1
    cmds = torch.full((n, 1, length), CMD_EOS, dtype=torch.int32, device=dev)
    cmds[..., 0] = CMD_SOS
    args = torch.full((n, 1, length, cfg.n_args), float(PAD_VAL), device=dev)
    for i in range(cfg.max_total_len):
        res = model(commands_dec=cmds, args_dec=args, label=label, z=z)
        cmd_new = sample_categorical(res["command_logits"][:, :, i], temperature,
                                     generator).to(torch.int32)
        args_new = sample_categorical(res["args_logits"][:, :, i], temperature,
                                      generator).to(torch.float32) - 1
        _, args_new = make_valid(cmd_new, args_new)
        cmds[:, :, i + 1] = cmd_new
        args[:, :, i + 1] = args_new
    return _finalize_args(cfg, cmds[..., 1:], args[..., 1:, :])


@torch.no_grad()
def greedy_sample(model: SVGTransformer, commands_enc=None, args_enc=None, z=None,
                  label=None, temperature: float = 0.0001,
                  generator: torch.Generator | None = None):
    """Decode of the encoded inputs (or of a given ``z``), with ``label [N]``
    for a label-conditioned model; greedy, or with ``generator`` drawn at
    ``temperature``: one-shot models through :func:`one_shot_sample`;
    autoregressive models encode (the VAE's noise from the fixed generator)
    and decode with :func:`autoregressive_sample_fused` on CUDA tensors
    (kernels K9, and K3 when greedy), and with
    :func:`autoregressive_sample_cached` on CPU tensors. An autoregressive
    LSTM or two-stage model raises, as the JAX package's fails."""
    cfg = model.cfg
    if cfg.pred_mode == "one_shot":
        return one_shot_sample(model, commands_enc, args_enc, z, label, temperature, generator)
    check_sampler(cfg)
    if z is None:
        rng = DropoutRng.fixed() if cfg.use_vae else None
        z, _, _ = model.encode(commands_enc, args_enc, label, rng=rng)
    decode = autoregressive_sample_fused if z.device.type == "cuda" else \
        autoregressive_sample_cached
    return decode(model, z, label, temperature, generator)


def flatten_groups_np(commands, args):
    """Host-side ragged flattening of a decode: per sample, the positions
    before each group's first EOS, the groups concatenated. A list of
    numpy ``(commands, args)`` pairs."""
    commands = torch.as_tensor(commands).cpu()
    pad = padding_mask(commands).bool().numpy()
    commands, args = commands.numpy(), torch.as_tensor(args).cpu().numpy()
    return [(commands[i][pad[i]], args[i][pad[i]]) for i in range(commands.shape[0])]
