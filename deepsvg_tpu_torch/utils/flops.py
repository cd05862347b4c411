"""Analytic model-FLOPs accounting for MFU reporting, counterpart of
``deepsvg_tpu/utils/flops.py``.

Counts matmul MACs only (the standard MFU convention: elementwise and
softmax work is not counted), 2 FLOPs per MAC. Gathers (embedding lookups,
positional tables) are bandwidth, not FLOPs, and are excluded.

The architecture counted is the port's ``SVGTransformer``
(``models/model.py``): E1 per-group encoder -> E2 group encoder -> ResNet ->
bottleneck -> D2 group decoder (+ HierarchFCN) -> D1 per-group decoder ->
FCN heads. The peak rates are the H100's (NVIDIA's data sheet, SXM part,
dense): the tensor cores' bfloat16 rate, and their TF32 rate, which the
float32 kernels multiply at.
"""
from __future__ import annotations

from ..models.config import ModelConfig


def _layer_macs(tokens: int, attn_len: int, d: int, dff: int,
                dz_inject: int = 0, label_inject: int = 0) -> int:
    """MACs of one transformer layer over ``tokens`` positions attending over
    ``attn_len`` keys: QKV and out projections (4 d^2), score and value
    products (2 attn_len d), feed-forward (2 d dff), plus the per-layer
    latent and label injections of the 'improved' blocks."""
    per_token = 4 * d * d + 2 * attn_len * d + 2 * d * dff
    per_token += dz_inject * d + label_inject * d
    return tokens * per_token


def flops_per_sample(cfg: ModelConfig, decode: bool = True, encode: bool = True) -> int:
    """Forward-pass FLOPs for ONE sample of the model at the config's
    sequence budget. For a training step multiply by 3 (forward and about
    twice that backward)."""
    d, dff, dz = cfg.d_model, cfg.dim_feedforward, cfg.dim_z
    g, s = cfg.max_num_groups, cfg.max_seq_len
    lab = cfg.dim_label if cfg.label_condition else 0
    n_arg_embed = cfg.n_args * 64  # the argument embedding's projection input width

    macs = 0
    if encode:
        if cfg.encode_stages == 2:
            s1 = s + 2                       # a group's sequence with SOS and EOS
            t1 = g * s1
            macs += t1 * n_arg_embed * d     # the embedding's projection
            macs += cfg.n_layers * _layer_macs(t1, s1, d, dff, label_inject=lab)
            macs += cfg.n_layers * _layer_macs(g, g, d, dff, label_inject=lab)
        else:
            s1 = cfg.max_total_len + 2
            macs += s1 * n_arg_embed * d
            macs += cfg.n_layers * _layer_macs(s1, s1, d, dff, label_inject=lab)
        if cfg.use_resnet:
            macs += 4 * d * d
        macs += d * dz * (2 if cfg.use_vae else 1)   # the VAE's mu and sigma, or the bottleneck

    if decode:
        p = cfg.n_groups_prop
        if cfg.decode_stages == 2:
            macs += cfg.n_layers_decode * _layer_macs(
                p, p, d, dff, dz_inject=dz, label_inject=lab)
            macs += p * (d * 2 + d * dz)             # the HierarchFCN heads
            s_out = s + 1
            t_out = p * s_out
            macs += cfg.n_layers_decode * _layer_macs(
                t_out, s_out, d, dff, dz_inject=dz, label_inject=lab)
        else:
            s_out = cfg.max_total_len + 1
            t_out = s_out
            macs += cfg.n_layers_decode * _layer_macs(
                t_out, s_out, d, dff, dz_inject=dz, label_inject=lab)
        # the FCN heads: command and argument classification
        macs += t_out * d * cfg.n_commands
        macs += t_out * d * (cfg.n_args * cfg.args_dim_out)

    return 2 * macs


# dense peak FLOP/s of one card by the name torch.cuda.get_device_name gives:
# the tensor cores' bfloat16 and TF32 rates (NVIDIA's data sheets; the SXM
# part of the H100, the PCIe part of the H100 PCIe)
_PEAKS = {
    "NVIDIA H100 PCIe": {"bfloat16": 756e12, "float32": 378e12},
    "NVIDIA H100": {"bfloat16": 989e12, "float32": 495e12},
}


def peak_flops_per_chip(device_name: str, dtype: str = "bfloat16") -> float | None:
    """Peak FLOP/s of one card named ``device_name`` (as
    ``torch.cuda.get_device_name`` gives it) for products in ``dtype``
    (``"bfloat16"``, or ``"float32"``, which the kernels multiply in TF32);
    None for a card it does not know."""
    for name, peaks in sorted(_PEAKS.items(), key=lambda kv: -len(kv[0])):
        if device_name.startswith(name):
            return peaks[dtype]
    return None
