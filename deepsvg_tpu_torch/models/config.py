"""Model hyperparameters: a frozen-dataclass counterpart of
``deepsvg_tpu/models/config.py:ModelConfig`` with the fields the port reads.

The port runs the two-stage one-shot models: the flagship
``hierarchical_ordered``, the VAE ``hierarchical`` and
``hierarchical_self_matching``, and the one-stage autoregressive
``sketchformer`` with relative targets (inference, teacher forcing, the
greedy decode, and training); the variants it does not run yet are still
expressible here so that a config read from the JAX side keeps its meaning,
and the model raises ``NotImplementedError`` on them (see
``models/model.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

from ..svgtensor.constants import ARGS_DIM, N_ARGS, N_COMMANDS


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Hyperparameters of the SVG Transformer family (defaults as in the
    JAX package)."""

    args_dim: int = ARGS_DIM
    n_args: int = N_ARGS
    n_commands: int = N_COMMANDS

    model_type: Literal["transformer", "lstm"] = "transformer"

    encode_stages: int = 1
    decode_stages: int = 1

    use_resnet: bool = True
    use_vae: bool = True

    pred_mode: Literal["one_shot", "autoregressive"] = "one_shot"
    rel_targets: bool = False

    label_condition: bool = False

    self_match: bool = False

    n_layers: int = 4
    n_layers_decode: int = 4
    n_heads: int = 8
    dim_feedforward: int = 512
    d_model: int = 256

    dim_z: int = 256
    dropout: float = 0.1

    max_num_groups: int = 8
    max_seq_len: int = 30
    num_groups_proposal: int | None = None

    # activations and weights are used in this dtype (the parameters stay
    # float32 and are cast at use); LayerNorm, softmax and the residual stream
    # are computed in float32 inside the kernels
    compute_dtype: str = "float32"

    @property
    def max_total_len(self) -> int:
        return self.max_num_groups * self.max_seq_len

    @property
    def n_groups_prop(self) -> int:
        return self.num_groups_proposal or self.max_num_groups

    @property
    def args_dim_out(self) -> int:
        """Argument-head classes: one per quantized value plus PAD (absolute
        targets) or the full delta range (relative targets)."""
        return 2 * self.args_dim if self.rel_targets else self.args_dim + 1

    def get_model_args(self) -> list[str]:
        """The dataset keys the model reads: the encoder's, then the
        decoder's (targets), then the label if it is conditioned on one."""
        grouped = ["commands_grouped", "args_grouped"]
        model_args = grouped if self.encode_stages <= 1 else ["commands", "args"]
        if self.rel_targets:
            model_args = model_args + (["commands_grouped", "args_rel_grouped"]
                                       if self.decode_stages == 1 else ["commands", "args_rel"])
        else:
            model_args = model_args + (grouped if self.decode_stages == 1
                                       else ["commands", "args"])
        if self.label_condition:
            model_args.append("label")
        return model_args


def hierarchical() -> ModelConfig:
    """The two-stage model, with the VAE bottleneck (the icons config)."""
    return ModelConfig(encode_stages=2, decode_stages=2)


def hierarchical_self_matching() -> ModelConfig:
    """``configs_tpu/hierarchical_self_matching.py``: the two-stage VAE model
    whose proposals are matched to the target paths (Hungarian), with no
    position table over the paths in the encoder."""
    return ModelConfig(encode_stages=2, decode_stages=2, self_match=True)


def hierarchical_ordered() -> ModelConfig:
    """The flagship (``configs_tpu/hierarchical_ordered.py``): two-stage
    encode/decode, one-shot, ResNet + linear bottleneck, no VAE, no labels."""
    return ModelConfig(encode_stages=2, decode_stages=2, label_condition=False,
                       use_vae=False)


def sketchformer() -> ModelConfig:
    """The Sketchformer baseline (``configs_tpu/sketchformer.py``): one-stage
    encoding of the whole icon as one sequence of ``max_total_len`` commands
    with a group-index embedding, ResNet + VAE, and an autoregressive decoder
    with relative argument targets (``2 * args_dim`` classes)."""
    return ModelConfig(pred_mode="autoregressive", rel_targets=True)


def gpu_fast(cfg: ModelConfig) -> ModelConfig:
    """The card's execution profile, counterpart of ``tpu_fast``: bfloat16
    compute. The kernels themselves are chosen by the tensors' device, not
    by the config."""
    return dataclasses.replace(cfg, compute_dtype="bfloat16")
