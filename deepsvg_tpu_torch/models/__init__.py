"""The SVG Transformers in PyTorch: every variant of the JAX package (one or
two stages, or a decoder alone; one-shot or autoregressive; transformer or
LSTM; with or without label conditioning), inference, sampling and the
training forward, and the import of the reference PyTorch checkpoints."""
from .cast import DropoutRng
from .checkpoint import load_params, msgpack_restore, msgpack_serialize, save_params
from .config import (
    ModelConfig, gpu_fast, hierarchical, hierarchical_ordered, hierarchical_self_matching,
    one_stage_one_shot, sketchformer, sketchrnn)
from .loss import svg_loss
from .model import SVGTransformer
from .sample import (
    autoregressive_sample, autoregressive_sample_cached, autoregressive_sample_fused,
    greedy_sample, make_valid, one_shot_sample, sample_categorical, threshold_sample)
from .torch_import import load_torch_checkpoint, state_dict_to_params
from .weights import load_flax_params, load_model, to_flax_params

__all__ = [
    "DropoutRng", "ModelConfig", "SVGTransformer", "autoregressive_sample",
    "autoregressive_sample_cached", "autoregressive_sample_fused", "gpu_fast",
    "greedy_sample", "hierarchical",
    "hierarchical_ordered", "hierarchical_self_matching", "load_flax_params", "load_model",
    "load_params", "load_torch_checkpoint", "make_valid", "msgpack_restore",
    "msgpack_serialize", "one_shot_sample",
    "one_stage_one_shot", "sample_categorical", "save_params", "sketchformer", "sketchrnn",
    "state_dict_to_params", "svg_loss", "threshold_sample", "to_flax_params",
]
