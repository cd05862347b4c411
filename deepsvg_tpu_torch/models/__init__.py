"""The flagship SVG Transformer in PyTorch: inference and the training forward."""
from .cast import DropoutRng
from .checkpoint import load_params, msgpack_restore, msgpack_serialize, save_params
from .config import ModelConfig, gpu_fast, hierarchical, hierarchical_ordered
from .loss import svg_loss
from .model import SVGTransformer
from .sample import make_valid, one_shot_sample, threshold_sample
from .weights import load_flax_params, load_model, to_flax_params

__all__ = [
    "DropoutRng", "ModelConfig", "SVGTransformer", "gpu_fast", "hierarchical",
    "hierarchical_ordered", "load_flax_params", "load_model", "load_params", "make_valid",
    "msgpack_restore", "msgpack_serialize", "one_shot_sample", "save_params", "svg_loss",
    "threshold_sample", "to_flax_params",
]
