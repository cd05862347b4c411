"""The SVG Transformer's flagship inference path, in PyTorch."""
from .checkpoint import load_params, msgpack_restore
from .config import ModelConfig, gpu_fast, hierarchical_ordered
from .model import SVGTransformer
from .sample import make_valid, one_shot_sample, threshold_sample
from .weights import load_flax_params, load_model

__all__ = [
    "ModelConfig", "SVGTransformer", "gpu_fast", "hierarchical_ordered", "load_flax_params", "load_model", "load_params",
    "make_valid", "msgpack_restore", "one_shot_sample", "threshold_sample",
]
