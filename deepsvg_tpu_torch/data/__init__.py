"""Data sources of the port: the synthetic icon generator and the wire format."""
from .loader import decompress_batch
from .synthetic import generate_batch, generate_icon

__all__ = ["decompress_batch", "generate_batch", "generate_icon"]
