"""Data sources of the port: the synthetic icon generator."""
from .synthetic import generate_batch, generate_icon

__all__ = ["generate_batch", "generate_icon"]
