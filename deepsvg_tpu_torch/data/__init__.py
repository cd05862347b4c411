"""Data sources of the port: the icons/fonts datasets and raw SVG
directories, the synthetic icon generator and the wire format."""
from .dataset import (
    ICON_CATEGORIES, MetaTable, SVGDataset, SVGDatasetBase, SVGFinetuneDataset,
    SVGTensorDataset, category_to_label, label_to_uni, load_dataset, uni_to_label)
from .loader import decompress_batch
from .synthetic import generate_batch, generate_icon

__all__ = ["ICON_CATEGORIES", "MetaTable", "SVGDataset", "SVGDatasetBase",
           "SVGFinetuneDataset", "SVGTensorDataset", "category_to_label", "decompress_batch",
           "generate_batch", "generate_icon", "label_to_uni", "load_dataset", "uni_to_label"]
