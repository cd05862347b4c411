"""Device-resident training data: the whole wire-format dataset on the card.

A copy of ``deepsvg_tpu/data/resident.py`` (numpy only). An icon is about
3 KB in the narrow wire format (``loader.py``), so even the full 100k-icon
corpus with every pre-computed augmentation variant is a few GB: it is
uploaded once, kept in a flattened row layout, and each step's batch is
gathered on the device from its icon indices (``training/trainer.py``). The
steady state then moves no batch data from the host, only the indices.

Supported datasets:
- deterministic columnar datasets (``deterministic_items = True`` and
  ``get_batch_arrays``, e.g. ``SyntheticIconDataset``): one variant per item;
- pre-augmented tensor datasets (``get_item_aug`` and ``nb_augmentations``):
  every (icon, augmentation) variant is packed and uploaded, laid out
  ``flat = icon * n_augs + aug``; the per-step choice of variant is drawn on
  the device.

Datasets that augment with continuous random transforms per access are not
enumerable and keep the streaming loader.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .loader import collate, compress_batch


def estimate_resident_bytes(dataset, model_args) -> int | None:
    """Wire-format byte estimate for the fully-materialized dataset, from one
    packed item; None when the dataset does not support resident mode."""
    spec = _resident_spec(dataset)
    if spec is None:
        return None
    n_items, _, getter = spec
    item = compress_batch(collate([getter(0)]))
    per = sum(v.nbytes for k, v in item.items() if k in set(model_args))
    return per * n_items


def _resident_spec(dataset):
    """-> (n_flat_items, n_augs, getter(flat_idx) -> item dict) or None."""
    if getattr(dataset, "deterministic_items", False) and hasattr(
            dataset, "get_batch_arrays"):
        return len(dataset), 1, dataset.__getitem__
    if hasattr(dataset, "get_item_aug") and hasattr(dataset,
                                                    "nb_augmentations"):
        n_augs = max(int(dataset.nb_augmentations), 1)
        n_icons = len(dataset) // max(int(dataset.nb_augmentations), 1)

        def getter(flat):
            return dataset.get_item_aug(flat // n_augs, flat % n_augs)

        return n_icons * n_augs, n_augs, getter
    return None


def build_resident_arrays(dataset, model_args, max_bytes: int | None = None,
                          num_workers: int = 8):
    """Materialize the dataset as one wire-compressed array per model-arg key.

    Returns ``(data, n_icons, n_augs)`` — ``data[k]`` has leading dim
    ``n_icons * n_augs`` — or ``None`` when the dataset does not support
    resident mode or exceeds ``max_bytes``.
    """
    spec = _resident_spec(dataset)
    if spec is None:
        return None
    n_items, n_augs, getter = spec
    if n_items == 0:
        return None
    keys = set(model_args)
    if max_bytes is not None:
        est = estimate_resident_bytes(dataset, model_args)
        if est is None or est > max_bytes:
            return None

    gva = getattr(dataset, "get_variant_arrays", None)
    fast = getattr(dataset, "get_batch_arrays", None)
    if gva is not None:
        # the dataset serves the whole flat (icon, aug) corpus as one array
        # per key
        data = {k: v for k, v in gva(model_args).items() if k in keys}
    elif fast is not None and n_augs == 1:
        cols = fast(np.arange(n_items))
        data = {k: v for k, v in cols.items() if k in keys}
    else:
        # packing is numpy-heavy (releases the GIL) -> thread pool
        with ThreadPoolExecutor(max_workers=max(num_workers, 1)) as pool:
            items = list(pool.map(getter, range(n_items)))
        data = {k: v for k, v in collate(items).items() if k in keys}
    if not data or any(k not in data for k in keys if k != "tensor"):
        return None
    return compress_batch(data), n_items // n_augs, n_augs


def epoch_icon_permutation(n_items: int, n_icons: int, batch_size: int,
                           seed: int, epoch: int) -> np.ndarray:
    """Per-epoch icon-index batches ``[n_batches, B]`` matching the streaming
    ``DataLoader`` exactly: shuffle ``range(n_items)`` with
    ``default_rng(seed + epoch)`` (``DataLoader.index_batches``; epoch counts
    from 1), drop the ragged tail, and reduce the augmented index space to
    icon indices (``idx % n_icons``: the augmentation slot of the shuffled
    index is ignored; the variant is drawn per access, on the device)."""
    rng = np.random.default_rng(seed + epoch)
    perm = rng.permutation(n_items)
    n_batches = n_items // batch_size
    perm = perm[: n_batches * batch_size] % n_icons
    return perm.reshape(n_batches, batch_size).astype(np.int32)
