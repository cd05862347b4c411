"""Synthetic icon-like SVG tensor data (numpy), for tests, ``chip_smoke.py``
and the training CLI.

A copy of ``deepsvg_tpu/data/synthetic.py`` (the generator, the datasets
``SyntheticIconDataset`` and ``SyntheticAugmentedCorpus``, and the CLI hook
``load_dataset``): the same seed gives the same items in both packages, so
the two can be held against each other.
"""
from __future__ import annotations

import numpy as np

from ..svgtensor.constants import (
    ARGS_DIM, CMD_C, CMD_EOS, CMD_L, CMD_M, CMD_SOS, N_ARGS, PAD_VAL, Index, IndexArgs)
from ..svgtensor.tensor import cmd_args_to_data14, pack_groups


def _random_path(rng: np.random.Generator, n_cmds: int, use_curves: bool = True) -> np.ndarray:
    """One path: moveto + (n_cmds-1) line/cubic commands tracing a noisy
    closed-ish contour, coordinates on the 8-bit grid."""
    center = rng.uniform(64, 192, size=2)
    radius = rng.uniform(20, 60)
    angles = np.sort(rng.uniform(0, 2 * np.pi, size=n_cmds))
    pts = center + radius * np.stack([np.cos(angles), np.sin(angles)], -1)
    pts += rng.normal(0, 4, pts.shape)
    pts = np.clip(np.round(pts), 0, ARGS_DIM - 1)

    # canonical 14-column rows: every unused slot is PAD_VAL=-1
    rows = np.full((n_cmds, 14), -1.0, np.float32)
    rows[0, Index.COMMAND] = CMD_M
    rows[0, Index.END_POS] = pts[0]
    for i in range(1, n_cmds):
        start, end = pts[i - 1], pts[i]
        if use_curves and rng.random() < 0.5:
            rows[i, Index.COMMAND] = CMD_C
            c1 = np.clip(np.round(start + (end - start) * 0.3 + rng.normal(0, 3, 2)), 0, ARGS_DIM - 1)
            c2 = np.clip(np.round(start + (end - start) * 0.7 + rng.normal(0, 3, 2)), 0, ARGS_DIM - 1)
            rows[i, Index.CONTROL1] = c1
            rows[i, Index.CONTROL2] = c2
        else:
            rows[i, Index.COMMAND] = CMD_L
        rows[i, Index.START_POS] = start
        rows[i, Index.END_POS] = end
    return rows


def generate_icon(rng: np.random.Generator, max_num_groups: int = 8,
                  max_seq_len: int = 30, max_total_len: int = 240,
                  return_tensors: bool = False):
    """One packed sample dict; ``return_tensors=True`` also returns the raw
    per-group ``[n, 14]`` row tensors."""
    budget = max_total_len
    n_groups = int(rng.integers(1, max_num_groups + 1))
    tensors = []
    for _ in range(n_groups):
        n_cmds = int(rng.integers(3, max_seq_len + 1))
        n_cmds = min(n_cmds, budget)
        if n_cmds < 3:
            break
        tensors.append(_random_path(rng, n_cmds))
        budget -= n_cmds
    packed = pack_groups(tensors, max_num_groups, max_seq_len, max_total_len)
    if return_tensors:
        return packed, tensors
    return packed


def generate_batch(rng: np.random.Generator, batch_size: int,
                   max_num_groups: int = 8, max_seq_len: int = 30,
                   max_total_len: int | None = None,
                   label_range: int | None = None) -> dict[str, np.ndarray]:
    """Stacked batch of packed samples; optionally adds random class labels."""
    if max_total_len is None:
        max_total_len = max_num_groups * max_seq_len
    samples = [generate_icon(rng, max_num_groups, max_seq_len, max_total_len)
               for _ in range(batch_size)]
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    if label_range is not None:
        batch["label"] = rng.integers(0, label_range, size=batch_size).astype(np.int32)
    return batch


class SyntheticIconDataset:
    """Finite, reproducible synthetic dataset with the loader interface used by
    the training runtime (``__len__``, ``__getitem__``, ``get_batch_arrays``)."""

    def __init__(self, n: int = 1024, seed: int = 0, max_num_groups: int = 8,
                 max_seq_len: int = 30, max_total_len: int | None = None,
                 label_range: int | None = None):
        self.n = n
        self.seed = seed
        self.max_num_groups = max_num_groups
        self.max_seq_len = max_seq_len
        self.max_total_len = max_total_len or max_num_groups * max_seq_len
        self.label_range = label_range
        self._cache: dict[int, tuple[dict, list]] = {}
        self._cols: dict | None = None

    # items are pure functions of the index -> eligible for device-resident
    # training (data/resident.py)
    deterministic_items = True

    def __len__(self):
        return self.n

    def _generate(self, idx: int) -> tuple[dict, list]:
        idx = int(idx) % self.n
        if idx not in self._cache:
            rng = np.random.default_rng(self.seed * 1_000_003 + idx)
            packed, tensors = generate_icon(
                rng, self.max_num_groups, self.max_seq_len, self.max_total_len,
                return_tensors=True,
            )
            if self.label_range is not None:
                packed["label"] = np.int32(int(rng.integers(0, self.label_range)))
            self._cache[idx] = (packed, tensors)
        return self._cache[idx]

    def __getitem__(self, idx: int) -> dict:
        return self._generate(idx)[0]

    def get(self, idx=0, model_args=None, random_aug=True, id=None, svg=None):
        """Same surface as the real loaders' ``get`` (dataset.py:182) so the
        experiment configs' ``set_train_vars``/``visualize`` hooks work
        unchanged; ``"tensor"`` returns the raw per-group row tensors."""
        packed, tensors = self._generate(idx)
        keys = set(model_args) if model_args is not None else set(packed)
        res = {k: v for k, v in packed.items() if k in keys}
        if "tensor" in keys:
            res["tensor"] = tensors
        return res

    def _columnar(self) -> dict:
        """All items stacked once into big per-key arrays (the dataset is
        deterministic per index, so this is just a materialized cache)."""
        if not hasattr(self, "_cols") or self._cols is None:
            items = [self[i] for i in range(self.n)]
            self._cols = {k: np.stack([it[k] for it in items])
                          for k in items[0]}
        return self._cols

    def get_batch_arrays(self, indices) -> dict:
        """Loader fast path: one C-level fancy-index per key per batch."""
        cols = self._columnar()
        idx = np.asarray(indices, np.int64)
        return {k: v[idx] for k, v in cols.items()}


class SyntheticAugmentedCorpus:
    """Pre-augmented synthetic tensor corpus at real-dataset dimensions.

    The icons_tensor scale-rehearsal stand-in: ``n_icons`` base icons, each
    with ``n_augs`` PRE-COMPUTED augmentation variants — the same contract as
    ``SVGTensorDataset`` over the reference's pickle corpus (reference
    svgtensor_dataset.py:52: each pickle holds one tensor list per
    augmentation; :112 ``__len__ = len(df) * nb_augmentations``; :156 the
    variant is drawn uniformly per access; ``__getitem__`` reduces a flat
    index to an icon via ``idx % len(df)``).

    Generation is vectorized numpy (the per-item Python of ``generate_icon``
    is some hundred times slower), so a 100k x 10-variant corpus builds in
    under a minute. Augmentation =
    scale-about-center + translate on the quantized coordinate grid, one
    (scale, dx, dy) triple per (icon, aug), mirroring the reference
    preprocessing's zoom/translate family (dataset/preprocess.py:31-38).
    """

    def __init__(self, n_icons: int, n_augs: int = 10, seed: int = 0,
                 max_num_groups: int = 8, max_seq_len: int = 30,
                 max_total_len: int = 50, chunk: int = 25_000,
                 label_range: int | None = None):
        self.n_icons = int(n_icons)
        self.nb_augmentations = int(n_augs)
        self.max_num_groups = max_num_groups
        self.max_seq_len = max_seq_len
        self.max_total_len = max_total_len
        self.seed = seed
        self.label_range = label_range
        # per-ICON class label, shared by all augmentation variants — the
        # fonts contract (reference svgtensor_dataset.py label column: a
        # glyph's class is invariant under augmentation)
        self._labels = (None if label_range is None else
                        np.random.default_rng(seed + 7).integers(
                            0, int(label_range), self.n_icons
                        ).astype(np.int32))

        N, G, S = self.n_icons, max_num_groups, max_seq_len
        self._commands = np.empty((N, G, S + 2), np.int8)
        self._args = np.empty((N, G, S + 2, N_ARGS), np.int16)
        for lo in range(0, N, chunk):
            hi = min(lo + chunk, N)
            c, a = self._generate_chunk(lo, hi)
            self._commands[lo:hi] = c
            self._args[lo:hi] = a
        # one (scale, dx, dy) per (icon, aug); aug 0 is the identity so the
        # base icon itself is always among the variants
        arng = np.random.default_rng(seed + 1)
        self._scale = arng.uniform(0.8, 1.2, (N, n_augs)).astype(np.float32)
        self._shift = arng.uniform(-16, 16, (N, n_augs, 2)).astype(np.float32)
        self._scale[:, 0] = 1.0
        self._shift[:, 0] = 0.0
        # persistent access rng: the variant drawn for an access varies from
        # call to call (reference svgtensor_dataset.py:156 draws uniformly per
        # access from the process rng), while staying seed-reproducible
        self._access_rng = np.random.default_rng(seed + 11)

    def _generate_chunk(self, lo: int, hi: int):
        """Vectorized ``generate_icon`` over icons [lo, hi): same recipe
        (noisy closed contour per path, l/c mix, budgeted group lengths)
        emitted directly in the packed SOS+content+EOS layout."""
        G, S, budget = self.max_num_groups, self.max_seq_len, self.max_total_len
        n = hi - lo
        rng = np.random.default_rng(self.seed * 1_000_003 + lo)

        n_groups = rng.integers(1, G + 1, n)
        L = rng.integers(3, S + 1, (n, G)).astype(np.int32)
        L[np.arange(G)[None, :] >= n_groups[:, None]] = 0
        # sequential budget: clip the straddling group, drop the rest and any
        # remnant shorter than a 3-command path (generate_icon's loop)
        prev = np.cumsum(L, 1) - L
        L = np.clip(np.minimum(L, budget - prev), 0, None)
        L[L < 3] = 0

        center = rng.uniform(64, 192, (n, G, 1, 2)).astype(np.float32)
        radius = rng.uniform(20, 60, (n, G, 1, 1)).astype(np.float32)
        ang = np.sort(rng.uniform(0, 2 * np.pi, (n, G, S)), -1).astype(np.float32)[..., None]
        pts = center + radius * np.concatenate([np.cos(ang), np.sin(ang)], -1)
        pts += rng.normal(0, 4, pts.shape).astype(np.float32)
        pts = np.clip(np.round(pts), 0, ARGS_DIM - 1)

        k_idx = np.arange(S, dtype=np.int32)[None, None, :]
        valid = k_idx < L[:, :, None]
        is_c = (rng.random((n, G, S)) < 0.5) & (k_idx > 0) & valid
        start = np.roll(pts, 1, axis=2)
        c1 = np.clip(np.round(start + (pts - start) * 0.3
                              + rng.normal(0, 3, pts.shape)), 0, ARGS_DIM - 1)
        c2 = np.clip(np.round(start + (pts - start) * 0.7
                              + rng.normal(0, 3, pts.shape)), 0, ARGS_DIM - 1)

        cmd = np.where(is_c, CMD_C, CMD_L).astype(np.int8)
        cmd[:, :, 0] = CMD_M
        commands = np.full((n, G, S + 2), CMD_EOS, np.int8)
        commands[:, :, 0] = CMD_SOS
        commands[:, :, 1:S + 1] = np.where(valid, cmd, CMD_EOS)

        args = np.full((n, G, S + 2, N_ARGS), PAD_VAL, np.int16)
        body = np.full((n, G, S, N_ARGS), float(PAD_VAL), np.float32)
        body[..., IndexArgs.END_POS] = np.where(valid[..., None], pts, PAD_VAL)
        body[..., IndexArgs.CONTROL1] = np.where(is_c[..., None], c1, PAD_VAL)
        body[..., IndexArgs.CONTROL2] = np.where(is_c[..., None], c2, PAD_VAL)
        args[:, :, 1:S + 1] = body.astype(np.int16)
        return commands, args

    # -- SVGTensorDataset surface ------------------------------------------
    def __len__(self):
        return self.n_icons * self.nb_augmentations

    def _variant_args(self, icon_idx, aug_idx) -> np.ndarray:
        """float32 packed args for (icon, aug) index arrays (broadcastable):
        scale about the grid center + translate, valid coordinate slots only
        (PAD stays PAD — the masked-uint8 wire contract, loader.py)."""
        base = self._args[icon_idx].astype(np.float32)
        pos = base[..., IndexArgs.CONTROL1.start:]
        s = self._scale[icon_idx, aug_idx]
        t = np.tile(self._shift[icon_idx, aug_idx], 3)
        v = (pos - 128.0) * s[..., None, None, None] + 128.0 + t[..., None, None, :]
        v = np.clip(np.round(v), 0, ARGS_DIM - 1)
        base[..., IndexArgs.CONTROL1.start:] = np.where(pos >= 0, v, PAD_VAL)
        return base

    def get_item_aug(self, icon_idx: int, aug_idx: int, model_args=None):
        item = {
            "commands": self._commands[icon_idx].astype(np.int32),
            "args": self._variant_args(np.asarray(icon_idx), np.asarray(aug_idx)),
        }
        if self._labels is not None:
            item["label"] = self._labels[icon_idx]
        if model_args is not None:
            item = {k: v for k, v in item.items() if k in set(model_args)}
        return item

    def __getitem__(self, idx: int) -> dict:
        icon = int(idx) % self.n_icons
        return self.get_item_aug(
            icon, int(self._access_rng.integers(self.nb_augmentations)))

    def get(self, idx=0, model_args=None, random_aug=True, id=None, svg=None):
        """Same surface as the real loaders' ``get`` (dataset.py:195);
        ``"tensor"`` reconstructs the raw per-group row tensors."""
        icon = int(idx) % self.n_icons
        aug = (int(self._access_rng.integers(self.nb_augmentations))
               if random_aug else 0)
        item = self.get_item_aug(icon, aug)
        keys = set(model_args) if model_args is not None else set(item)
        res = {k: v for k, v in item.items() if k in keys}
        if "tensor" in keys:
            res["tensor"] = []
            for g in range(self.max_num_groups):
                c, a = item["commands"][g], item["args"][g]
                real = (c != CMD_EOS) & (c != CMD_SOS)
                if real.any():
                    res["tensor"].append(cmd_args_to_data14(c[real], a[real]))
        return res

    def get_batch_arrays(self, indices) -> dict:
        """Streaming-loader fast path: flat dataset indices -> one batch with
        a random aug per access (reference ``idx % len(df)`` + random
        variant)."""
        idx = np.asarray(indices, np.int64) % self.n_icons
        aug = self._access_rng.integers(0, self.nb_augmentations, idx.shape)
        out = {"commands": self._commands[idx].astype(np.int32),
               "args": self._variant_args(idx, aug)}
        if self._labels is not None:
            out["label"] = self._labels[idx]
        return out

    def get_variant_arrays(self, model_args=None) -> dict:
        """Resident-mode fast path (data/resident.py): the FULL corpus as one
        array per key, flat layout ``icon * n_augs + aug``, wire dtypes
        (commands int8; args masked-uint8 — PAD slots to 0, rebuilt on
        device)."""
        N, A = self.n_icons, self.nb_augmentations
        G, S2 = self.max_num_groups, self.max_seq_len + 2
        keys = (set(model_args) if model_args is not None
                else {"commands", "args"}
                | ({"label"} if self._labels is not None else set()))
        out = {}
        if "commands" in keys:
            out["commands"] = np.repeat(self._commands, A, axis=0)
        if "label" in keys and self._labels is not None:
            out["label"] = np.repeat(self._labels, A)
        if "args" in keys:
            args = np.empty((N * A, G, S2, N_ARGS), np.uint8)
            view = args.reshape(N, A, G, S2, N_ARGS)
            icon_idx = np.arange(N)
            for a in range(A):
                v = self._variant_args(icon_idx, np.full(N, a))
                view[:, a] = np.maximum(v, 0).astype(np.uint8)
            out["args"] = args
        return out


def load_dataset(cfg):
    """The training CLI's dataset hook: a self-contained synthetic dataset,
    so every config trains without the external icons or fonts archives.
    Select with ``--dataset-module deepsvg_tpu_torch.data.synthetic`` (or
    ``cfg.dataloader_module``); optional ``cfg.synthetic_size`` (default
    2048) and ``cfg.synthetic_seed`` (42)."""
    model_cfg = cfg.model_cfg
    label_range = None
    if model_cfg is not None and model_cfg.label_condition:
        label_range = getattr(model_cfg, "n_labels", None)
    return SyntheticIconDataset(
        n=getattr(cfg, "synthetic_size", 2048),
        seed=getattr(cfg, "synthetic_seed", 42),
        max_num_groups=cfg.max_num_groups,
        max_seq_len=cfg.max_seq_len,
        max_total_len=cfg.max_total_len,
        label_range=label_range,
    )
