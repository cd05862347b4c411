"""Dataset loaders for the icons/fonts tensor datasets and raw SVG dirs,
counterpart of ``deepsvg_tpu/data/dataset.py``.

The same meta-CSV filter semantics (uni / platform / category / nb_groups /
max_len_group / total_len), the same label mappings and the same per-item
packing (numpy arrays through ``svgtensor.pack_groups``). The meta CSV is
read and written with the standard ``csv`` module behind :class:`MetaTable`,
which infers each column's type as ``pandas.read_csv`` does (so an
all-integer ``id`` column reads as integers) and has only the operations the
loaders use; pandas is not needed.

Randomness: the JAX package draws augmentations and random items from
Python's global ``random`` and ``train_ratio`` subsets from NumPy's global
state. A dataset built with ``seed=None`` does the same; with an integer
``seed`` it holds a ``random.Random(seed)`` and a
``numpy.random.RandomState(seed)`` of its own, which give the draws the
global states give after ``random.seed(seed)`` / ``np.random.seed(seed)``,
in the same call order.
"""
from __future__ import annotations

import csv
import math
import os
import pickle
import random
import re
from typing import List, Optional

import numpy as np

from ..svglib.geom import Point
from ..svglib.svg import SVG
from ..svgtensor.tensor import pack_groups

ICON_CATEGORIES = [
    "characters", "free-icons", "logos", "alphabet", "animals", "arrows",
    "astrology", "baby", "beauty", "business", "cinema", "city", "clothing",
    "computer-hardware", "crime", "cultures", "data", "diy", "drinks",
    "ecommerce", "editing", "files", "finance", "folders", "food", "gaming",
    "hands", "healthcare", "holidays", "household", "industry", "maps",
    "media-controls", "messaging", "military", "mobile", "music", "nature",
    "network", "photo-video", "plants", "printing", "profile", "programming",
    "science", "security", "shopping", "social-networks", "sports",
    "time-and-date", "transport", "travel", "user-interface", "users",
    "weather", "flags", "emoji", "men", "women",
]


def uni_to_label(uni: int) -> int:
    """Unicode codepoint -> class id: 0-9 digits, 10-35 upper, 36-61 lower."""
    if 48 <= uni <= 57:
        return uni - 48
    if 65 <= uni <= 90:
        return uni - 65 + 10
    return uni - 97 + 36


def label_to_uni(label_id: int) -> int:
    if 0 <= label_id <= 9:
        return label_id + 48
    if 10 <= label_id <= 35:
        return label_id + 65 - 10
    return label_id + 97 - 36


def category_to_label(category: str) -> int:
    return ICON_CATEGORIES.index(category)


# ---------------------------------------------------------------------------
# the meta table
# ---------------------------------------------------------------------------

# the fields pandas.read_csv reads as missing by default
_NA_TEXT = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
            "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"}
_INT = re.compile(r"[+-]?\d+\Z")
_FLOAT = re.compile(r"[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|inf|infinity)\Z",
                    re.IGNORECASE)
_BOOL = {"True": True, "TRUE": True, "true": True, "False": False, "FALSE": False,
         "false": False}


def _column(texts: list) -> tuple:
    """A column's fields -> ``(kind, values)`` with pandas' inference: int
    when every field is an integer, float when every field is a number or
    missing (missing as NaN), bool when every field is a truth value, else
    str (missing as NaN)."""
    present = [t for t in texts if t not in _NA_TEXT]
    if present and len(present) == len(texts) and all(_INT.match(t) for t in texts):
        return "int", [int(t) for t in texts]
    if all(_INT.match(t) or _FLOAT.match(t) for t in present):
        return "float", [float(t) if t not in _NA_TEXT else math.nan for t in texts]
    if len(present) == len(texts) and all(t in _BOOL for t in texts):
        return "bool", [_BOOL[t] for t in texts]
    return "str", [t if t not in _NA_TEXT else math.nan for t in texts]


class Row:
    """One row of a :class:`MetaTable`, its fields as attributes. As a
    pandas row (``df.iloc[i]``) does, an all-numeric row with a float column
    holds every field as a float."""

    def __init__(self, names: list, values: list, kinds: list):
        if all(k in ("int", "float") for k in kinds) and "float" in kinds:
            values = [float(v) for v in values]
        self.__dict__.update(zip(names, values))

    def __getitem__(self, name):
        return self.__dict__[name]


class MetaTable:
    """The meta CSV as typed columns, rows in file order. The operations the
    loaders use: a row mask by comparison or membership (``where`` /
    ``isin`` / ``contains``), ``filter`` by mask, ``sample(frac)``, ``row``
    by position and ``len``."""

    def __init__(self, columns: Optional[dict] = None, kinds: Optional[dict] = None):
        self.data = dict(columns or {})
        self.kinds = dict(kinds or {name: "str" for name in self.data})

    @property
    def columns(self) -> list:
        return list(self.data)

    @classmethod
    def read_csv(cls, path) -> "MetaTable":
        with open(path, newline="") as f:
            rows = list(csv.reader(f))
        if not rows or not any(rows[0]):
            return cls()
        names, body = rows[0], rows[1:]
        columns, kinds = {}, {}
        for j, name in enumerate(names):
            kinds[name], columns[name] = _column([r[j] if j < len(r) else "" for r in body])
        return cls(columns, kinds)

    def __len__(self) -> int:
        return len(next(iter(self.data.values()))) if self.data else 0

    def __getattr__(self, name):
        # columns by attribute, as ``df.id``
        data = self.__dict__.get("data")
        if data is not None and name in data:
            return data[name]
        raise AttributeError(name)

    def where(self, name: str, test) -> list:
        """The row mask ``test(value)`` over column ``name``."""
        return [bool(test(v)) for v in self.data[name]]

    def isin(self, name: str, values) -> list:
        allowed = list(values)
        return [any(_equal(v, a) for a in allowed) for v in self.data[name]]

    def contains(self, name: str, pattern: str) -> list:
        """``str.contains`` (a regular expression) over a text column."""
        rx = re.compile(pattern)
        return [isinstance(v, str) and rx.search(v) is not None for v in self.data[name]]

    def filter(self, mask: list) -> "MetaTable":
        keep = [i for i, m in enumerate(mask) if m]
        return self.take(keep)

    def take(self, positions) -> "MetaTable":
        return MetaTable({k: [v[int(i)] for i in positions] for k, v in self.data.items()},
                         self.kinds)

    def sample(self, frac: Optional[float] = None, n: Optional[int] = None,
               random_state=None) -> "MetaTable":
        """Rows drawn without replacement, in the order drawn, as
        ``DataFrame.sample``: ``random_state.choice(len, size, replace=False)``
        with ``size = round(frac * len)`` (``n`` rows when given); NumPy's
        global state when ``random_state`` is None."""
        rs = np.random if random_state is None else random_state
        size = n if n is not None else round((1 if frac is None else frac) * len(self))
        return self.take(rs.choice(len(self), size=size, replace=False))

    def row(self, idx: int) -> Row:
        names = self.columns
        n = len(self)
        if not -n <= idx < n:
            raise IndexError(f"row {idx} of a table of {n} rows")
        return Row(names, [self.data[k][idx] for k in names], [self.kinds[k] for k in names])


def _equal(a, b) -> bool:
    if isinstance(a, str) != isinstance(b, str):
        return False
    try:
        return bool(a == b)
    except Exception:
        return False


def _field_text(v) -> str:
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return ""
    return str(v)


def write_csv(path: str, rows: List[dict]) -> None:
    """Rows (dicts, the first row's keys naming the columns) to a CSV file as
    ``pandas.DataFrame(rows).to_csv(path, index=False)`` writes it: a list
    field as its ``str``, quoted where it holds the separator, ``\\n`` line
    ends, and a lone empty line for no rows."""
    with open(path, "w", newline="") as f:
        if not rows:
            f.write("\n")
            return
        names = list(rows[0])
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(names)
        for r in rows:
            writer.writerow([_field_text(r.get(k)) for k in names])


# ---------------------------------------------------------------------------
# the datasets
# ---------------------------------------------------------------------------

class SVGDatasetBase:
    """Shared meta-CSV handling + packing (both loaders). ``df`` may be a
    :class:`MetaTable` given in place of ``meta_filepath``; ``seed`` selects
    the dataset's own generators (module docstring)."""

    def __init__(self, data_dir, meta_filepath, model_args, max_num_groups,
                 max_seq_len, max_total_len=None, filter_uni=None,
                 filter_platform=None, filter_category=None, train_ratio=1.0,
                 df=None, PAD_VAL=-1, nb_augmentations=1, seed: Optional[int] = None):
        self.data_dir = data_dir
        self.MAX_NUM_GROUPS = max_num_groups
        self.MAX_SEQ_LEN = max_seq_len
        self.MAX_TOTAL_LEN = max_total_len or max_num_groups * max_seq_len
        self.rng = random.Random(seed) if seed is not None else None
        self.np_rng = np.random.RandomState(seed) if seed is not None else None

        if df is None:
            df = MetaTable.read_csv(meta_filepath)

        if len(df) > 0:
            if filter_uni is not None:
                df = df.filter(df.isin("uni", filter_uni))
            if filter_platform is not None:
                df = df.filter(df.isin("platform", filter_platform))
            if filter_category is not None:
                df = df.filter(df.isin("category", filter_category))
            df = df.filter([a and b for a, b in zip(
                df.where("nb_groups", lambda v: v <= max_num_groups),
                df.where("max_len_group", lambda v: v <= max_seq_len))])
            if max_total_len is not None:
                df = df.filter(df.where("total_len", lambda v: v <= max_total_len))

        self.df = df.sample(frac=train_ratio, random_state=self.np_rng) \
            if train_ratio < 1.0 else df
        self.model_args = model_args
        self.PAD_VAL = PAD_VAL
        self.nb_augmentations = nb_augmentations

    def _random(self):
        """Python's ``random`` draws: the dataset's generator, or the
        global one."""
        return self.rng if self.rng is not None else random

    # --- meta / labels ----------------------------------------------------
    def search_name(self, name):
        return self.df.filter(self.df.contains("commonName", name))

    def get_label(self, idx=0, entry=None):
        if entry is None:
            if len(self.df) == 0:  # packer-only instantiation (no metadata)
                return None
            entry = self.df.row(idx)
        if "uni" in self.df.columns:
            return np.int32(uni_to_label(int(entry.uni)))
        if "category" in self.df.columns:
            return np.int32(category_to_label(entry.category))
        return None

    def idx_to_id(self, idx):
        return self.df.row(idx).id

    def entry_from_id(self, id):
        """The row whose ``id`` equals ``str(id)``. On a column of integer
        ids that comparison matches nothing, as it does in the JAX package
        (whose lookup then fails with an ``IndexError``): refused here with
        the reason."""
        if self.df.kinds.get("id") != "str":
            raise ValueError(
                f"entry_from_id compares the id column with str(id), and this table's ids "
                f"were read as {self.df.kinds.get('id')}s, so no row can match {id!r}")
        rows = [i for i, v in enumerate(self.df.id) if v == str(id)]
        if not rows:
            raise IndexError(f"no row has id {id!r}")
        return self.df.row(rows[0])

    def __len__(self):
        return len(self.df) * self.nb_augmentations

    def random_icon(self):
        return self[self._random().randrange(0, len(self))]

    def random_id(self):
        return self.idx_to_id(self._random().randrange(0, len(self)) % len(self.df))

    def random_id_by_uni(self, uni):
        sub = self.df.filter(self.df.where("uni", lambda v: v == uni))
        return sub.sample(n=1, random_state=self.np_rng).row(0).id

    def __getitem__(self, idx):
        return self.get(idx, self.model_args)

    # --- packing ----------------------------------------------------------
    def get_data(self, t_sep: List[np.ndarray], fillings, model_args=None, label=None):
        """Per-item packing built on ``pack_groups``; emits only the keys the
        model consumes."""
        if model_args is None:
            model_args = self.model_args
        packed = pack_groups(
            t_sep, self.MAX_NUM_GROUPS, self.MAX_SEQ_LEN, self.MAX_TOTAL_LEN,
            fillings=fillings,
        )
        res = {}
        for arg in set(model_args):
            if arg == "label":
                res["label"] = label
            elif arg in packed:
                res[arg] = packed[arg]
            elif arg == "tensor":
                res["tensor"] = t_sep
        return res


def _augment(svg: SVG, mean=False, rng=random) -> SVG:
    dx, dy = (0, 0) if mean else (5 * rng.random() - 2.5, 5 * rng.random() - 2.5)
    factor = 0.7 if mean else 0.2 * rng.random() + 0.6
    return svg.zoom(factor).translate(Point(dx, dy))


def _simplify(svg: SVG, normalize=True) -> SVG:
    svg.canonicalize(normalize=normalize)
    svg = svg.simplify_heuristic()
    return svg.normalize()


def _preprocess(svg: SVG, augment=True, numericalize=True, mean=False, rng=random) -> SVG:
    if augment:
        svg = _augment(svg, mean=mean, rng=rng)
    if numericalize:
        return svg.numericalize(256)
    return svg


class SVGTensorDataset(SVGDatasetBase):
    """Pre-tensorized dataset: one pickle per icon with pre-augmented tensor
    variants (``{"tensors": [...], "fillings": [...]}``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.nb_augmentations = len(self._load_tensor(self.idx_to_id(0))[0])

    def _load_tensor(self, icon_id):
        with open(os.path.join(self.data_dir, f"{icon_id}.pkl"), "rb") as f:
            data = pickle.load(f)
        tensors = [np.asarray(t, dtype=np.float32) for t in data["tensors"]]
        # stored as either concatenated rows or per-group lists
        if tensors and tensors[0].ndim == 3:
            tensors = [[np.asarray(g) for g in t] for t in data["tensors"]]
        return tensors, data["fillings"]

    _augment = staticmethod(_augment)
    simplify = staticmethod(_simplify)
    preprocess = staticmethod(_preprocess)

    def get_item_aug(self, icon_idx: int, aug_idx: int, model_args=None):
        """One SPECIFIC (icon, augmentation-variant) item: the enumerable
        access that device-resident mode needs (``data/resident.py``).
        ``get`` draws the variant at random; here the caller picks it."""
        icon_idx = int(icon_idx) % len(self.df)
        tensors, fillings = self._load_tensor(self.idx_to_id(icon_idx))
        t_sep = _split_tensor_groups(tensors[int(aug_idx) % len(tensors)])
        return self.get_data(t_sep, fillings, model_args=model_args,
                             label=self.get_label(icon_idx))

    def get(self, idx=0, model_args=None, random_aug=True, id=None, svg: Optional[SVG] = None):
        """The item of row ``idx`` (or of ``id``, or packed from ``svg``).
        The label is row ``idx``'s whatever ``id`` names, as in the JAX
        package."""
        if id is None:
            idx = idx % len(self.df)
            id = self.idx_to_id(idx)

        if svg is None:
            tensors, fillings = self._load_tensor(id)
            t_sep = self._random().choice(tensors) if random_aug else tensors[0]
            t_sep = _split_tensor_groups(t_sep)
        else:
            t_sep = svg.to_tensor(concat_groups=False, PAD_VAL=self.PAD_VAL)
            fillings = svg.to_fillings()

        label = self.get_label(idx)
        return self.get_data(t_sep, fillings, model_args=model_args, label=label)


def _split_tensor_groups(t):
    """A stored per-icon tensor may be one concatenated [n, 14] array or a
    list of per-group arrays; normalize to a per-group list by splitting at
    moveto rows."""
    if isinstance(t, (list, tuple)):
        return [np.asarray(g, dtype=np.float32) for g in t]
    t = np.asarray(t, dtype=np.float32)
    starts = np.nonzero(t[:, 0] == 0)[0]  # moveto rows
    if len(starts) == 0 or starts[0] != 0:
        return [t]
    return [t[a:b] for a, b in zip(starts, list(starts[1:]) + [len(t)])]


class SVGDataset(SVGDatasetBase):
    """Raw ``.svg``-file dataset with on-the-fly preprocessing/augmentation."""

    def __init__(self, *args, already_preprocessed=True, **kwargs):
        super().__init__(*args, **kwargs)
        self.already_preprocessed = already_preprocessed

    def _load_svg(self, icon_id) -> SVG:
        svg = SVG.load_svg(os.path.join(self.data_dir, f"{icon_id}.svg"))
        if not self.already_preprocessed:
            svg.fill_(False)
            svg.normalize().zoom(0.9)
            svg.canonicalize()
            svg = svg.simplify_heuristic()
        return svg

    _augment = staticmethod(_augment)
    preprocess = staticmethod(_preprocess)
    simplify = staticmethod(_simplify)

    def get(self, idx=0, model_args=None, random_aug=True, id=None, svg: Optional[SVG] = None):
        if id is None and svg is None:
            idx = idx % len(self.df)
            id = self.idx_to_id(idx)
        if svg is None:
            svg = self._load_svg(id)
            svg = _preprocess(svg, augment=random_aug, rng=self._random())
        t_sep = svg.to_tensor(concat_groups=False, PAD_VAL=self.PAD_VAL)
        fillings = svg.to_fillings()
        label = self.get_label(idx)
        return self.get_data(t_sep, fillings, model_args=model_args, label=label)


class SVGFinetuneDataset:
    """Mix-in finetuning wrapper: fraction ``frac`` of items come from a list
    of user SVGs, the rest from the original dataset."""

    def __init__(self, original_dataset: SVGDatasetBase, svg_list: List[SVG],
                 frac: float = 0.5, nb_augmentations: int = 20):
        if original_dataset is None:
            # the JAX package fails here with an AttributeError on its first item
            raise ValueError(
                "finetuning packs the keyframes through the session's dataset, and the "
                "session has none: load the session with a dataset (load_session(..., "
                "dataset=...)) or encode an SVG first, which attaches a bare packer")
        self.original_dataset = original_dataset
        self.svg_list = svg_list
        self.frac = frac
        self.nb_augmentations = nb_augmentations
        self._cycle = math.ceil(len(svg_list) / frac)

    def __len__(self):
        return self._cycle * self.nb_augmentations

    def __getitem__(self, idx):
        i = idx % self._cycle
        if i < len(self.svg_list):
            return self.original_dataset.get(svg=self.svg_list[i].copy())
        return self.original_dataset.random_icon()


def load_dataset(cfg, already_preprocessed=True):
    """The training CLI's dataset hook; dispatches on ``cfg.data_dir``'s
    content (pickles -> tensor dataset, svgs -> raw)."""
    kind = getattr(cfg, "dataset_kind", None)
    if kind is None:
        try:
            has_pkl = any(f.endswith(".pkl") for f in os.listdir(cfg.data_dir)[:100])
        except OSError:
            has_pkl = True
        kind = "tensor" if has_pkl else "svg"
    common = dict(
        data_dir=cfg.data_dir, meta_filepath=cfg.meta_filepath,
        model_args=cfg.model_args, max_num_groups=cfg.max_num_groups,
        max_seq_len=cfg.max_seq_len, max_total_len=cfg.max_total_len,
        filter_uni=cfg.filter_uni, filter_platform=cfg.filter_platform,
        filter_category=cfg.filter_category, train_ratio=cfg.train_ratio,
    )
    if kind == "tensor":
        return SVGTensorDataset(**common)
    return SVGDataset(
        **common, nb_augmentations=getattr(cfg, "nb_augmentations", 1),
        already_preprocessed=already_preprocessed,
    )
