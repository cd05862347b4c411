"""The port's real-data loaders and preprocessing CLI against the JAX
package's, on the CPU.

Fixtures are written by the tests from numpy seeds: tensor pickles in the
reference layout (``{"tensors": [...], "fillings": [...]}``), raw SVG files
and meta CSVs (written with ``csv``, so the port's side never needs pandas;
the JAX package reads them with pandas). Held:

- ``MetaTable``'s column types and values against ``pandas.read_csv``, and
  ``write_csv``'s text against ``DataFrame.to_csv``;
- the meta filters and the row order, the ``train_ratio`` subset under one
  seed, the labels (``uni`` and ``category``), the ids of an all-integer id
  column, ``entry_from_id`` (refused with a ``ValueError`` where the JAX
  lookup fails with an ``IndexError``);
- every packed item, equal exactly: ``get`` with its augmentation draws,
  ``get_item_aug``, ``get(id=...)``, ``get(svg=...)``, the raw-SVG dataset
  with on-the-fly augmentation and preprocessing, ``SVGFinetuneDataset``,
  the device-resident arrays, ``load_dataset``'s dispatch;
- the preprocess CLI (``python -m``, two processes) against JAX's: the
  simplified files byte for byte, the meta rows as sets;
- the new modules with pandas, matplotlib and PIL blocked: a dataset from a
  CSV, the preprocess CLI on two SVGs, one SVG encoded and decoded.
"""
import csv
import io
import os
import pickle
import random
import subprocess
import sys
import types

import numpy as np
import pandas as pd
import pytest

from deepsvg_tpu.data import dataset as jax_ds
from deepsvg_tpu.data import preprocess as jax_pre
from deepsvg_tpu.data import resident as jax_resident
from deepsvg_tpu.svglib import SVG as JaxSVG
from deepsvg_tpu_torch.data import dataset as port_ds
from deepsvg_tpu_torch.data import resident as port_resident
from deepsvg_tpu_torch.data.synthetic import _random_path
from deepsvg_tpu_torch.svglib import SVG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G, S = 3, 6
MODEL_ARGS = ["commands", "args", "commands", "args"]
ALL_KEYS = ["commands", "args", "args_rel", "commands_grouped", "args_grouped",
            "args_rel_grouped", "filling", "label"]
CATEGORIES = ["free-icons", "logos", "arrows"]

# raw SVGs (24-unit viewbox), the preprocess CLI's and the raw dataset's input
_HEAD = '<svg xmlns="http://www.w3.org/2000/svg" viewBox="0 0 24 24">'
RAW_SVGS = {
    "tri": '<path d="M 3 3 L 20 4 L 12 20 Z"/>',
    "quad": '<path d="M 2 12 Q 8 2 14 12 T 22 12 L 22 20 L 2 20 Z"/>',
    "two": '<path d="M 2 2 L 10 2 L 10 10 Z M 12 12 L 21 13 L 20 21 L 12 20 Z"/>',
    "rect": '<rect x="3" y="4" width="12" height="8"/>',
    "circle": '<circle cx="12" cy="12" r="8"/>',
    "arc": '<path d="M 4 12 A 8 8 0 0 1 20 12 Z"/>',
}


def _write_csv(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(list(rows[0]))
        for r in rows:
            w.writerow([r[k] for k in rows[0]])


@pytest.fixture(scope="module")
def tensor_dir(tmp_path_factory):
    """20 icons of 1-4 paths (some beyond G or the total budget), 3 variants
    each, with ``category`` and ``uni`` columns and a ``len_groups`` list."""
    root = tmp_path_factory.mktemp("icons")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(20):
        n_groups = int(rng.integers(1, 5))
        variants = []
        for _ in range(3):
            paths = [_random_path(rng, int(rng.integers(3, 8))) for _ in range(n_groups)]
            variants.append(np.concatenate(paths, axis=0))
        lens = [int(rng.integers(3, 8)) for _ in range(n_groups)]
        with open(root / f"icon{i}.pkl", "wb") as f:
            pickle.dump({"tensors": variants, "fillings": [0] * n_groups}, f)
        rows.append({"id": f"icon{i}", "total_len": sum(lens), "nb_groups": n_groups,
                     "len_groups": str(lens), "max_len_group": max(lens),
                     "category": CATEGORIES[i % 3], "uni": 48 + (i * 7) % 75,
                     "commonName": f"shape {i}"})
    _write_csv(root / "meta.csv", rows)
    return str(root), str(root / "meta.csv")


@pytest.fixture(scope="module")
def svg_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("svgs")
    for name, body in RAW_SVGS.items():
        (root / f"{name}.svg").write_text(_HEAD + body + "</svg>")
    rows = [{"id": name, "total_len": 10, "nb_groups": 2, "max_len_group": 5}
            for name in RAW_SVGS]
    _write_csv(root / "meta.csv", rows)
    return str(root), str(root / "meta.csv")


@pytest.fixture(scope="module")
def simplified_dir(svg_dir, tmp_path_factory):
    """The raw SVGs through the JAX package's preprocessing, with its meta."""
    root = tmp_path_factory.mktemp("simplified")
    jax_pre.main(["--data_folder", svg_dir[0], "--output_folder", str(root),
                  "--output_meta_file", str(root / "meta.csv"), "--workers", "1"])
    return str(root), str(root / "meta.csv")


def _both(cls_name, *args, seed=None, **kwargs):
    """The JAX dataset (global states seeded with ``seed``) and the port's
    (its own generators from ``seed``)."""
    if seed is not None:
        random.seed(seed)
        np.random.seed(seed)
    jax_d = getattr(jax_ds, cls_name)(*args, **kwargs)
    port_d = getattr(port_ds, cls_name)(*args, seed=seed, **kwargs)
    return jax_d, port_d


def _ids(d):
    return [d.idx_to_id(i) for i in range(len(d.df))]


def _assert_items_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


# ------------------------------------------------------------------ the table

@pytest.mark.parametrize("text", [
    "id,a,b,c\n0001,1,2.5,x\n2,3,4,y\n",         # int ids, a mixed row
    "id,a,b\n0001,1,2.5\n2,3,4\n",               # all-numeric row: floats
    "id,a,b\nx,1,\ny,3,4\n",                     # a missing number: float column
    "id,len_groups,flag\n1,\"[3, 5]\",True\n2,[4],False\n",
    "id,v\nq,1e3\nr,-2\n",
])
def test_meta_table_reads_as_pandas(tmp_path, text):
    (tmp_path / "m.csv").write_text(text)
    df = pd.read_csv(tmp_path / "m.csv")
    table = port_ds.MetaTable.read_csv(tmp_path / "m.csv")
    assert table.columns == list(df.columns) and len(table) == len(df)
    for name in df.columns:
        kind = df[name].dtype.kind
        assert {"int": "i", "float": "f", "bool": "b"}.get(table.kinds[name], "str") == \
            (kind if kind in "ifb" else "str"), name
        assert [str(v) for v in getattr(table, name)] == [str(v) for v in df[name]], name
    for i in range(len(df)):
        row_p, row_t = df.iloc[i], table.row(i)
        assert [str(row_t[k]) for k in df.columns] == [str(row_p[k]) for k in df.columns]


@pytest.mark.parametrize("rows", [
    [],
    [{"id": "a", "total_len": 3, "nb_groups": 1, "len_groups": [3], "max_len_group": 3},
     {"id": "b,c", "total_len": 8, "nb_groups": 2, "len_groups": [3, 5], "max_len_group": 5}],
])
def test_write_csv_writes_as_pandas(tmp_path, rows):
    port_ds.write_csv(str(tmp_path / "m.csv"), rows)
    assert (tmp_path / "m.csv").read_text() == pd.DataFrame(rows).to_csv(index=False)


# ---------------------------------------------------------- filters and labels

@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(max_total_len=20),
    dict(filter_category=["logos", "arrows"]),
    dict(filter_uni=[48 + 7, 48 + 14, 48 + 21, 60]),
    dict(train_ratio=0.6),
], ids=["plain", "total_len", "category", "uni", "train_ratio"])
def test_filters_order_and_labels_match_jax(tensor_dir, kwargs):
    data_dir, meta = tensor_dir
    model_args = MODEL_ARGS + ["label"]
    jax_d, port_d = _both("SVGTensorDataset", data_dir, meta, model_args, G, S, seed=7,
                          **kwargs)
    assert len(port_d.df) > 0
    assert len(port_d) == len(jax_d) and _ids(port_d) == list(_ids(jax_d))
    assert port_d.nb_augmentations == jax_d.nb_augmentations == 3
    labels = [port_d.get_label(i) for i in range(len(port_d.df))]
    assert labels == [jax_d.get_label(i) for i in range(len(jax_d.df))]
    assert all(type(v) is np.int32 for v in labels)
    # the same seed, through the global state, gives the same subset
    np.random.seed(7)
    port_global = port_ds.SVGTensorDataset(data_dir, meta, model_args, G, S, **kwargs)
    assert _ids(port_global) == _ids(port_d)


def test_category_labels_and_name_search(tensor_dir, tmp_path):
    """Without a ``uni`` column the label is the category's index;
    ``search_name`` is ``str.contains``."""
    data_dir, meta = tensor_dir
    df = pd.read_csv(meta).drop(columns=["uni"])
    df.to_csv(tmp_path / "cat.csv", index=False)
    jax_d, port_d = _both("SVGTensorDataset", data_dir, str(tmp_path / "cat.csv"),
                          MODEL_ARGS, G, S)
    assert [port_d.get_label(i) for i in range(len(port_d.df))] == \
        [jax_d.get_label(i) for i in range(len(jax_d.df))]
    assert port_d.get_label(0) == port_ds.category_to_label(port_d.df.row(0).category)
    assert list(port_d.search_name("shape 1").id) == jax_d.search_name("shape 1").id.tolist()
    assert [port_ds.label_to_uni(port_ds.uni_to_label(u)) for u in (48, 65, 97, 122)] == \
        [48, 65, 97, 122]


def test_integer_ids_and_entry_from_id(tmp_path):
    """An all-integer id column reads as integers in both packages (``0003``
    opens ``3.pkl``); ``entry_from_id`` compares the column with ``str(id)``,
    which the JAX lookup fails on with an IndexError: the port refuses it
    with a ValueError. On text ids the entries agree."""
    rng = np.random.default_rng(1)
    rows = []
    for i in range(4):
        t = _random_path(rng, 4)
        with open(tmp_path / f"{i}.pkl", "wb") as f:
            pickle.dump({"tensors": [t], "fillings": [0]}, f)
        rows.append({"id": f"{i:04d}", "total_len": 5, "nb_groups": 1, "max_len_group": 5,
                     "category": "logos"})
    _write_csv(tmp_path / "meta.csv", rows)
    jax_d, port_d = _both("SVGTensorDataset", str(tmp_path), str(tmp_path / "meta.csv"),
                          MODEL_ARGS, G, S)
    assert [str(v) for v in _ids(port_d)] == [str(v) for v in _ids(jax_d)] == ["0", "1", "2", "3"]
    _assert_items_equal(port_d.get(3, random_aug=False), jax_d.get(3, random_aug=False))
    with pytest.raises(IndexError):
        jax_d.entry_from_id(2)
    with pytest.raises(ValueError, match="str\\(id\\)"):
        port_d.entry_from_id(2)


def test_entry_from_id_on_text_ids(tensor_dir):
    jax_d, port_d = _both("SVGTensorDataset", *tensor_dir, MODEL_ARGS, G, S)
    name = port_d.idx_to_id(1)
    want, got = jax_d.entry_from_id(name), port_d.entry_from_id(name)
    assert [str(got[k]) for k in port_d.df.columns] == [str(want[k]) for k in jax_d.df.columns]


# ------------------------------------------------------------------- the items

def test_tensor_items_match_jax(tensor_dir):
    """``get`` with its variant drawn from the seeded generator (the JAX
    package's global ``random``, in the same order), ``get_item_aug``,
    ``get(id=...)`` (labelled with row ``idx``), ``get(svg=...)``,
    ``random_icon`` / ``random_id``: every array equal."""
    model_args = ALL_KEYS
    jax_d, port_d = _both("SVGTensorDataset", *tensor_dir, model_args, G, S, seed=3)
    n = len(port_d.df)
    for idx in range(n):
        _assert_items_equal(port_d.get(idx), jax_d.get(idx))
        for aug in range(3):
            _assert_items_equal(port_d.get_item_aug(idx, aug), jax_d.get_item_aug(idx, aug))
    _assert_items_equal(port_d.get(2, id="icon5"), jax_d.get(2, id="icon5"))
    for _ in range(4):
        _assert_items_equal(port_d.random_icon(), jax_d.random_icon())
        assert port_d.random_id() == jax_d.random_id()
    circle = SVG.unit_circle().normalize().numericalize(256)
    jcircle = JaxSVG.unit_circle().normalize().numericalize(256)
    _assert_items_equal(port_d.get(svg=circle), jax_d.get(svg=jcircle))
    assert port_d.random_id_by_uni(port_d.df.row(0).uni) == \
        jax_d.random_id_by_uni(jax_d.df.iloc[0].uni)
    # the process loader sends the dataset to its workers
    clone = pickle.loads(pickle.dumps(port_d))
    _assert_items_equal(clone.get_item_aug(1, 2), port_d.get_item_aug(1, 2))


@pytest.mark.parametrize("already_preprocessed", [True, False])
def test_svg_items_match_jax(svg_dir, simplified_dir, already_preprocessed):
    """The raw-SVG dataset on simplified SVGs and their meta, and on raw
    SVGs that it preprocesses itself: load, augment on the fly with the
    seeded draws, numericalize, pack; equal item for item."""
    model_args = MODEL_ARGS + ["tensor"]
    folder = simplified_dir if already_preprocessed else svg_dir
    jax_d, port_d = _both("SVGDataset", *folder, model_args, G, 30, seed=11,
                          already_preprocessed=already_preprocessed, nb_augmentations=2)
    assert len(port_d) == len(jax_d) >= 8
    for idx in range(len(port_d)):
        got, want = port_d[idx], jax_d[idx]
        tensors = got.pop("tensor"), want.pop("tensor")
        assert len(tensors[0]) == len(tensors[1])
        for a, b in zip(*tensors):
            np.testing.assert_array_equal(a, b)
        _assert_items_equal(got, want)
    _assert_items_equal(port_d.get(1, random_aug=False, model_args=MODEL_ARGS),
                        jax_d.get(1, random_aug=False, model_args=MODEL_ARGS))


def test_finetune_dataset_matches_jax(tensor_dir):
    """Half keyframes, half random icons of the original dataset."""
    jax_d, port_d = _both("SVGTensorDataset", *tensor_dir, MODEL_ARGS, G, S, seed=5)
    svgs = [SVG.unit_circle().normalize().numericalize(256)]
    jsvgs = [JaxSVG.unit_circle().normalize().numericalize(256)]
    ft_p = port_ds.SVGFinetuneDataset(port_d, svgs, frac=0.5, nb_augmentations=3)
    ft_j = jax_ds.SVGFinetuneDataset(jax_d, jsvgs, frac=0.5, nb_augmentations=3)
    assert len(ft_p) == len(ft_j) == 6
    for i in range(len(ft_p)):
        _assert_items_equal(ft_p[i], ft_j[i])
    with pytest.raises(ValueError, match="has none"):
        port_ds.SVGFinetuneDataset(None, svgs)


def test_load_dataset_dispatch_and_resident_arrays(tensor_dir, svg_dir):
    """Pickles -> the tensor dataset, which the trainer keeps on the card
    (``build_resident_arrays`` equal to the JAX package's); SVG files -> the
    raw dataset, which streams."""
    def cfg(data_dir, meta):
        return types.SimpleNamespace(
            data_dir=data_dir, meta_filepath=meta, model_args=MODEL_ARGS, max_num_groups=G,
            max_seq_len=S, max_total_len=None, filter_uni=None, filter_platform=None,
            filter_category=None, train_ratio=1.0, nb_augmentations=2)
    t_port, t_jax = port_ds.load_dataset(cfg(*tensor_dir)), jax_ds.load_dataset(cfg(*tensor_dir))
    s_port = port_ds.load_dataset(cfg(*svg_dir), already_preprocessed=False)
    assert type(t_port) is port_ds.SVGTensorDataset and type(s_port) is port_ds.SVGDataset
    assert type(t_jax) is jax_ds.SVGTensorDataset and not s_port.already_preprocessed
    got = port_resident.build_resident_arrays(t_port, MODEL_ARGS, num_workers=2)
    want = jax_resident.build_resident_arrays(t_jax, MODEL_ARGS, num_workers=2)
    assert got[1:] == want[1:] == (len(t_port.df), 3)
    assert set(got[0]) == set(want[0])
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k], want[0][k])
    assert port_resident.build_resident_arrays(s_port, MODEL_ARGS) is None


# ------------------------------------------------------------- preprocess CLI

def test_preprocess_cli_matches_jax(tmp_path, svg_dir):
    """The port's CLI (``python -m``, two worker processes) and JAX's on the
    same folder with one malformed file: the simplified files equal byte
    for byte, the meta rows equal as sets (their order is the order the
    files finish)."""
    src = tmp_path / "in"
    src.mkdir()
    for name in RAW_SVGS:
        (src / f"{name}.svg").write_text(open(os.path.join(svg_dir[0], f"{name}.svg")).read())
    (src / "broken.svg").write_text("<svg><path d='M 1 1 L'/>")
    out_j, out_p = tmp_path / "out_jax", tmp_path / "out_port"
    jax_pre.main(["--data_folder", str(src), "--output_folder", str(out_j),
                  "--output_meta_file", str(tmp_path / "jax.csv"), "--workers", "1"])
    proc = subprocess.run(
        [sys.executable, "-m", "deepsvg_tpu_torch.data.preprocess", "--data_folder", str(src),
         "--output_folder", str(out_p), "--output_meta_file", str(tmp_path / "port.csv"),
         "--workers", "2"], capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    files = sorted(os.listdir(out_j))
    assert files == sorted(os.listdir(out_p)) and len(files) >= len(RAW_SVGS)
    for name in files:
        assert (out_p / name).read_bytes() == (out_j / name).read_bytes(), name

    def rows(path):
        text = path.read_text()
        lines = text.splitlines()
        return lines[0], sorted(lines[1:]), list(csv.reader(io.StringIO(text)))
    head_p, body_p, parsed = rows(tmp_path / "port.csv")
    head_j, body_j, _ = rows(tmp_path / "jax.csv")
    assert head_p == head_j and body_p == body_j
    assert len(body_p) == len(files)
    assert all(r[3].startswith("[") for r in parsed[1:])       # len_groups as "[3, 5]"


# ------------------------------------------- the card machine's package set

BLOCKED_RUN = r"""
import importlib, os, pkgutil, sys
for name in ("pandas", "matplotlib", "PIL"):
    sys.modules[name] = None
import numpy as np, torch
import deepsvg_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from deepsvg_tpu_torch.data.dataset import SVGDataset
from deepsvg_tpu_torch.data.preprocess import main
from deepsvg_tpu_torch.inference import InferenceSession
from deepsvg_tpu_torch.models import ModelConfig, SVGTransformer
from deepsvg_tpu_torch.svglib import SVG
from deepsvg_tpu_torch.training.trainer import init_parameters
src, out = sys.argv[1], sys.argv[2]
main(["--data_folder", src, "--output_folder", out, "--output_meta_file",
      os.path.join(out, "meta.csv"), "--workers", "2"])
cfg = ModelConfig(encode_stages=2, decode_stages=2, use_vae=False, max_num_groups=3,
                  max_seq_len=6, d_model=32, dim_feedforward=64, dim_z=16, n_layers=1,
                  n_layers_decode=1, n_heads=4, dropout=0.0)
ds = SVGDataset(out, os.path.join(out, "meta.csv"), cfg.get_model_args(), 3, 30, seed=0)
assert len(ds) == 2, len(ds)
assert ds[0]["commands"].shape == (3, 32)
model = SVGTransformer(cfg)
init_parameters(model, torch.Generator().manual_seed(0))
session = InferenceSession(model)
z = session.encode_svg(SVG.load_svg(os.path.join(out, "tri.svg")))
svg = session.decode(z)[0]
assert z.shape == (1, 16) and isinstance(svg, SVG)
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "deepsvg_tpu")]
print("ok")
"""


def test_new_modules_run_without_pandas_matplotlib_pil(tmp_path):
    """The card machine has no pandas, matplotlib or PIL: with the three
    blocked, every module of the port imports, a dataset is built from a
    CSV, the preprocess CLI runs on two SVGs and one SVG is encoded and
    decoded on the CPU."""
    src = tmp_path / "in"
    src.mkdir()
    for name in ("tri", "two"):
        (src / f"{name}.svg").write_text(_HEAD + RAW_SVGS[name] + "</svg>")
    proc = subprocess.run([sys.executable, "-c", BLOCKED_RUN, str(src), str(tmp_path / "out")],
                          capture_output=True, text=True, timeout=180, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
