"""The port's SVG library and native fitting engine against the JAX
package's.

``deepsvg_tpu_torch.svglib`` is a copy of ``deepsvg_tpu.svglib`` (numpy
only) and ``deepsvg_tpu_torch.native`` builds a copy of the C++ engine into
its own directory. Each operation below runs the same SVG documents, held
here as strings, through both packages after seeding ``random`` and numpy
alike: outputs equal, or within 1e-9 where the native engine fits the
curves. One case renders both and holds the images pixel for pixel.
"""
import random

import numpy as np
import pytest

import deepsvg_tpu.native as jax_native
import deepsvg_tpu.svglib as jax_svglib
import deepsvg_tpu.svglib.path_fitting as jax_fitting
import deepsvg_tpu.svglib.utils as jax_svg_utils
import deepsvg_tpu_torch.native as port_native
import deepsvg_tpu_torch.svglib as port_svglib
import deepsvg_tpu_torch.svglib.path_fitting as port_fitting
import deepsvg_tpu_torch.svglib.utils as port_svg_utils

_HEAD = '<svg xmlns="http://www.w3.org/2000/svg" viewBox="0 0 24 24">'


def _doc(body: str) -> str:
    return _HEAD + body + "</svg>"


# relative, H/V, quadratic (and its smooth form), smooth cubic, implicit
# lineto, several subpaths, arcs, and every primitive (rect, circle,
# ellipse, line, polyline, polygon)
DOCS = {
    "relative": _doc('<path d="m 3 3 l 9 1 l 2 8 l -10 -1 z"/>'),
    "hv": _doc('<path d="M 3 3 H 15 V 12 h -4 v 6 H 3 Z"/>'),
    "quadratic": _doc('<path d="M 2 12 Q 8 2 14 12 T 22 12 L 22 20 L 2 20 Z"/>'),
    "smooth": _doc('<path d="M 2 4 C 4 10 8 10 10 5 S 16 1 20 7 s 2 6 -4 10 L 2 20 Z"/>'),
    "implicit": _doc('<path d="M 4 4 10 6 18 4 16 16 6 18 z"/>'),
    "subpaths": _doc('<path d="M 2 2 L 10 2 L 10 10 Z M 12 12 L 21 13 L 20 21 L 12 20 Z"/>'),
    "arcs": _doc('<path d="M 4 12 A 8 8 0 0 1 20 12 A 6 4 30 1 0 4 12 Z"/>'),
    "nested": _doc('<path d="M 2 2 L 22 2 L 22 22 L 2 22 Z"/>'
                   '<path d="M 6 6 L 6 18 L 18 18 L 18 6 Z"/>'),
    "primitives": _doc('<rect x="3" y="4" width="12" height="8"/>'
                       '<circle cx="15" cy="15" r="5"/><ellipse cx="7" cy="17" rx="4" ry="2"/>'
                       '<line x1="2" y1="22" x2="20" y2="21"/>'
                       '<polyline points="2 2 6 1 9 3"/><polygon points="16 2 22 3 19 8"/>'),
}


def _seeded(fn, *args):
    random.seed(0)
    np.random.seed(0)
    return fn(*args)


def _canonical(lib, doc):
    return lib.SVG.from_str(doc).canonicalize(normalize=True)


def _tensors(svg):
    return [g.to_tensor() for g in svg.svg_path_groups]


def _op_parse(lib, doc):
    return lib.SVG.from_str(doc).to_str()


def _op_canonicalize(lib, doc):
    svg = _canonical(lib, doc)
    return svg.to_str(), svg.to_tensor(), svg.viewbox.to_str()


def _op_simplify_heuristic(lib, doc):
    return _tensors(_canonical(lib, doc).simplify_heuristic())


def _op_numericalize(lib, doc):
    svg = _canonical(lib, doc).simplify_heuristic().numericalize(256)
    return svg.to_tensor(), svg.to_str()


def _op_tensor_round_trip(lib, doc):
    t = _canonical(lib, doc).to_tensor()
    back = lib.SVG.from_tensor(t, viewbox=lib.Bbox(24))
    return back.to_tensor(), back.to_str(), [g.to_tensor() for g in back.svg_path_groups]


def _op_split_paths(lib, doc):
    svg = lib.SVG.from_str(doc).to_path().split_paths()
    return len(svg), svg.to_str()


def _op_sample_points(lib, doc):
    svg = _canonical(lib, doc)
    return [p.sample_points(max_dist=0.5) for p in svg.paths] + [svg.total_length()]


def _op_compute_filling(lib, doc):
    svg = lib.SVG.from_str(doc).to_path().simplify_arcs()
    svg.compute_filling()
    canon = lib.SVG.from_str(doc).canonicalize_with_fillings(normalize=True)
    return ([int(p.filling) for p in svg.paths], canon.to_fillings(), canon.to_str())


def _op_make_grid(lib, doc):
    utils = jax_svg_utils if lib is jax_svglib else port_svg_utils
    svgs = [_canonical(lib, doc), lib.SVG.unit_circle().normalize(),
            _canonical(lib, doc).set_color("random_random")]
    grid = utils.make_grid(svgs, num_cols=2)
    return grid.to_str(), grid.viewbox.to_str()


def _op_to_points(lib, doc):
    return _canonical(lib, doc).to_points(sort=True), _canonical(lib, doc).to_points(sort=False)


def _op_primitives_to_path(lib, doc):
    del doc
    P = lib.Point
    shapes = [lib.SVGRectangle(P(3, 4), lib.Size(12, 8)), lib.SVGCircle(P(15, 15), lib.Radius(5)),
              lib.SVGEllipse(P(7, 17), lib.Radius(4, 2)), lib.SVGLine(P(2, 22), P(20, 21)),
              lib.SVGPolyline([P(2, 2), P(6, 1), P(9, 3)]),
              lib.SVGPolygon([P(16, 2), P(22, 3), P(19, 8)])]
    return [(s.to_str(), s.to_path().to_str(), s.to_path().path.to_tensor()) for s in shapes]


OPS = {
    "parse_to_str": _op_parse,
    "canonicalize": _op_canonicalize,
    "simplify_heuristic": _op_simplify_heuristic,
    "numericalize": _op_numericalize,
    "to_tensor_from_tensor": _op_tensor_round_trip,
    "split_paths": _op_split_paths,
    "sample_points": _op_sample_points,
    "compute_filling": _op_compute_filling,
    "make_grid": _op_make_grid,
    "to_points": _op_to_points,
    "primitives_to_path": _op_primitives_to_path,
}


def _assert_same(got, want, atol=0.0, where="out"):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, atol, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.shape == want.shape, where
        if atol:
            np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=where)
        else:
            np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, where


@pytest.fixture
def native_off(monkeypatch):
    """Both packages' ``SVGPath.simplify`` on the pure-Python fitting."""
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(port_native, "available", lambda: False)


# the native engine runs only inside SVGPath.simplify
CASES = [(op, False) for op in sorted(OPS)] + [("simplify_heuristic", True),
                                               ("numericalize", True)]


@pytest.mark.parametrize("op,native", CASES)
def test_svglib_matches_jax(op, native, request):
    """Every document through both packages: equal outputs, or within 1e-9
    where the native engine (each package its own build) fits curves."""
    if native:
        assert jax_native.available() and port_native.available()
    else:
        request.getfixturevalue("native_off")
    for name, doc in DOCS.items():
        want = _seeded(OPS[op], jax_svglib, doc)
        got = _seeded(OPS[op], port_svglib, doc)
        _assert_same(got, want, 1e-9 if native and op == "simplify_heuristic" else 0.0,
                     f"{op} {name}")


def test_render_matches_jax_pixels():
    """The rasteriser: the port's image equals the JAX package's, pixel for
    pixel, stroked and filled."""
    for fill in (False, True):
        for name in ("smooth", "subpaths", "primitives"):
            imgs = []
            for lib in (jax_svglib, port_svglib):
                svg = _canonical(lib, DOCS[name]).set_color("random")
                imgs.append(np.asarray(svg.render(width=64, fill=fill)))
            assert imgs[0].std() > 1.0, name
            np.testing.assert_array_equal(imgs[1], imgs[0], err_msg=f"{name} fill={fill}")


def _contour(rng, n=200):
    t = np.linspace(0, 2 * np.pi, n)
    pts = np.stack([10 + 5 * np.cos(t), 10 + 5 * np.sin(t)], -1)
    return pts + rng.normal(0, 0.01, pts.shape)


def _pieces_close(got, want, atol=1e-9):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a[0] == b[0]
        for va, vb in zip(a[1:], b[1:]):
            np.testing.assert_allclose(va, vb, rtol=0, atol=atol)


@pytest.mark.parametrize("fn", ["fit_cubics", "rdp", "sample_cubics"])
def test_native_matches_python_and_jax(fn):
    """The port's engine against its own Python fitting (1e-9) and against
    the JAX package's engine (equal: the same source and flags)."""
    assert port_native.available()
    rng = np.random.default_rng(0)
    if fn == "fit_cubics":
        pts = _contour(rng)
        got = port_native.fit_cubics(pts, 0.1)
        _pieces_close(got, port_fitting.fit_cubics(pts, 0.1))
        _pieces_close(got, jax_native.fit_cubics(pts, 0.1), atol=0)
        _pieces_close(port_fitting.fit_cubics(pts, 0.1), jax_fitting.fit_cubics(pts, 0.1), atol=0)
    elif fn == "rdp":
        pts = rng.random((150, 2)) * np.array([100, 3])
        got = port_native.rdp(pts, 1.0)
        _pieces_close(got, port_fitting.rdp(pts, 1.0))
        _pieces_close(got, jax_native.rdp(pts, 1.0), atol=0)
    else:
        curves = rng.random((5, 8))
        got = port_native.sample_cubics(curves, 10)
        assert got.shape == (5, 10, 2)
        np.testing.assert_array_equal(got, jax_native.sample_cubics(curves, 10))
        np.testing.assert_allclose(got[:, 0], curves[:, 0:2], atol=1e-12)
        np.testing.assert_allclose(got[:, -1], curves[:, 6:8], atol=1e-12)


def test_native_builds_into_its_own_directory():
    """The library sits in ``native/build/`` under a name hashing its source,
    not beside the source."""
    import os
    port_native.get_lib()
    path = port_native._library_path()
    assert os.path.dirname(path) == port_native.BUILD_DIR and os.path.exists(path)
    assert not os.path.exists(os.path.join(os.path.dirname(port_native._SRC), "libsvgfit.so"))
