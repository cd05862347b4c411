"""Polyline simplification: Ramer-Douglas-Peucker + Schneider cubic fitting.

Same algorithm family as the reference (svg_path.py:391-613, itself derived
from paper.js PathFitter / Graphics Gems "An Algorithm for Automatically
Fitting Digitized Curves"), but implemented here over numpy point arrays with
vectorized inner loops (least-squares accumulation, max-error search, Newton
reparametrization) instead of per-point Python object arithmetic.

All functions take/return ``points [n, 2]`` float64 arrays. The output is a
list of ``("l", p1, p2)`` / ``("c", p1, c1, c2, p2)`` tuples that the caller
converts to command objects.
"""
from __future__ import annotations

import numpy as np

_MACHINE_EPSILON = 1.12e-16


def _normalize(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def _bezier_eval(ctrl: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Evaluate a cubic at parameters t: ctrl [4, 2], t [k] -> [k, 2]."""
    t = np.asarray(t)[:, None]
    s = 1 - t
    return (
        s**3 * ctrl[0] + 3 * s**2 * t * ctrl[1] + 3 * s * t**2 * ctrl[2] + t**3 * ctrl[3]
    )


def _bezier_d1(ctrl: np.ndarray, t: np.ndarray) -> np.ndarray:
    t = np.asarray(t)[:, None]
    s = 1 - t
    return 3 * s**2 * (ctrl[1] - ctrl[0]) + 6 * s * t * (ctrl[2] - ctrl[1]) + 3 * t**2 * (
        ctrl[3] - ctrl[2]
    )


def _bezier_d2(ctrl: np.ndarray, t: np.ndarray) -> np.ndarray:
    t = np.asarray(t)[:, None]
    s = 1 - t
    return 6 * s * (ctrl[2] - 2 * ctrl[1] + ctrl[0]) + 6 * t * (ctrl[3] - 2 * ctrl[2] + ctrl[1])


def _chord_length_parametrize(points: np.ndarray) -> np.ndarray:
    seg = np.linalg.norm(points[1:] - points[:-1], axis=-1)
    u = np.concatenate([[0.0], np.cumsum(seg)])
    if u[-1] > 0:
        u = u / u[-1]
    return u


def _generate_bezier(points: np.ndarray, u: np.ndarray, tan1: np.ndarray, tan2: np.ndarray) -> np.ndarray:
    """Least-squares cubic with fixed endpoints/tangent directions
    (Graphics Gems fitting step; reference svg_path.py:479-534), vectorized."""
    epsilon = 1e-12
    p1, p2 = points[0], points[-1]

    t = 1 - u
    b = 3 * u * t
    b0 = t**3
    b1 = b * t
    b2 = b * u
    b3 = u**3

    a1 = tan1[None, :] * b1[:, None]              # [k, 2]
    a2 = tan2[None, :] * b2[:, None]
    tmp = points - p1[None] * (b0 + b1)[:, None] - p2[None] * (b2 + b3)[:, None]

    c00 = float(np.sum(a1 * a1))
    c01 = float(np.sum(a1 * a2))
    c11 = float(np.sum(a2 * a2))
    x0 = float(np.sum(a1 * tmp))
    x1 = float(np.sum(a2 * tmp))

    det_c0_c1 = c00 * c11 - c01 * c01
    if abs(det_c0_c1) > epsilon:
        alpha1 = (x0 * c11 - x1 * c01) / det_c0_c1
        alpha2 = (c00 * x1 - c01 * x0) / det_c0_c1
    else:
        c0 = c00 + c01
        c1 = c01 + c11
        alpha1 = alpha2 = x0 / c0 if abs(c0) > epsilon else (x1 / c1 if abs(c1) > epsilon else 0.0)

    seg_length = float(np.linalg.norm(p2 - p1))
    eps = epsilon * seg_length
    handle1 = handle2 = None

    if alpha1 < eps or alpha2 < eps:
        alpha1 = alpha2 = seg_length / 3
    else:
        line = p2 - p1
        handle1 = tan1 * alpha1
        handle2 = tan2 * alpha2
        if handle1 @ line - handle2 @ line > seg_length**2:
            alpha1 = alpha2 = seg_length / 3
            handle1 = handle2 = None

    if handle1 is None or handle2 is None:
        handle1 = tan1 * alpha1
        handle2 = tan2 * alpha2

    return np.stack([p1, p1 + handle1, p2 + handle2, p2])


def _max_error(points: np.ndarray, ctrl: np.ndarray, u: np.ndarray) -> tuple[float, int]:
    """Max squared distance of interior points to the curve (vectorized)."""
    if len(points) <= 2:
        return 0.0, len(points) // 2
    inner = slice(1, len(points) - 1)
    d = _bezier_eval(ctrl, u[inner]) - points[inner]
    dist2 = np.sum(d * d, axis=-1)
    idx = int(np.argmax(dist2))
    # reference keeps the LAST max via >=; argmax gives first — emulate >=
    max_val = dist2[idx]
    ties = np.nonzero(dist2 >= max_val)[0]
    idx = int(ties[-1])
    return float(dist2[idx]), idx + 1


def _reparametrize(points: np.ndarray, u: np.ndarray, ctrl: np.ndarray) -> tuple[np.ndarray, bool]:
    """One Newton step of parameter refinement per point (vectorized over
    points; reference svg_path.py:448-477)."""
    diff = _bezier_eval(ctrl, u) - points
    d1 = _bezier_d1(ctrl, u)
    d2 = _bezier_d2(ctrl, u)
    num = np.sum(diff * d1, axis=-1)
    den = np.sum(d1 * d1, axis=-1) + np.sum(diff * d2, axis=-1)
    safe = np.abs(den) > _MACHINE_EPSILON
    new_u = np.where(safe, u - np.where(safe, num, 0.0) / np.where(safe, den, 1.0), u)
    in_order = bool(np.all(np.diff(new_u) > 0))
    return new_u, in_order


def fit_cubics(points: np.ndarray, error: float, tan1=None, tan2=None, out=None) -> list:
    """Recursive Schneider fitting of ``points`` by cubic segments."""
    if out is None:
        out = []
    points = np.asarray(points, dtype=np.float64)

    if tan1 is None:
        tan1 = _normalize(points[1] - points[0])
    if tan2 is None:
        tan2 = _normalize(points[-2] - points[-1])

    if len(points) == 2:
        p1, p2 = points[0], points[-1]
        dist = np.linalg.norm(p2 - p1) / 3
        out.append(("c", p1, p1 + dist * tan1, p2 + dist * tan2, p2))
        return out

    u = _chord_length_parametrize(points)
    max_err = max(error, error**2)
    in_order = True
    split_index = len(points) // 2

    for _ in range(5):
        ctrl = _generate_bezier(points, u, tan1, tan2)
        err, split_index = _max_error(points, ctrl, u)
        if err < error and in_order:
            out.append(("c", ctrl[0], ctrl[1], ctrl[2], ctrl[3]))
            return out
        if err >= max_err:
            break
        u, in_order = _reparametrize(points, u, ctrl)
        max_err = err

    tan_center = _normalize(points[split_index - 1] - points[split_index + 1])
    fit_cubics(points[: split_index + 1], error, tan1, tan_center, out)
    fit_cubics(points[split_index:], error, -tan_center, tan2, out)
    return out


def rdp(points: np.ndarray, epsilon: float, out=None) -> list:
    """Ramer-Douglas-Peucker polyline simplification producing line segments.

    Uses the same perpendicular-distance criterion and last-max tie-breaking
    as the reference (svg_path.py:536-556)."""
    if out is None:
        out = []
    points = np.asarray(points, dtype=np.float64)
    n = len(points)
    if n < 2:
        return out

    p1, p2 = points[0], points[-1]
    if n == 2:
        out.append(("l", p1, p2))
        return out

    chord = p2 - p1
    chord_norm = np.linalg.norm(chord)
    inner = points[1:-1]
    if chord_norm == 0:
        dist = np.linalg.norm(inner - p1, axis=-1)
    else:
        rel = p1[None, :] - inner
        dist = np.abs(chord[0] * rel[:, 1] - chord[1] * rel[:, 0]) / chord_norm
    max_val = dist.max()
    ties = np.nonzero(dist >= max_val)[0]
    split = int(ties[-1]) + 1

    if max_val > epsilon:
        rdp(points[: split + 1], epsilon, out)
        rdp(points[split:], epsilon, out)
    else:
        out.append(("l", p1, p2))
    return out
