"""Small numeric helpers (reference: svglib/util_fns.py)."""
from __future__ import annotations

import math


def get_roots(a: float, b: float, c: float):
    """Real roots of a*x^2 + b*x + c = 0, degrading gracefully to the linear
    and constant cases."""
    if a == 0:
        if b == 0:
            return []
        return [-c / b]
    disc = b * b - 4 * a * c
    if disc < 0:
        return []
    sq = math.sqrt(disc)
    return [(-b + sq) / (2 * a), (-b - sq) / (2 * a)]
