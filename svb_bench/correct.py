"""The numbers ``correct`` compares."""

from __future__ import annotations

import numpy as np


def rel_err(got, ref) -> float:
    """||got - ref|| / ||ref|| over all elements, in float64; a shape
    mismatch or a non-finite value reads infinite."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if got.shape != ref.shape or not np.isfinite(got).all():
        return float("inf")
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def norm_gap(got: float, ref: float, scale: float) -> float:
    """|got - ref| / max(|ref|, scale): the gap between two norms of one
    leaf against the reference's norm of that leaf or of the median leaf."""
    if not np.isfinite(got):
        return float("inf")
    return abs(got - ref) / max(abs(ref), scale, 1e-30)
