"""Mean squared 3-nearest-neighbour distance for Gaussian scale init.

Port of `knn_mean_dist2_exact` (`gsdf_slam_tpu/ops/knn.py:96-116`): the
exact k-NN of the reference's distCUDA2 (simple_knn.cu:148-183), on the
host with scipy's KD-tree. Used only at ingest.
"""

from __future__ import annotations

import numpy as np


def knn_mean_dist2_exact(points: np.ndarray, valid: np.ndarray | None = None, k: int = 3) -> np.ndarray:
    """Mean squared distance to the k nearest other points, per point [N]
    float32; rows with `valid` False get 0 and are nobody's neighbour."""
    from scipy.spatial import cKDTree

    points = np.asarray(points, np.float32)
    valid = np.ones(len(points), bool) if valid is None else np.asarray(valid, bool)
    out = np.zeros(len(points), np.float32)
    idx = np.flatnonzero(valid)
    if len(idx) > k:
        pts = points[idx].astype(np.float64)
        d, _ = cKDTree(pts).query(pts, k=k + 1, workers=-1)
        out[idx] = (d[:, 1:] ** 2).mean(axis=1).astype(np.float32)
    return out
