"""SE(3)/SO(3) exp, log, inverse and rotation angle (the Sophus role).

A copy of `gsdf_slam_tpu/utils/se3.py`, numpy only: the reference vendors
Sophus for pose algebra (submodules/Sophus/sophus/se3.hpp; GaussianKeyframe
stores Sophus::SE3d, gaussian_keyframe.h:31). Poses live on the host; the
device reads baked matrices.
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-10


def hat(v: np.ndarray) -> np.ndarray:
    x, y, z = v
    return np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]], dtype=np.float64)


def so3_exp(w: np.ndarray) -> np.ndarray:
    """Rodrigues: axis-angle vector -> rotation matrix."""
    w = np.asarray(w, np.float64)
    theta = np.linalg.norm(w)
    k = hat(w)
    if theta < _EPS:
        return np.eye(3) + k + 0.5 * (k @ k)
    return (
        np.eye(3)
        + (np.sin(theta) / theta) * k
        + ((1 - np.cos(theta)) / theta**2) * (k @ k)
    )


def so3_log(r: np.ndarray) -> np.ndarray:
    """Rotation matrix -> axis-angle vector."""
    r = np.asarray(r, np.float64)
    cos_t = np.clip((np.trace(r) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos_t)
    if theta < _EPS:
        return np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]]) / 2.0
    if abs(np.pi - theta) < 1e-6:
        # near pi: use the diagonal form
        a = np.sqrt(np.maximum((np.diag(r) + 1.0) / 2.0, 0.0))
        i = int(np.argmax(a))
        w = np.zeros(3)
        w[i] = a[i]
        for j in range(3):
            if j != i:
                w[j] = (r[i, j] + r[j, i]) / (4.0 * a[i])
        return w / np.linalg.norm(w) * theta
    return (
        theta / (2.0 * np.sin(theta))
    ) * np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])


def se3_exp(xi: np.ndarray) -> np.ndarray:
    """Twist (v, w) -> 4x4 transform (Sophus tangent convention)."""
    xi = np.asarray(xi, np.float64)
    v, w = xi[:3], xi[3:]
    theta = np.linalg.norm(w)
    r = so3_exp(w)
    k = hat(w)
    if theta < _EPS:
        j = np.eye(3) + 0.5 * k
    else:
        j = (
            np.eye(3)
            + ((1 - np.cos(theta)) / theta**2) * k
            + ((theta - np.sin(theta)) / theta**3) * (k @ k)
        )
    t = np.eye(4)
    t[:3, :3] = r
    t[:3, 3] = j @ v
    return t


def se3_log(t: np.ndarray) -> np.ndarray:
    """4x4 transform -> twist (v, w)."""
    t = np.asarray(t, np.float64)
    w = so3_log(t[:3, :3])
    theta = np.linalg.norm(w)
    k = hat(w)
    if theta < _EPS:
        j_inv = np.eye(3) - 0.5 * k
    else:
        half = theta / 2.0
        j_inv = (
            np.eye(3)
            - 0.5 * k
            + ((1.0 - half * np.cos(half) / np.sin(half)) / theta**2) * (k @ k)
        )
    return np.concatenate([j_inv @ t[:3, 3], w])


def se3_inverse(t: np.ndarray) -> np.ndarray:
    t = np.asarray(t, np.float64)
    out = np.eye(4)
    out[:3, :3] = t[:3, :3].T
    out[:3, 3] = -t[:3, :3].T @ t[:3, 3]
    return out


def rotation_angle(r: np.ndarray) -> float:
    """Geodesic rotation magnitude in radians (big-rotation keyframe
    threshold, gaussian_mapper.h:266)."""
    return float(np.linalg.norm(so3_log(r)))
