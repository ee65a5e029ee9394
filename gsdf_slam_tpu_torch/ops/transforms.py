"""Geometry transforms: quaternions, covariances, camera matrices.

Port of `gsdf_slam_tpu/ops/transforms.py`, same conventions:

* quaternions are (w, x, y, z) and are not normalized here;
* the view matrix W2C maps p_cam = W2C @ [p_world, 1], stored untransposed;
* the projection is the OpenGL-style frustum of gaussian_keyframe.cpp:205-233
  and full_proj = P @ W2C;
* NDC -> pixel is ((v + 1) * S - 1) / 2 (auxiliary.h:33-36).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) (w,x,y,z) -> rotation matrix [..., 3, 3]
    (general_utils::build_rotation, include/general_utils.h:26-57)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z), 2.0 * (x * z + w * y)],
        [2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - w * x)],
        [2.0 * (x * z - w * y), 2.0 * (y * z + w * x), 1.0 - 2.0 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def build_cov3d(
    scales: torch.Tensor, quats: torch.Tensor, scale_modifier: float = 1.0
) -> torch.Tensor:
    """3D covariance Sigma = R S S^T R^T packed (xx, xy, xz, yy, yz, zz) [N, 6]
    (forward.cu:154-193), written elementwise in the JAX package's op order."""
    w, x, y, z = quats[..., 0], quats[..., 1], quats[..., 2], quats[..., 3]
    s = scale_modifier * scales
    s0, s1, s2 = s[..., 0], s[..., 1], s[..., 2]
    m00 = (1.0 - 2.0 * (y * y + z * z)) * s0
    m01 = (2.0 * (x * y - w * z)) * s1
    m02 = (2.0 * (x * z + w * y)) * s2
    m10 = (2.0 * (x * y + w * z)) * s0
    m11 = (1.0 - 2.0 * (x * x + z * z)) * s1
    m12 = (2.0 * (y * z - w * x)) * s2
    m20 = (2.0 * (x * z - w * y)) * s0
    m21 = (2.0 * (y * z + w * x)) * s1
    m22 = (1.0 - 2.0 * (x * x + y * y)) * s2
    return torch.stack(
        [
            m00 * m00 + m01 * m01 + m02 * m02,
            m00 * m10 + m01 * m11 + m02 * m12,
            m00 * m20 + m01 * m21 + m02 * m22,
            m10 * m10 + m11 * m11 + m12 * m12,
            m10 * m20 + m11 * m21 + m12 * m22,
            m20 * m20 + m21 * m21 + m22 * m22,
        ],
        dim=-1,
    )


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """logit, as general_utils::inverse_sigmoid."""
    return torch.log(x / (1.0 - x))


def world_to_view(q: np.ndarray, t: np.ndarray) -> np.ndarray:
    """W2C 4x4 [R|t; 0 1] from a pose quaternion (w,x,y,z) and translation
    (getWorld2View2, gaussian_keyframe.cpp:180-202). Host-side numpy."""
    w2c = np.eye(4, dtype=np.float64)
    qw, qx, qy, qz = (float(v) for v in q)
    n = math.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
    qw, qx, qy, qz = qw / n, qx / n, qy / n, qz / n
    w2c[0, 0] = 1 - 2 * (qy * qy + qz * qz)
    w2c[0, 1] = 2 * (qx * qy - qw * qz)
    w2c[0, 2] = 2 * (qx * qz + qw * qy)
    w2c[1, 0] = 2 * (qx * qy + qw * qz)
    w2c[1, 1] = 1 - 2 * (qx * qx + qz * qz)
    w2c[1, 2] = 2 * (qy * qz - qw * qx)
    w2c[2, 0] = 2 * (qx * qz - qw * qy)
    w2c[2, 1] = 2 * (qy * qz + qw * qx)
    w2c[2, 2] = 1 - 2 * (qx * qx + qy * qy)
    w2c[:3, 3] = np.asarray(t, dtype=np.float64)
    return w2c.astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """OpenGL-style projection (gaussian_keyframe.cpp:205-233)."""
    top = math.tan(fovy / 2) * znear
    right = math.tan(fovx / 2) * znear
    p = np.zeros((4, 4), dtype=np.float32)
    p[0, 0] = znear / right
    p[1, 1] = znear / top
    p[3, 2] = 1.0
    p[2, 2] = zfar / (zfar - znear)
    p[2, 3] = -(zfar * znear) / (zfar - znear)
    return p


@dataclasses.dataclass(frozen=True)
class CameraMatrices:
    """Per-view transforms (computeTransformTensors,
    gaussian_keyframe.cpp:138-169), stored untransposed on `device`.

    view [4,4] W2C, full_proj [4,4] P @ W2C, campos [3] camera centre in
    world; tanfovx/tanfovy are 0-d float32 tensors tan(FoV/2), so that
    scalar arithmetic on them rounds in float32 as the JAX package's does."""

    view: torch.Tensor
    full_proj: torch.Tensor
    campos: torch.Tensor
    tanfovx: torch.Tensor
    tanfovy: torch.Tensor

    @staticmethod
    def from_arrays(view, full_proj, campos, tanfovx, tanfovy, device="cuda"):
        f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        return CameraMatrices(
            view=f(view),
            full_proj=f(full_proj),
            campos=f(campos),
            tanfovx=f(tanfovx),
            tanfovy=f(tanfovy),
        )

    @staticmethod
    def from_pose(
        q: np.ndarray,
        t: np.ndarray,
        fovx: float,
        fovy: float,
        znear: float = 0.01,
        zfar: float = 100.0,
        device: torch.device | str = "cuda",
    ) -> "CameraMatrices":
        w2c = world_to_view(q, t)
        full = (projection_matrix(znear, zfar, fovx, fovy) @ w2c).astype(np.float32)
        c2w = np.linalg.inv(w2c)
        return CameraMatrices.from_arrays(
            w2c, full, c2w[:3, 3], math.tan(fovx * 0.5), math.tan(fovy * 0.5),
            device=device,
        )


def ndc_to_pix(v: torch.Tensor, size: int) -> torch.Tensor:
    """auxiliary.h:33-36."""
    return ((v + 1.0) * size - 1.0) * 0.5
