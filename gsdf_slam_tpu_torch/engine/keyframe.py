"""Keyframes and cameras: per-view state for the mapper.

Port of `gsdf_slam_tpu/engine/keyframe.py`: host-side equivalents of
GaussianKeyframe (include/gaussian_keyframe.h, src/gaussian_keyframe.cpp)
and Camera (include/camera.h). A keyframe owns the camera pose (Tcw),
intrinsics-derived FoVs, the gt image with its Gaussian-pyramid levels,
and the times-of-use counters driving the sliding window sampler;
computeTransformTensors becomes a CameraMatrices build on a device, the
card unless told otherwise.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops.transforms import CameraMatrices, focal_to_fov


def rot_to_quat_wxyz(r: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (w, x, y, z), Shepperd-stable."""
    m = np.asarray(r, dtype=np.float64)
    t = np.trace(m)
    if t > 0:
        s = math.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = math.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = math.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = math.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    return np.array([w, x, y, z], dtype=np.float64)


@dataclasses.dataclass
class Camera:
    """Pinhole camera (include/camera.h:31-139, model PINHOLE only, like the
    reference's KITTI path)."""

    camera_id: int
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    @property
    def fovx(self) -> float:
        return focal_to_fov(self.fx, self.width)

    @property
    def fovy(self) -> float:
        return focal_to_fov(self.fy, self.height)


@dataclasses.dataclass
class Keyframe:
    """GaussianKeyframe: pose Tcw + gt image + pyramid + use counters."""

    fid: int
    camera: Camera
    t_cw: np.ndarray  # [4,4] world->camera
    image: np.ndarray  # [H, W, 3] float RGB gt (sky-masked if applicable)
    mask: np.ndarray | None = None  # [H, W] training mask (undistort/sky)
    remaining_times_of_use: int = 0
    pyramid_images: list[np.ndarray] = dataclasses.field(default_factory=list)
    pyramid_masks: list[np.ndarray] = dataclasses.field(default_factory=list)
    pyramid_times_of_use: list[int] = dataclasses.field(default_factory=list)
    created_at_iter: int = 0

    # cached rasterizer matrices and the device they were built on; the
    # mapper sets _cam_matrices to None when the pose changes
    _cam_matrices: CameraMatrices | None = None
    _cam_device: str | None = None

    def camera_matrices(
        self, znear: float = 0.01, zfar: float = 100.0, device: torch.device | str = "cuda"
    ) -> CameraMatrices:
        """computeTransformTensors (gaussian_keyframe.cpp:138-169) on
        `device`; built once and kept, as the JAX package keeps them, and
        built again when asked for on another device."""
        if self._cam_matrices is None or self._cam_device != str(device):
            q = rot_to_quat_wxyz(self.t_cw[:3, :3])
            t = self.t_cw[:3, 3]
            self._cam_matrices = CameraMatrices.from_pose(
                q, t, self.camera.fovx, self.camera.fovy, znear=znear, zfar=zfar, device=device
            )
            self._cam_device = str(device)
        return self._cam_matrices

    def current_pyramid_level(self) -> int:
        """getCurrentGausPyramidLevel (gaussian_keyframe.cpp:234-246):
        consume sub-level budgets low-res-first; full-res once exhausted."""
        for i, budget in enumerate(self.pyramid_times_of_use):
            if budget > 0:
                self.pyramid_times_of_use[i] -= 1
                return i
        return len(self.pyramid_times_of_use)

    @property
    def camera_center(self) -> np.ndarray:
        c2w = np.linalg.inv(self.t_cw.astype(np.float64))
        return c2w[:3, 3].astype(np.float32)
