"""Scene registry: cameras + keyframes + scene extent.

Port of `gsdf_slam_tpu/engine/scene.py`, GaussianScene
(include/gaussian_scene.h, src/gaussian_scene.cpp). Python is
single-threaded here (the mapper loop owns the scene), so the reference's
mutexes disappear. `nerfpp_norm()[1]` is the `cameras_extent` that the
densify's `extent` reads.
"""

from __future__ import annotations

import numpy as np

from ..ops.transforms import nerfpp_norm
from .keyframe import Camera, Keyframe


class Scene:
    def __init__(self):
        self.cameras: dict[int, Camera] = {}
        self.keyframes: dict[int, Keyframe] = {}
        self.cameras_extent: float = 1.0

    def add_camera(self, cam: Camera) -> None:
        self.cameras[cam.camera_id] = cam

    def add_keyframe(self, kf: Keyframe) -> None:
        self.keyframes[kf.fid] = kf

    def nerfpp_norm(self) -> tuple[np.ndarray, float]:
        """getNerfppNorm (gaussian_scene.cpp:79-121): centroid + 1.1 * max
        camera-center distance."""
        centers = np.stack([kf.camera_center for kf in self.keyframes.values()])
        return nerfpp_norm(centers)
