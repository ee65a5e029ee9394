"""Coordinate-system conversions (submodules/utils/coordinates.{h,cpp}).

World/camera conventions used by the supported datasets: OpenCV (x right,
y down, z forward — KITTI cameras, TUM, Replica), OpenGL/Blender (y up,
z backward — some viewers), and the KITTI LiDAR frame (x forward, y left,
z up).

A copy of `gsdf_slam_tpu/utils/coordinates.py`, numpy only.
"""

from __future__ import annotations

import numpy as np

# change-of-basis matrices C such that p_opencv = C @ p_other
OPENGL_TO_OPENCV = np.diag([1.0, -1.0, -1.0])
BLENDER_TO_OPENCV = OPENGL_TO_OPENCV
KITTI_LIDAR_TO_OPENCV = np.array(
    [[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]]
)

_SYSTEMS = {
    "opencv": np.eye(3),
    "opengl": OPENGL_TO_OPENCV,
    "blender": BLENDER_TO_OPENCV,
    "kitti_lidar": KITTI_LIDAR_TO_OPENCV,
}


def convert_points(points: np.ndarray, src: str, dst: str = "opencv") -> np.ndarray:
    c = _SYSTEMS[dst].T @ _SYSTEMS[src]
    return points @ c.T


def convert_pose(t: np.ndarray, src: str, dst: str = "opencv") -> np.ndarray:
    """Re-express a camera-to-world pose whose CAMERA axes follow `src`."""
    c = _SYSTEMS[dst].T @ _SYSTEMS[src]
    out = np.array(t, np.float64, copy=True)
    out[:3, :3] = t[:3, :3] @ np.linalg.inv(c)
    return out


def change_world_system(poses: np.ndarray, src: str, dst: str = "opencv") -> np.ndarray:
    """Rotate the WORLD frame of a batch of poses (coordinates.h:33-66)."""
    c = _SYSTEMS[dst].T @ _SYSTEMS[src]
    m = np.eye(4)
    m[:3, :3] = c
    return (m[None] @ np.asarray(poses, np.float64)).astype(np.float32)
