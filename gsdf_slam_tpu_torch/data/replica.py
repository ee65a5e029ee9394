"""Replica (SLAM RGB-D) dataset parser.

The reference consumed Replica through ORB-SLAM3 feeds plus
cfg/gaussian_mapper/RGB-D/Replica/*.yaml camera blocks; for the offline
known-pose mapping mode (BASELINE config #2) we parse the standard Replica
SLAM layout directly:

  <scene>/traj.txt                 # T_W_C, 16 numbers per line (pose type 1)
  <scene>/results/frame%06d.jpg    # color
  <scene>/results/depth%06d.png    # uint16 depth, scale 6553.5 counts/meter

Intrinsics follow the Replica cam_params (1200x680, fx=fy=600,
cx=599.5, cy=339.5) — the same values the reference's Replica yaml carries.

A copy of `gsdf_slam_tpu/data/replica.py`, which imports no jax: the port keeps its own.
`cv2` and `yaml` are imported inside the functions that use them.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .base_parser import CameraIntrinsics, FrameSet, list_files, load_poses

REPLICA_DEPTH_SCALE = 1.0 / 6553.5


class ReplicaParser:
    def __init__(self, scene_path: str | Path, intrinsics: CameraIntrinsics | None = None):
        base = Path(scene_path)
        self.base = base
        self.intrinsics = intrinsics or CameraIntrinsics(
            fx=600.0, fy=600.0, cx=599.5, cy=339.5, width=1200, height=680
        )
        poses, _ = load_poses(base / "traj.txt", pose_type=1)  # T_W_C
        self.poses = poses
        self.depth_scale = REPLICA_DEPTH_SCALE

    def frames(self) -> FrameSet:
        res = self.base / "results"
        colors = list_files(res, ".jpg")
        depths = list_files(res, ".png")
        n = min(len(colors), len(depths), len(self.poses))
        return FrameSet(
            color_files=colors[:n],
            depth_files=depths[:n],
            color_poses=self.poses[:n],
            depth_poses=self.poses[:n],
            intrinsics=self.intrinsics,
        )


def backproject_depth(
    depth: np.ndarray, intr: CameraIntrinsics, stride: int = 1
) -> np.ndarray:
    """Depth image -> camera-frame points [M, 3] (invalid depth dropped)."""
    h, w = depth.shape
    ys, xs = np.meshgrid(
        np.arange(0, h, stride), np.arange(0, w, stride), indexing="ij"
    )
    d = depth[ys, xs]
    valid = d > 0
    x = (xs - intr.cx) / intr.fx * d
    y = (ys - intr.cy) / intr.fy * d
    pts = np.stack([x[valid], y[valid], d[valid]], -1)
    return pts.astype(np.float32)
