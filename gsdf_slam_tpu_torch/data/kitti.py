"""KITTI odometry parser.

Mirrors dataparser::Kitti (data_parsers/kitti_parser.hpp:9-182):
  * calib.txt: P2 gives intrinsics; its baseline terms produce T_C0_C2 with
    t = (-P2[0,3]/fx, -P2[1,3]/fy, -P2[2,3]); Tr gives T_C0_L (velodyne ->
    cam0).
  * poses.txt: KITTI 3x4 rows = T_W_C0.
  * color_poses = T_W_C0 @ T_C0_C2, depth_poses = T_W_C0 @ T_C0_L.
  * image size hardcoded 1226x370 (kitti_parser.hpp:156-157).

A copy of `gsdf_slam_tpu/data/kitti.py`, which imports no jax: the port keeps its own.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .base_parser import CameraIntrinsics, FrameSet, list_files, load_poses


def parse_calib(calib_path: str | Path):
    p2 = None
    tr = np.eye(4, dtype=np.float64)
    with open(calib_path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag, vals = parts[0], [float(v) for v in parts[1:]]
            if len(vals) != 12:
                continue
            if tag == "P2:":
                p2 = np.array(vals, dtype=np.float64).reshape(3, 4)
            elif tag == "Tr:":
                tr = np.eye(4, dtype=np.float64)
                tr[:3, :4] = np.array(vals, dtype=np.float64).reshape(3, 4)
    if p2 is None:
        raise ValueError(f"calib has no P2: {calib_path}")
    return p2, tr


class KittiParser:
    def __init__(self, dataset_path: str | Path):
        base = Path(dataset_path)
        self.base = base
        self.P, self.Tr = parse_calib(base / "calib.txt")  # P: 3x4, Tr: T_C0_L
        fx, fy = self.P[0, 0], self.P[1, 1]
        cx, cy = self.P[0, 2], self.P[1, 2]
        self.intrinsics = CameraIntrinsics(fx, fy, cx, cy, width=1226, height=370)

        t_c0_c2 = np.eye(4, dtype=np.float64)
        t_c0_c2[0, 3] = -self.P[0, 3] / fx
        t_c0_c2[1, 3] = -self.P[1, 3] / fy
        t_c0_c2[2, 3] = -self.P[2, 3]
        self.T_C0_C2 = t_c0_c2
        self.T_C0_L = self.Tr

        t_w_c0, _ = load_poses(base / "poses.txt", pose_type=2)
        self.color_poses = (t_w_c0.astype(np.float64) @ t_c0_c2).astype(np.float32)
        self.depth_poses = (t_w_c0.astype(np.float64) @ self.Tr).astype(np.float32)

    def frames(self) -> FrameSet:
        colors = list_files(self.base / "image_2", ".png")
        depths = list_files(self.base / "velodyne", ".bin")
        n = min(len(colors), len(depths), len(self.color_poses))
        return FrameSet(
            color_files=colors[:n],
            depth_files=depths[:n],
            color_poses=self.color_poses[:n],
            depth_poses=self.depth_poses[:n],
            intrinsics=self.intrinsics,
        )
