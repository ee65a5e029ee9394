"""Oxford-Spires dataset parser.

Mirrors dataparser::Spires (data_parsers/oxford_spires_parser.hpp:10-198):
  <seq>/color_poses.txt   # 4x4, 16 per line (T_W_C)
  <seq>/depth_poses.txt   # 4x4, 16 per line (T_W_L)
  <seq>/undistorted_images/cam0/*.png
  <seq>/lidar-clouds/*.pcd

A copy of `gsdf_slam_tpu/data/spires.py`, which imports no jax: the port keeps its own.
"""

from __future__ import annotations

from pathlib import Path

from .base_parser import CameraIntrinsics, FrameSet, list_files, load_poses


class SpiresParser:
    def __init__(self, sequence_path: str | Path, intrinsics: CameraIntrinsics | None = None):
        base = Path(sequence_path)
        self.base = base
        # Spires cam0 (Sevilla rig) defaults; override via ctor if calibrated.
        self.intrinsics = intrinsics or CameraIntrinsics(
            fx=900.0, fy=900.0, cx=640.0, cy=360.0, width=1280, height=720
        )
        self.color_poses, _ = load_poses(base / "color_poses.txt", pose_type=1)
        self.depth_poses, _ = load_poses(base / "depth_poses.txt", pose_type=1)

    def frames(self) -> FrameSet:
        colors = list_files(self.base / "undistorted_images" / "cam0", ".png")
        depths = list_files(self.base / "lidar-clouds", ".pcd")
        n = min(len(colors), len(depths), len(self.color_poses), len(self.depth_poses))
        return FrameSet(
            color_files=colors[:n],
            depth_files=depths[:n],
            color_poses=self.color_poses[:n],
            depth_poses=self.depth_poses[:n],
            intrinsics=self.intrinsics,
        )
