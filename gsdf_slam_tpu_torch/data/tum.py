"""TUM RGB-D dataset parser (fr1/fr2/fr3 sequences).

Standard TUM layout; association by nearest timestamp (the reference's
tum_mono mode got associations from ORB-SLAM3 — here we provide them
directly for the host-side tracking feed):

  rgb.txt / depth.txt:   "timestamp filename" listings
  groundtruth.txt:       "t tx ty tz qx qy qz qw" (pose type 3, T_W_C)

A copy of `gsdf_slam_tpu/data/tum.py`, which imports no jax: the port keeps its own.
`cv2` and `yaml` are imported inside the functions that use them.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .base_parser import CameraIntrinsics, FrameSet, load_poses

TUM_DEPTH_SCALE = 1.0 / 5000.0

# Default intrinsics per sequence family (TUM ROS defaults, incl. the
# radtan distortion the reference's cfg/ORB_SLAM3/Monocular TUM yamls
# carry — fr3 ships rectified).
TUM_INTRINSICS = {
    "fr1": CameraIntrinsics(
        517.3, 516.5, 318.6, 255.3, 640, 480,
        dist=np.array([0.2624, -0.9531, -0.0054, 0.0026, 1.1633]),
    ),
    "fr2": CameraIntrinsics(
        520.9, 521.0, 325.1, 249.7, 640, 480,
        dist=np.array([0.2312, -0.7849, -0.0033, -0.0001, 0.9172]),
    ),
    "fr3": CameraIntrinsics(535.4, 539.2, 320.1, 247.6, 640, 480),
}


def _read_listing(path: Path) -> tuple[np.ndarray, list[str]]:
    stamps, files = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t, name = line.split()[:2]
            stamps.append(float(t))
            files.append(name)
    return np.array(stamps), files


def _associate(t_a: np.ndarray, t_b: np.ndarray, max_diff: float = 0.02):
    """Nearest-timestamp association a->b."""
    out = []
    for i, t in enumerate(t_a):
        j = int(np.argmin(np.abs(t_b - t)))
        if abs(t_b[j] - t) < max_diff:
            out.append((i, j))
    return out


class TumParser:
    def __init__(self, sequence_path: str | Path, family: str = "fr1"):
        base = Path(sequence_path)
        self.base = base
        self.intrinsics = TUM_INTRINSICS[family]

        rgb_t, rgb_f = _read_listing(base / "rgb.txt")
        if (base / "depth.txt").exists():
            depth_t, depth_f = _read_listing(base / "depth.txt")
        else:  # rgb-only sequence (monocular mode)
            depth_t, depth_f = np.zeros(0), []
        gt, gt_t = load_poses(base / "groundtruth.txt", pose_type=3)

        if len(depth_t):
            rgb_depth = _associate(rgb_t, depth_t)
        else:
            # monocular mode (tum_mono.sh): rgb-only sequences are valid
            rgb_depth = [(i, None) for i in range(len(rgb_t))]
        self.color_files, self.depth_files, self.poses = [], [], []
        for i, j in rgb_depth:
            k = int(np.argmin(np.abs(gt_t - rgb_t[i])))
            if abs(gt_t[k] - rgb_t[i]) < 0.02:
                self.color_files.append(base / rgb_f[i])
                self.depth_files.append(
                    base / depth_f[j] if j is not None else None
                )
                self.poses.append(gt[k])
        self.poses = (
            np.stack(self.poses).astype(np.float32)
            if self.poses
            else np.zeros((0, 4, 4), np.float32)
        )
        self.depth_scale = TUM_DEPTH_SCALE

    def frames(self) -> FrameSet:
        return FrameSet(
            color_files=self.color_files,
            depth_files=self.depth_files,
            color_poses=self.poses,
            depth_poses=self.poses,
            intrinsics=self.intrinsics,
        )
