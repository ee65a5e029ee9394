"""Dataset parser base: pose-file formats, file lists, timestamp alignment.

Host-side NumPy re-implementation of dataparser::DataParser
(submodules/data_loader/data_parsers/base_parser.{h,cpp}). Pose formats
follow load_poses (base_parser.cpp:321-437):

  type 0: 4x4 matrix, 4 numbers per line (4 lines per pose)
  type 1: 4x4 matrix, 16 numbers on one line
  type 2: KITTI 3x4, 12 numbers on one line (row-major, bottom row = I)
  type 3: TUM: t x y z qx qy qz qw  (returns timestamps too)

A copy of `gsdf_slam_tpu/data/base_parser.py`, which imports no jax: the port keeps its own.
`cv2` and `yaml` are imported inside the functions that use them.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np


def _quat_xyzw_to_rot(q: np.ndarray) -> np.ndarray:
    """xyzw quaternion -> rotation matrix (utils::quat_to_rot with xyzw=true)."""
    x, y, z, w = q
    n = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float64,
    )


def load_poses(
    pose_path: str | Path, pose_type: int, with_head: bool = False
) -> tuple[np.ndarray, np.ndarray | None]:
    """Returns (poses [N,4,4] float32, timestamps [N] float64 or None)."""
    path = Path(pose_path)
    if not path.exists():
        raise FileNotFoundError(f"Pose file does not exist: {path}")
    if not with_head:
        from . import native_io

        fast = native_io.load_poses(path, pose_type)
        if fast is not None:
            return fast
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append([float(v) for v in line.split()])

    if with_head and rows:
        rows = rows[1:]

    poses, stamps = [], []
    if pose_type == 0:
        for i in range(0, len(rows) - 3, 4):
            poses.append(np.array(rows[i : i + 4], dtype=np.float64))
    elif pose_type == 1:
        for r in rows:
            poses.append(np.array(r[:16], dtype=np.float64).reshape(4, 4))
    elif pose_type == 2:
        for r in rows:
            m = np.eye(4, dtype=np.float64)
            m[:3, :4] = np.array(r[:12], dtype=np.float64).reshape(3, 4)
            poses.append(m)
    elif pose_type == 3:
        for r in rows:
            t, tx, ty, tz, qx, qy, qz, qw = r[:8]
            m = np.eye(4, dtype=np.float64)
            m[:3, :3] = _quat_xyzw_to_rot(np.array([qx, qy, qz, qw]))
            m[:3, 3] = [tx, ty, tz]
            poses.append(m)
            stamps.append(t)
    else:
        raise ValueError(f"unknown pose_type {pose_type}")
    poses_np = np.stack(poses).astype(np.float32) if poses else np.zeros((0, 4, 4), np.float32)
    return poses_np, (np.array(stamps) if stamps else None)


def list_files(directory: str | Path, suffix: str) -> list[Path]:
    """Sorted file listing, mirroring load_colors/load_depths collection."""
    d = Path(directory)
    if not d.is_dir():
        raise FileNotFoundError(f"directory does not exist: {d}")
    return sorted(p for p in d.iterdir() if p.name.endswith(suffix))


def align_by_timestamp(
    files: list[Path],
    poses: np.ndarray,
    stamps: np.ndarray,
    max_diff: float,
) -> tuple[list[Path], np.ndarray]:
    """align_pose_sensor (base_parser.cpp:440-...): match each file (whose
    stem is a timestamp) to the first pose within max_diff."""
    out_files, out_poses = [], []
    for f in files:
        try:
            t = float(f.stem)
        except ValueError:
            continue
        diffs = np.abs(t - stamps)
        hit = np.argmax(diffs < max_diff)  # first True (argmax on bool)
        if diffs[hit] < max_diff:
            out_files.append(f)
            out_poses.append(poses[hit])
    return out_files, (np.stack(out_poses).astype(np.float32) if out_poses else np.zeros((0, 4, 4), np.float32))


@dataclasses.dataclass
class CameraIntrinsics:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    # distortion coefficients (camera.h:31-70 dist_coeff_); None or
    # all-zero means the images are already rectified. Interpretation
    # depends on `model`: radtan (k1 k2 p1 p2 [k3]) for "pinhole",
    # Kannala-Brandt k1..k4 for "fisheye".
    dist: np.ndarray | None = None
    # camera projection model (camera.h:52-54 CameraModelType): "pinhole"
    # (id 1) or "fisheye" (id 2)
    model: str = "pinhole"


def intrinsics_from_yaml(path, camera: int = 1) -> CameraIntrinsics:
    """Parse an ORB_SLAM3-style sensor YAML into CameraIntrinsics.

    Handles the reference's config farm (cfg/ORB_SLAM3/**): `Camera.type`
    "PinHole" (radtan k1 k2 p1 p2 [k3]), "KannalaBrandt8"/"Fisheye"
    (Kannala-Brandt k1..k4 — the model id 2 rig of include/camera.h:52-54),
    or "Rectified" (no distortion). Keys may be namespaced `Camera1.fx`
    (ORB_SLAM3 >= 1.0) or legacy `Camera.fx`; `camera` selects the rig
    camera for the namespaced form (1 = left).
    """
    from ..engine.settings import parse_opencv_yaml

    kv = parse_opencv_yaml(path)

    def g(key, default=None):
        v = kv.get(f"Camera{camera}.{key}")
        if v is None:
            v = kv.get(f"Camera.{key}", default)
        return v

    ctype = str(kv.get("Camera.type", "PinHole")).lower()
    if ctype in ("kannalabrandt8", "fisheye"):
        model = "fisheye"
        dist = np.array(
            [g("k1", 0.0), g("k2", 0.0), g("k3", 0.0), g("k4", 0.0)], np.float64
        )
    elif ctype == "rectified":
        model = "pinhole"
        dist = None
    else:  # PinHole (radtan)
        model = "pinhole"
        dist = np.array(
            [g("k1", 0.0), g("k2", 0.0), g("p1", 0.0), g("p2", 0.0),
             g("k3", 0.0)],
            np.float64,
        )
    if dist is not None and not np.any(dist != 0):
        dist = None
    return CameraIntrinsics(
        fx=float(g("fx")), fy=float(g("fy")),
        cx=float(g("cx")), cy=float(g("cy")),
        width=int(kv.get("Camera.width", g("width", 0) or 0)),
        height=int(kv.get("Camera.height", g("height", 0) or 0)),
        dist=dist,
        model=model,
    )


@dataclasses.dataclass
class FrameSet:
    """Parsed dataset: per-frame image + cloud paths and world poses."""

    color_files: list[Path]
    depth_files: list[Path]
    color_poses: np.ndarray  # [N, 4, 4] T_world_cam
    depth_poses: np.ndarray  # [N, 4, 4] T_world_sensor (lidar/depth-cam)
    intrinsics: CameraIntrinsics

    def __len__(self) -> int:
        return min(len(self.color_files), len(self.depth_files))


def load_image_rgb(path: str | Path, scale: float = 1.0) -> np.ndarray:
    """Image as float32 RGB HWC in [0, 1].

    Note: the reference reads with cv::IMREAD_COLOR and never swaps, so it
    trains in BGR end-to-end (self-consistent since the colorization samples
    the same buffer). We use RGB — a deliberate, lossless deviation (channel
    permutation commutes with every loss)."""
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(f"could not read image: {path}")
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if scale != 1.0:
        img = cv2.resize(
            img, (int(img.shape[1] * scale), int(img.shape[0] * scale)),
            interpolation=cv2.INTER_AREA,
        )
    return img.astype(np.float32) / 255.0


def load_depth(path: str | Path, depth_scale: float) -> np.ndarray:
    """16-bit depth png -> float32 meters."""
    import cv2

    d = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if d is None:
        raise FileNotFoundError(f"could not read depth: {path}")
    return d.astype(np.float32) * depth_scale
