"""DataLoader facade: per-frame (pose, colourised cloud, image).

Port of `gsdf_slam_tpu/data/loader.py`, the host-side equivalent of
dataloader::DataLoader::get_item (data_loader.cpp:113-330): read the image,
read the LiDAR or depth cloud, colourise by projection, and hand back
world-frame points and colours. Dataset dispatch mirrors the reference's
type enum (data_loader.cpp:14-43).

A LiDAR frame is read from its files and then colourised by
`colorize_frame`, a function of arrays: the torch op
`ops/colorize.py::colorize_pointcloud` on the loader's device (the card
unless told otherwise), followed by the compaction to the valid points.
The first `cloud_capacity` points of a scan are used, as in the JAX
package, with no padding. The RGB-D and stereo frames are numpy and cv2,
copied from the JAX package.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..ops.colorize import colorize_pointcloud
from ..utils.observability import span
from .base_parser import FrameSet, load_depth, load_image_rgb
from .kitti import KittiParser
from .pointcloud_io import read_points
from .replica import ReplicaParser, backproject_depth
from .spires import SpiresParser
from .tum import TumParser

DATASET_TYPES = {
    "replica": 0,
    "kitti": 3,
    "spires": 5,
    "tum": 6,
    "euroc": 7,
}


class FrameData(NamedTuple):
    cam_pose: np.ndarray  # [4,4] T_world_cam
    points: np.ndarray  # [M, 3] world-frame colorized points
    colors: np.ndarray  # [M, 3] float RGB
    image: np.ndarray  # [H, W, 3] float RGB


def colorize_frame(
    image: np.ndarray,
    points: np.ndarray,
    proj: np.ndarray,
    tr: np.ndarray,
    cam_pose: np.ndarray,
    lidar_pose: np.ndarray,
    device: torch.device | str = "cuda",
) -> FrameData:
    """A LiDAR frame from arrays: `points` [N, 3] in the LiDAR frame are
    colourised from `image` [H, W, 3] on `device` through P `proj` [3, 4]
    and Tr `tr` [4, 4], moved to the world by `lidar_pose`, and compacted
    to the valid ones, which come back to the host. Spans of the current
    tracer (`utils/observability.py`): "colourise.kernels",
    "colourise.readback"."""
    with span("colourise.kernels"):
        out = colorize_pointcloud(points, image, proj, tr, lidar_pose, device=device)
    with span("colourise.readback"):
        pts = out.points_world[out.valid].cpu().numpy()
        cols = out.colors[out.valid].cpu().numpy()
    return FrameData(cam_pose=cam_pose, points=pts, colors=cols, image=image)


class DataLoader:
    """Streams frames of any supported dataset; LiDAR clouds are
    colourised on `device`."""

    def __init__(
        self,
        dataset_path: str | Path,
        dataset_type: str,
        cloud_capacity: int = 1 << 17,
        cloud_stride: int = 1,
        device: torch.device | str = "cuda",
    ):
        self.type = dataset_type
        self.cloud_capacity = cloud_capacity
        self.cloud_stride = cloud_stride
        self.device = torch.device(device)
        if dataset_type == "kitti":
            self.parser = KittiParser(dataset_path)
        elif dataset_type == "spires":
            self.parser = SpiresParser(dataset_path)
        elif dataset_type == "replica":
            self.parser = ReplicaParser(dataset_path)
        elif dataset_type == "tum":
            self.parser = TumParser(dataset_path)
        elif dataset_type == "euroc":
            from .euroc import EurocParser

            self.parser = EurocParser(dataset_path)
        else:
            raise ValueError(f"unsupported dataset type: {dataset_type}")
        self.frames: FrameSet = self.parser.frames()

    def __len__(self) -> int:
        return len(self.frames)

    # -- lidar datasets ----------------------------------------------------
    def _get_item_lidar(self, idx: int) -> FrameData:
        fr = self.frames
        image = load_image_rgb(fr.color_files[idx])
        pts = read_points(fr.depth_files[idx])[:: self.cloud_stride][: self.cloud_capacity]
        cam_pose = fr.color_poses[idx]
        lidar_pose = fr.depth_poses[idx]

        intr = fr.intrinsics
        if self.type == "kitti":
            proj = self.parser.P.astype(np.float32)
            tr = self.parser.Tr.astype(np.float32)
        else:
            # Generic: project with K through T_cam_lidar = inv(T_W_C) @ T_W_L.
            k = np.array(
                [[intr.fx, 0, intr.cx, 0], [0, intr.fy, intr.cy, 0], [0, 0, 1, 0]],
                np.float32,
            )
            proj = k[:3, :4]
            tr = (np.linalg.inv(cam_pose.astype(np.float64)) @ lidar_pose).astype(
                np.float32
            )
        return colorize_frame(image, pts, proj, tr, cam_pose, lidar_pose, self.device)

    # -- rgbd datasets -----------------------------------------------------
    def _get_item_rgbd(self, idx: int) -> FrameData:
        fr = self.frames
        image = load_image_rgb(fr.color_files[idx])
        depth = load_depth(fr.depth_files[idx], self.parser.depth_scale)
        stride = max(self.cloud_stride, 1)
        pts_cam = backproject_depth(depth, fr.intrinsics, stride=stride)
        cam_pose = fr.color_poses[idx].astype(np.float64)
        pts_world = pts_cam @ cam_pose[:3, :3].T + cam_pose[:3, 3]
        ys, xs = np.meshgrid(
            np.arange(0, depth.shape[0], stride),
            np.arange(0, depth.shape[1], stride),
            indexing="ij",
        )
        dv = depth[ys, xs] > 0
        cols = image[ys, xs][dv]
        return FrameData(
            cam_pose=fr.color_poses[idx],
            points=pts_world.astype(np.float32),
            colors=cols.astype(np.float32),
            image=image,
        )

    # -- stereo datasets -----------------------------------------------------
    def _get_item_stereo(self, idx: int) -> FrameData:
        """EuRoC: SGBM depth on the rectified pair, backprojected and
        colorized from the rectified left image."""
        import cv2

        from .base_parser import CameraIntrinsics
        from .euroc import stereo_depth

        fr = self.frames
        rect = self.parser.rectification()
        left = cv2.imread(str(fr.color_files[idx]), cv2.IMREAD_GRAYSCALE)
        right = cv2.imread(str(fr.depth_files[idx]), cv2.IMREAD_GRAYSCALE)
        depth = stereo_depth(left, right, rect)
        left_rect = cv2.remap(left, *rect["maps0"], cv2.INTER_LINEAR)
        image = (
            np.repeat(left_rect[..., None], 3, axis=-1).astype(np.float32) / 255.0
        )

        p1 = rect["P1"]
        intr = CameraIntrinsics(
            p1[0, 0], p1[1, 1], p1[0, 2], p1[1, 2],
            depth.shape[1], depth.shape[0],
        )
        stride = max(self.cloud_stride, 1)
        pts_rect = backproject_depth(depth, intr, stride=stride)
        # rectified cam -> cam0 -> world
        r1 = rect["R1"]
        t_wc0 = fr.color_poses[idx].astype(np.float64)
        pts_c0 = pts_rect @ r1  # == (R1^T @ p)^T rows
        pts_world = pts_c0 @ t_wc0[:3, :3].T + t_wc0[:3, 3]
        ys, xs = np.meshgrid(
            np.arange(0, depth.shape[0], stride),
            np.arange(0, depth.shape[1], stride),
            indexing="ij",
        )
        dv = depth[ys, xs] > 0
        cols = image[ys, xs][dv]
        # pose of the rectified camera for rendering/training
        t_rect = np.eye(4)
        t_rect[:3, :3] = r1.T
        pose_rect = (t_wc0 @ t_rect).astype(np.float32)
        return FrameData(
            cam_pose=pose_rect,
            points=pts_world.astype(np.float32),
            colors=cols.astype(np.float32),
            image=image,
        )

    def get_item(self, idx: int) -> FrameData:
        if self.type in ("kitti", "spires"):
            return self._get_item_lidar(idx)
        if self.type == "euroc":
            return self._get_item_stereo(idx)
        return self._get_item_rgbd(idx)

    def get_pose(self, idx: int) -> np.ndarray:
        return self.frames.color_poses[idx]
