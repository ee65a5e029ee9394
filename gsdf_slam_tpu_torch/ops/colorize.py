"""LiDAR point-cloud colourisation by camera projection.

Port of `gsdf_slam_tpu/ops/colorize.py`, the reference's cuda_colorize
kernel (cuda_colorize/colorize_pointcloud.cu:14-56), which the JAX package
wrote as XLA ops: transform each LiDAR point to the camera frame by
Tr_velo_to_cam, project it with the 3x4 P, keep the points with camera z >
0.2 that land inside the image, take the pixel's colour (nearest, by the
truncating cast of the CUDA code's (int)), and transform the point to the
world by the LiDAR pose.

Each affine is the JAX package's four-term sum in its order, as separate
elementwise ops, never a matmul: the pixel index is a truncating cast of
p_proj / z, so a last-bit difference would move a point to the next pixel.
The function returns a validity mask, as the JAX package does; the caller
compacts (`data/loader.py::colorize_frame`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ColorizedCloud(NamedTuple):
    points_world: torch.Tensor  # [N, 3]
    colors: torch.Tensor  # [N, 3]
    valid: torch.Tensor  # [N] bool


def _affine(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [m[i, 0] * p[:, 0] + m[i, 1] * p[:, 1] + m[i, 2] * p[:, 2] + m[i, 3] for i in range(3)], dim=-1
    )


def colorize_pointcloud(
    points,  # [N, 3] in the LiDAR frame
    image,  # [H, W, 3] float RGB
    proj,  # [3, 4] camera projection P
    tr_velo_to_cam,  # [4, 4]
    lidar_pose,  # [4, 4] T_world_lidar
    device: torch.device | str | None = None,
) -> ColorizedCloud:
    """Colourise a scan on `device`: by default the device of `points` when
    it is a tensor, else the card. Arrays are taken as float32."""
    if device is None:
        device = points.device if isinstance(points, torch.Tensor) else "cuda"
    points, image, proj, tr_velo_to_cam, lidar_pose = (
        torch.as_tensor(a, dtype=torch.float32, device=device)
        for a in (points, image, proj, tr_velo_to_cam, lidar_pose)
    )
    h, w = image.shape[0], image.shape[1]
    p_cam = _affine(points, tr_velo_to_cam)
    p_proj = _affine(p_cam, proj)
    in_front = p_cam[:, 2] > 0.2
    z = torch.where(p_proj[:, 2] == 0, 1e-9, p_proj[:, 2])
    px = (p_proj[:, 0] / z).to(torch.int32)
    py = (p_proj[:, 1] / z).to(torch.int32)
    valid = in_front & (px >= 0) & (px < w) & (py >= 0) & (py < h)
    colors = image[torch.clamp(py, 0, h - 1).long(), torch.clamp(px, 0, w - 1).long()]
    return ColorizedCloud(points_world=_affine(points, lidar_pose), colors=colors, valid=valid)
