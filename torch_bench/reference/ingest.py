"""Plain PyTorch reference of a keyframe's ingest: the LiDAR colouriser,
the RGB-D backprojection, and the map's growth (increasePcd) with its voxel
dedup and 3-NN scale init. It imports nothing of the program under test.

* colourise (the `cuda_colorize` kernel of GSDF-SLAM): each LiDAR point to
  the camera by Tr, projected by the 3x4 P, kept where the camera z > 0.2
  and the truncated pixel lies in the image; the pixel's colour; the point
  to the world by the LiDAR pose. Each affine is the kernel's sum of three
  products and the offset, in that order;
* backproject: the depth image at a stride of 4, pinhole, to the world;
* increasePcd (gaussian_model.cpp): a new point is kept unless its 5 cm
  voxel's hash (x 73856093 + y 19349663 + z 83492791 over the floored
  voxel indices, in 64-bit integers) is the hash of a Gaussian's voxel;
  each kept point becomes a Gaussian with SH DC from its colour, zero SH
  rest, opacity logit(0.1), identity rotation and log(sqrt(max(d, 1e-7)))
  in all three scales, d the mean squared distance to its 3 nearest other
  kept points.
"""

from __future__ import annotations

import math

import torch

VOXEL = 0.05
PRIMES = (73856093, 19349663, 83492791)
SH_C0 = 0.28209479177387814
KNN_BLOCK = 1024


def _affine(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return torch.stack([m[i, 0] * p[:, 0] + m[i, 1] * p[:, 1] + m[i, 2] * p[:, 2] + m[i, 3] for i in range(3)], -1)


def colourise(points, image, proj, tr, lidar_pose, dtype=torch.float32):
    """(world points [N', 3], colours [N', 3]) of the valid points of a
    scan [N, 3], in scan order."""
    p = points.to(dtype)
    p_cam = _affine(tr.to(dtype), p)
    p_proj = _affine(proj.to(dtype), p_cam)
    z = torch.where(p_proj[:, 2] == 0, torch.full_like(p_proj[:, 2], 1e-9), p_proj[:, 2])
    px = (p_proj[:, 0] / z).trunc()
    py = (p_proj[:, 1] / z).trunc()
    h, w = image.shape[0], image.shape[1]
    ok = (p_cam[:, 2] > 0.2) & (px >= 0) & (px < w) & (py >= 0) & (py < h)
    colours = image.to(dtype)[py[ok].long(), px[ok].long()]
    return _affine(lidar_pose.to(dtype), p)[ok], colours


def backproject(depth, image, t_wc, fx: float, fy: float, cx: float, cy: float, stride: int = 4,
                dtype=torch.float32):
    """(world points, colours) of the pixels at `stride` with depth > 0,
    in row-major order; the camera frame in float64, rounded to `dtype`."""
    dev = depth.device
    ys = torch.arange(0, depth.shape[0], stride, device=dev)
    xs = torch.arange(0, depth.shape[1], stride, device=dev)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    d = depth[yy, xx].to(torch.float64)
    ok = d > 0
    pc = torch.stack([(xx - cx) / fx * d, (yy - cy) / fy * d, d], -1)[ok].to(dtype).to(torch.float64)
    t = torch.as_tensor(t_wc, dtype=torch.float64, device=dev)
    world = pc @ t[:3, :3].T + t[:3, 3]
    return world.to(dtype), image[yy, xx][ok].to(dtype)


def voxel_hash(points: torch.Tensor) -> torch.Tensor:
    vi = torch.floor(points / torch.tensor(VOXEL, dtype=points.dtype, device=points.device)).to(torch.int64)
    return vi[:, 0] * PRIMES[0] + vi[:, 1] * PRIMES[1] + vi[:, 2] * PRIMES[2]


def knn3_mean_dist2(points: torch.Tensor) -> torch.Tensor:
    """Mean squared distance [N] to the 3 nearest other points, by brute
    force in blocks of rows; 0 for every point when N <= 3."""
    n = points.shape[0]
    out = torch.zeros(n, dtype=points.dtype, device=points.device)
    if n <= 3:
        return out
    for i in range(0, n, KNN_BLOCK):
        a = points[i : i + KNN_BLOCK]
        d2 = ((a[:, None, :] - points[None, :, :]) ** 2).sum(-1)
        # the smallest is the point itself (or a duplicate of it, also 0)
        out[i : i + KNN_BLOCK] = torch.topk(d2, 4, dim=1, largest=False).values[:, 1:].mean(1)
    return out


def grow(map_xyz: torch.Tensor, points: torch.Tensor, colours: torch.Tensor, n_rest: int = 15):
    """increasePcd: (keep mask over `points`, the new rows' parameters)."""
    keep = ~torch.isin(voxel_hash(points), voxel_hash(map_xyz.to(points.dtype)))
    pts, cols = points[keep], colours[keep]
    n = pts.shape[0]
    d2 = torch.clamp_min(knn3_mean_dist2(pts), 1e-7)
    rot = torch.zeros((n, 4), dtype=pts.dtype, device=pts.device)
    rot[:, 0] = 1
    new = {
        "xyz": pts,
        "f_dc": ((cols - 0.5) / SH_C0)[:, None, :],
        "f_rest": torch.zeros((n, n_rest, 3), dtype=pts.dtype, device=pts.device),
        "opacity": torch.full((n, 1), math.log(0.1 / 0.9), dtype=pts.dtype, device=pts.device),
        "scaling": torch.log(torch.sqrt(d2))[:, None].repeat(1, 3),
        "rotation": rot,
    }
    return keep, new
