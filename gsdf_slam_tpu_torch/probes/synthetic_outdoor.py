"""Deterministic synthetic outdoor scene (KITTI operating mode fixture).

Ground plane + roadside boxes + bright sky, raycast analytically. Used by
the outdoor streaming test: the LiDAR+camera pipeline (colorized cloud per
frame, 1 training iteration per frame, live sky segmentation) runs on this
scene end-to-end, matching the reference's train_kitti mode
(the reference's src/gaussian_mapper.cpp:160-333) without shipping data.

Convention: OpenCV camera (x right, y DOWN, z forward); the world ground
plane is y = +1.5, the camera drives along +z at y = 0.

A numpy copy of `benchmarks/synthetic_outdoor.py` (the port imports nothing
of `benchmarks/`), with `lidar_scan`, a seeded 360-degree scan in the LiDAR
frame for the colouriser, and the KITTI-style calibration it is taken
with (`kitti_calibration`).
"""

from __future__ import annotations

import numpy as np

from .synthetic_room import camera_rays

GROUND_Y = 1.5

# roadside boxes: (center_x, center_z, half_w, half_d, height, rgb)
_BOXES = [
    (-4.0, 8.0, 1.0, 1.0, 2.5, (0.55, 0.25, 0.20)),
    (4.5, 14.0, 1.2, 1.5, 3.0, (0.20, 0.35, 0.55)),
    (-5.0, 22.0, 1.5, 1.0, 2.0, (0.30, 0.45, 0.25)),
    (4.0, 30.0, 1.0, 2.0, 3.5, (0.45, 0.40, 0.20)),
    (-3.5, 38.0, 1.2, 1.2, 2.8, (0.35, 0.25, 0.45)),
]


def _sky(d: np.ndarray) -> np.ndarray:
    """Bright sky by elevation (above-horizon rays): the brightness-style
    segmenter used in tests masks exactly this region."""
    up = np.clip(-d[..., 1], 0.0, 1.0)  # -y is up
    return np.stack(
        [0.75 + 0.2 * up, 0.8 + 0.15 * up, 0.9 + 0.1 * up], axis=-1
    )


def _ground_tex(x: np.ndarray, z: np.ndarray) -> np.ndarray:
    checker = ((np.floor(x / 1.0) + np.floor(z / 1.0)) % 2.0)[..., None]
    a = np.array([0.32, 0.30, 0.28])
    b = np.array([0.22, 0.22, 0.24])
    base = a[None, :] * checker + b[None, :] * (1 - checker)
    return np.clip(base + 0.05 * np.sin(0.7 * z)[..., None], 0.05, 0.5)


def raycast_outdoor(t_wc: np.ndarray, width: int, height: int, fov=np.pi / 2):
    """(rgb [H,W,3], zdepth [H,W]); sky pixels carry depth = inf."""
    o, d = camera_rays(t_wc, width, height, fov)

    best_t = np.full((height, width), np.inf)
    rgb = _sky(d / np.linalg.norm(d, axis=-1, keepdims=True))

    # ground plane y = GROUND_Y
    with np.errstate(divide="ignore", invalid="ignore"):
        tg = (GROUND_Y - o[1]) / d[..., 1]
    gx = o[0] + tg * d[..., 0]
    gz = o[2] + tg * d[..., 2]
    ok = (tg > 1e-6) & (tg < best_t) & (np.abs(gx - o[0]) < 60) & (gz - o[2] < 80)
    rgb[ok] = _ground_tex(gx[ok], gz[ok])
    best_t[ok] = tg[ok]

    # boxes: slab intersection per AABB
    for bx, bz, hw, hd, h, color in _BOXES:
        lo = np.array([bx - hw, GROUND_Y - h, bz - hd])
        hi = np.array([bx + hw, GROUND_Y, bz + hd])
        with np.errstate(divide="ignore", invalid="ignore"):
            t0 = (lo[None, None, :] - o[None, None, :]) / d
            t1 = (hi[None, None, :] - o[None, None, :]) / d
        tmin = np.minimum(t0, t1).max(axis=-1)
        tmax = np.maximum(t0, t1).min(axis=-1)
        ok = (tmax > tmin) & (tmin > 1e-6) & (tmin < best_t)
        hit = o[None, :] + tmin[ok, None] * d[ok]
        shade = 0.8 + 0.2 * np.clip((GROUND_Y - hit[:, 1]) / h, 0, 1)
        rgb[ok] = np.asarray(color)[None, :] * shade[:, None]
        best_t[ok] = tmin[ok]

    return rgb.astype(np.float32), best_t.astype(np.float32)


def drive_pose(dist: float, sway: float = 0.0) -> np.ndarray:
    """T_wc: camera at (sway, 0, dist) looking down +z."""
    t = np.eye(4, dtype=np.float32)
    t[0, 3] = sway
    t[2, 3] = dist
    return t


def lidar_cloud(t_wc, width, height, fov=np.pi / 2, stride=4):
    """Colorized-LiDAR stand-in: world points + colors sampled from the
    raycast at a pixel stride (the cuda_colorize product, SURVEY §2.1)."""
    rgb, depth = raycast_outdoor(t_wc, width, height, fov)
    fx = 0.5 * width / np.tan(fov / 2)
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    ys, xs = np.mgrid[0:height:stride, 0:width:stride]
    z = depth[ys, xs]
    ok = np.isfinite(z) & (z < 60.0)
    zc = z[ok].astype(np.float64)
    xc = (xs[ok] - cx) / fx * zc
    yc = (ys[ok] - cy) / fx * zc
    pts_cam = np.stack([xc, yc, zc], -1)
    t = t_wc.astype(np.float64)
    pts_w = (pts_cam @ t[:3, :3].T + t[:3, 3]).astype(np.float32)
    cols = rgb[ys, xs][ok].astype(np.float32)
    return pts_w, cols


# the KITTI rig's axes (Tr_velo_to_cam): camera x = -LiDAR y, camera y =
# -LiDAR z, camera z = LiDAR x; the LiDAR sits 8 cm above and 27 cm behind
# the camera (a KITTI calib.txt's Tr, rounded)
TR_VELO_TO_CAM = np.array(
    [[0.0, -1.0, 0.0, 0.0], [0.0, 0.0, -1.0, -0.08], [1.0, 0.0, 0.0, -0.27], [0.0, 0.0, 0.0, 1.0]],
    np.float32,
)
# an HDL-64E: 64 beams from +2 to -24.8 degrees of elevation, about 120 m
HDL64_ELEVATION_DEG = (2.0, -24.8)
HDL64_BEAMS = 64
HDL64_RANGE = 120.0


def kitti_calibration(width: int, height: int):
    """(P [3, 4], Tr [4, 4]) of a camera with `raycast_outdoor`'s default
    pinhole (90 degrees across, fx = fy, principal point at the centre) and
    the KITTI rig's LiDAR."""
    fx = 0.5 * width
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    proj = np.array([[fx, 0, cx, 0], [0, fx, cy, 0], [0, 0, 1, 0]], np.float32)
    return proj, TR_VELO_TO_CAM.copy()


def lidar_scan(t_wc: np.ndarray, n: int = 120_000, seed: int = 0) -> np.ndarray:
    """A seeded HDL-64E-style scan over 360 degrees, in the LiDAR frame
    [n, 3] float32: 64 beams of elevation, azimuths with a seeded jitter,
    each ray cast from the LiDAR (pose t_wc @ Tr of the camera t_wc)
    against the ground and the boxes up to 120 m; n of the returns, drawn
    with the seed. The sky returns nothing."""
    rng = np.random.default_rng(seed)
    lidar_pose = t_wc.astype(np.float64) @ TR_VELO_TO_CAM.astype(np.float64)
    n_az = int(np.ceil(1.4 * n / HDL64_BEAMS))
    el = np.deg2rad(np.linspace(*HDL64_ELEVATION_DEG, HDL64_BEAMS))[:, None] + rng.normal(0, 1e-3, (HDL64_BEAMS, n_az))
    az = 2 * np.pi * (np.arange(n_az)[None, :] + rng.uniform(0, 1, (HDL64_BEAMS, n_az))) / n_az
    d_l = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], -1).reshape(-1, 3)
    o = lidar_pose[:3, 3]
    d = d_l @ lidar_pose[:3, :3].T

    best_t = np.full(len(d), np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):
        tg = (GROUND_Y - o[1]) / d[:, 1]
    ok = tg > 1e-6
    best_t[ok] = tg[ok]
    for bx, bz, hw, hd, h, _ in _BOXES:
        lo = np.array([bx - hw, GROUND_Y - h, bz - hd])
        hi = np.array([bx + hw, GROUND_Y, bz + hd])
        with np.errstate(divide="ignore", invalid="ignore"):
            t0 = (lo[None, :] - o[None, :]) / d
            t1 = (hi[None, :] - o[None, :]) / d
        tmin = np.minimum(t0, t1).max(axis=-1)
        tmax = np.maximum(t0, t1).min(axis=-1)
        hit = (tmax > tmin) & (tmin > 1e-6) & (tmin < best_t)
        best_t[hit] = tmin[hit]
    hits = np.flatnonzero(best_t <= HDL64_RANGE)
    if len(hits) < n:
        raise ValueError(f"the scan has {len(hits)} returns, fewer than {n}")
    keep = np.sort(rng.choice(hits, n, replace=False))
    return (d_l[keep] * best_t[keep, None]).astype(np.float32)
