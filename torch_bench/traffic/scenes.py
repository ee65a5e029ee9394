"""The benchmark's synthetic scenes, raycast on the device in float64.

PyTorch copies of the numpy fixtures in `gsdf_slam_tpu_torch/probes/`
(`synthetic_room.py`: the textured box room; `synthetic_outdoor.py`: the
street and the HDL-64E-style scan), kept here so that the yardstick does
not move when the program's probes change. Two departures, both for the
benchmark's traffic:

* the street is periodic: its boxes repeat every `period` metres along the
  road (copies at z + j * period), and its ground texture's sinusoid has a
  whole number of periods in one, so a pose moved on by `period` sees the
  same frame;
* the scan's jitter and the choice of its returns come from a
  `torch.Generator`, not numpy's.

Camera convention (OpenCV): +x right, +y down, +z forward; the ray
parameter equals the z-depth (unit camera z), principal point at the image
centre.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

ROOM_MIN = (-2.0, -2.0, -1.5)
ROOM_MAX = (2.0, 2.0, 1.5)
# per-face base colours (+x, -x, +y, -y, +z, -z)
FACE_A = (
    (0.85, 0.45, 0.35), (0.35, 0.55, 0.85), (0.45, 0.80, 0.45),
    (0.85, 0.75, 0.35), (0.80, 0.80, 0.85), (0.45, 0.40, 0.40),
)
FACE_B = (
    (0.55, 0.25, 0.20), (0.20, 0.30, 0.55), (0.25, 0.50, 0.30),
    (0.55, 0.45, 0.20), (0.55, 0.55, 0.65), (0.25, 0.22, 0.25),
)

GROUND_Y = 1.5
# the probe's street: (centre x, centre z, half width, half depth, height, rgb)
PROBE_BOXES = (
    (-4.0, 8.0, 1.0, 1.0, 2.5, (0.55, 0.25, 0.20)),
    (4.5, 14.0, 1.2, 1.5, 3.0, (0.20, 0.35, 0.55)),
    (-5.0, 22.0, 1.5, 1.0, 2.0, (0.30, 0.45, 0.25)),
    (4.0, 30.0, 1.0, 2.0, 3.5, (0.45, 0.40, 0.20)),
    (-3.5, 38.0, 1.2, 1.2, 2.8, (0.35, 0.25, 0.45)),
)
PROBE_GROUND_FREQ = 0.7  # rad/m of the probe's ground sinusoid

# the KITTI rig (Tr_velo_to_cam): camera x = -LiDAR y, camera y = -LiDAR z,
# camera z = LiDAR x; the LiDAR 8 cm above and 27 cm behind the camera
TR_VELO_TO_CAM = (
    (0.0, -1.0, 0.0, 0.0), (0.0, 0.0, -1.0, -0.08), (1.0, 0.0, 0.0, -0.27), (0.0, 0.0, 0.0, 1.0),
)


def camera_rays(t_wc: torch.Tensor, width: int, height: int, fx: float, fy: float | None = None):
    """(origin [3], world ray directions [H, W, 3] with unit camera z) of a
    pinhole of focals `fx`, `fy` (square pixels if `fy` is None) at pose
    T_wc [4, 4] float64."""
    dev = t_wc.device
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float64, device=dev),
        torch.arange(width, dtype=torch.float64, device=dev), indexing="ij",
    )
    d_cam = torch.stack([(xs - cx) / fx, (ys - cy) / (fx if fy is None else fy), torch.ones_like(xs)], -1)
    return t_wc[:3, 3], d_cam @ t_wc[:3, :3].T


# ------------------------------------------------------------------ room
def _face_texture(face: int, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Smooth gradients and a 0.5 m checker in [0.02, 0.98]; u, v in metres."""
    a = torch.tensor(FACE_A[face], dtype=torch.float64, device=u.device)
    b = torch.tensor(FACE_B[face], dtype=torch.float64, device=u.device)
    checker = torch.remainder(torch.floor(u / 0.5) + torch.floor(v / 0.5), 2.0)[..., None]
    base = a * checker + b * (1 - checker)
    grad = 0.15 * torch.sin(1.7 * u + 0.9 * face)[..., None] + 0.1 * torch.cos(2.3 * v - 0.4 * face)[..., None]
    return torch.clamp(base + grad, 0.02, 0.98)


def raycast_room(t_wc: torch.Tensor, width: int, height: int, fx: float, room_min=ROOM_MIN, room_max=ROOM_MAX,
                 fy: float | None = None):
    """(rgb [H, W, 3] float32, z-depth [H, W] float32) of the interior of
    the box [room_min, room_max] from T_wc, as
    `probes/synthetic_room.py::raycast_room` (its plain scene, `hard=False`,
    in the probe's box by default); `fy` as in `camera_rays`."""
    o, d = camera_rays(t_wc, width, height, fx, fy)
    best_t = torch.full((height, width), math.inf, dtype=torch.float64, device=d.device)
    rgb = torch.zeros((height, width, 3), dtype=torch.float64, device=d.device)
    face = 0
    for ax, ua, va in ((0, 1, 2), (1, 0, 2), (2, 0, 1)):
        for bound in (room_max[ax], room_min[ax]):
            t = (bound - o[ax]) / d[..., ax]
            hit_u = o[ua] + t * d[..., ua]
            hit_v = o[va] + t * d[..., va]
            ok = (
                (t > 1e-6) & (t < best_t)
                & (hit_u >= room_min[ua] - 1e-9) & (hit_u <= room_max[ua] + 1e-9)
                & (hit_v >= room_min[va] - 1e-9) & (hit_v <= room_max[va] + 1e-9)
            )
            rgb = torch.where(ok[..., None], _face_texture(face, hit_u, hit_v), rgb)
            best_t = torch.where(ok, t, best_t)
            face += 1
    return rgb.to(torch.float32), best_t.to(torch.float32)


def room_pose(yaw: float, pitch: float = 0.0, radius: float = 0.3, offset=None) -> torch.Tensor:
    """T_wc [4, 4] float64 (host) looking outward at `yaw` and `pitch`,
    from `radius` along the yaw direction, or from `offset` [3] if given."""
    cy_, sy, cp, sp = math.cos(yaw), math.sin(yaw), math.cos(pitch), math.sin(pitch)
    fwd = torch.tensor([cy_ * cp, sy * cp, sp], dtype=torch.float64)
    right = torch.tensor([-sy, cy_, 0.0], dtype=torch.float64)
    down = torch.linalg.cross(fwd, right)
    t = torch.eye(4, dtype=torch.float64)
    t[:3, 0], t[:3, 1], t[:3, 2] = right, down, fwd
    t[:3, 3] = torch.tensor([cy_, sy, 0.0], dtype=torch.float64) * radius if offset is None else offset
    return t


def room_lap_poses(n_frames: int) -> list[torch.Tensor]:
    """`make_sequence`'s trajectory: two yaw rings, pitch -0.2 then +0.2."""
    per_ring = max(1, n_frames // 2)
    out = []
    for i in range(n_frames):
        ring = i // per_ring
        yaw = 2 * math.pi * (i % per_ring) / per_ring + 0.1 * ring
        out.append(room_pose(yaw, -0.2 if ring == 0 else 0.2))
    return out


# ---------------------------------------------------------------- street
@dataclass(frozen=True)
class Street:
    """Ground plane y = ground_y, axis-aligned boxes standing on it, sky.
    `boxes` [B, 6] (lo xyz, hi xyz) and `colors` [B, 3], float64; with
    `period`, every box repeats at z + j * period."""

    boxes: torch.Tensor
    colors: torch.Tensor
    ground_freq: float = PROBE_GROUND_FREQ
    period: float | None = None
    ground_y: float = GROUND_Y

    def boxes_near(self, z: float, reach: float) -> tuple[torch.Tensor, torch.Tensor]:
        """The boxes, with their copies along the road within `reach` of z."""
        if self.period is None:
            return self.boxes, self.colors
        j0 = math.floor((z - reach) / self.period) - 1
        j1 = math.floor((z + reach) / self.period) + 1
        shifts = torch.arange(j0, j1 + 1, dtype=torch.float64, device=self.boxes.device) * self.period
        off = torch.zeros((len(shifts), 1, 6), dtype=torch.float64, device=self.boxes.device)
        off[:, 0, 2] = shifts
        off[:, 0, 5] = shifts
        return (self.boxes[None] + off).reshape(-1, 6), self.colors.repeat(len(shifts), 1)


def probe_street(device="cpu") -> Street:
    """`probes/synthetic_outdoor.py`'s five boxes, not periodic."""
    lo_hi, cols = [], []
    for bx, bz, hw, hd, h, c in PROBE_BOXES:
        lo_hi.append((bx - hw, GROUND_Y - h, bz - hd, bx + hw, GROUND_Y, bz + hd))
        cols.append(c)
    f = lambda a: torch.tensor(a, dtype=torch.float64, device=device)
    return Street(f(lo_hi), f(cols))


def periodic_street(gen: torch.Generator, period: float, boxes: dict, ground_y: float = GROUND_Y,
                    device="cpu") -> Street:
    """A street of `count` boxes along one period, the ground the plane y =
    ground_y. `boxes` holds the ranges ([lo, hi]) of the boxes' half width,
    half depth, height, lateral offset, place in their slot and colour.
    Every seed gets the same set of values of each (evenly spread over its
    range) and of sides (half on each), each set in an order drawn from
    `gen`: the seed moves the boxes, not the work. Box k sits in the k-th
    of `count` equal slots of the period."""
    n = int(boxes["count"])
    spread = (torch.arange(n, dtype=torch.float64) + 0.5) / n

    def values(key):
        lo, hi = boxes[key]
        return lo + (hi - lo) * spread[torch.randperm(n, generator=gen)]

    hw, hd, h, lat = values("half_width"), values("half_depth"), values("height"), values("lateral")
    place = spread[torch.randperm(n, generator=gen)] - 0.5
    side = torch.where(torch.arange(n) < n // 2, -1.0, 1.0)[torch.randperm(n, generator=gen)].double()
    slot = period / n
    zc = (torch.arange(n, dtype=torch.float64) + 0.5) * slot + place * (slot - 2 * hd - 1.0)
    xc = side * (lat + hw)
    lo_hi = torch.stack([xc - hw, ground_y - h, zc - hd, xc + hw, torch.full_like(h, ground_y), zc + hd], -1)
    colors = torch.stack([values("color") for _ in range(3)], -1)
    # a whole number of the ground sinusoid's periods in one street period
    freq = 2 * math.pi * max(1, round(PROBE_GROUND_FREQ * period / (2 * math.pi))) / period
    return Street(lo_hi.to(device), colors.to(device), freq, period, ground_y)


def _sky(d: torch.Tensor) -> torch.Tensor:
    up = torch.clamp(-d[..., 1], 0.0, 1.0)
    return torch.stack([0.75 + 0.2 * up, 0.8 + 0.15 * up, 0.9 + 0.1 * up], -1)


def _ground_tex(x: torch.Tensor, z: torch.Tensor, freq: float) -> torch.Tensor:
    checker = torch.remainder(torch.floor(x / 1.0) + torch.floor(z / 1.0), 2.0)[..., None]
    a = torch.tensor([0.32, 0.30, 0.28], dtype=torch.float64, device=x.device)
    b = torch.tensor([0.22, 0.22, 0.24], dtype=torch.float64, device=x.device)
    return torch.clamp(a * checker + b * (1 - checker) + 0.05 * torch.sin(freq * z)[..., None], 0.05, 0.5)


BOX_CHUNK = 16


def _first_box_hit(o: torch.Tensor, d: torch.Tensor, boxes: torch.Tensor):
    """(entry parameter, box index) of each ray d [R, 3] from o into the
    nearest of `boxes` [B, 6] it enters at t > 1e-6 (inf and -1 where none);
    a tie goes to the lower index, as a loop over the boxes in order would
    give it."""
    best = torch.full(d.shape[:1], math.inf, dtype=d.dtype, device=d.device)
    which = torch.full(d.shape[:1], -1, dtype=torch.long, device=d.device)
    for b0 in range(0, boxes.shape[0], BOX_CHUNK):
        bx = boxes[b0 : b0 + BOX_CHUNK]
        t0 = (bx[None, :, :3] - o) / d[:, None, :]
        t1 = (bx[None, :, 3:] - o) / d[:, None, :]
        tmin = torch.minimum(t0, t1).amax(-1)
        tmax = torch.maximum(t0, t1).amin(-1)
        t = torch.where((tmax > tmin) & (tmin > 1e-6), tmin, math.inf)
        tb, kb = t.min(1)
        better = tb < best
        best = torch.where(better, tb, best)
        which = torch.where(better, kb + b0, which)
    return best, which


def raycast_street(street: Street, t_wc: torch.Tensor, width: int, height: int, fx: float):
    """(rgb [H, W, 3] float32, z-depth [H, W] float32, inf on the sky), as
    `probes/synthetic_outdoor.py::raycast_outdoor` on `street`."""
    o, d = camera_rays(t_wc, width, height, fx)
    best_t = torch.full((height, width), math.inf, dtype=torch.float64, device=d.device)
    rgb = _sky(d / torch.linalg.vector_norm(d, dim=-1, keepdim=True))
    tg = (street.ground_y - o[1]) / d[..., 1]
    gx = o[0] + tg * d[..., 0]
    gz = o[2] + tg * d[..., 2]
    ok = (tg > 1e-6) & (tg < best_t) & ((gx - o[0]).abs() < 60) & (gz - o[2] < 80)
    rgb = torch.where(ok[..., None], _ground_tex(gx, gz, street.ground_freq), rgb)
    best_t = torch.where(ok, tg, best_t)
    boxes, colors = street.boxes_near(float(o[2]), 120.0)
    tb, kb = _first_box_hit(o, d.reshape(-1, 3), boxes)
    tb, kb = tb.reshape(height, width), kb.reshape(height, width)
    ok = tb < best_t
    k = kb.clamp_min(0)
    hit_y = o[1] + tb * d[..., 1]
    h = boxes[k, 4] - boxes[k, 1]
    shade = 0.8 + 0.2 * torch.clamp((street.ground_y - hit_y) / h, 0, 1)
    rgb = torch.where(ok[..., None], colors[k] * shade[..., None], rgb)
    best_t = torch.where(ok, tb, best_t)
    return rgb.to(torch.float32), best_t.to(torch.float32)


def drive_pose(dist: float, sway: float = 0.0) -> torch.Tensor:
    """T_wc [4, 4] float64: the camera at (sway, 0, dist) looking down +z."""
    t = torch.eye(4, dtype=torch.float64)
    t[0, 3] = sway
    t[2, 3] = dist
    return t


# ------------------------------------------------------------------ scan
HDL64_ELEVATION_DEG = (2.0, -24.8)
HDL64_BEAMS = 64
HDL64_RANGE = 120.0


def scan_azimuths(n: int) -> int:
    """Azimuth steps of a scan of n returns (the probe's 1.4 n / 64)."""
    return int(math.ceil(1.4 * n / HDL64_BEAMS))


def scan_rays(el_noise: torch.Tensor, az_u: torch.Tensor) -> torch.Tensor:
    """Unit ray directions [64 * n_az, 3] in the LiDAR frame from the
    elevation jitter (radians) and the azimuth fractions [64, n_az]."""
    n_az = el_noise.shape[1]
    lo, hi = HDL64_ELEVATION_DEG
    # numpy's linspace: start + i * step, the last one exactly the stop
    deg = lo + torch.arange(HDL64_BEAMS, dtype=torch.float64, device=el_noise.device) * ((hi - lo) / (HDL64_BEAMS - 1))
    deg[-1] = hi
    el = torch.deg2rad(deg)[:, None] + el_noise
    az = 2 * math.pi * (torch.arange(n_az, dtype=torch.float64, device=el_noise.device)[None, :] + az_u) / n_az
    return torch.stack([torch.cos(el) * torch.cos(az), torch.cos(el) * torch.sin(az), torch.sin(el)], -1).reshape(-1, 3)


def cast_scan(street: Street, t_wc: torch.Tensor, d_l: torch.Tensor) -> torch.Tensor:
    """The range [R] of each LiDAR ray d_l [R, 3] (inf where it returns
    nothing within HDL64_RANGE), the LiDAR at t_wc @ Tr."""
    tr = torch.tensor(TR_VELO_TO_CAM, dtype=torch.float64, device=d_l.device)
    lidar_pose = t_wc @ tr
    o = lidar_pose[:3, 3]
    d = d_l @ lidar_pose[:3, :3].T
    best_t = torch.full((d.shape[0],), math.inf, dtype=torch.float64, device=d.device)
    tg = (street.ground_y - o[1]) / d[:, 1]
    best_t = torch.where(tg > 1e-6, tg, best_t)
    boxes, _ = street.boxes_near(float(o[2]), HDL64_RANGE)
    tb, _ = _first_box_hit(o, d, boxes)
    best_t = torch.minimum(tb, best_t)
    return torch.where(best_t <= HDL64_RANGE, best_t, math.inf)


def lidar_scan(street: Street, t_wc: torch.Tensor, n: int, gen: torch.Generator) -> torch.Tensor:
    """A seeded HDL-64E-style scan in the LiDAR frame [n, 3] float32: 64
    beams of elevation with a 1e-3 rad jitter, azimuths with a uniform
    jitter within their step, n of the returns chosen by `gen`, in ray
    order. Raises if the scan has fewer returns than n."""
    dev = t_wc.device
    n_az = scan_azimuths(n)
    el_noise = torch.randn((HDL64_BEAMS, n_az), generator=gen, dtype=torch.float64, device=dev) * 1e-3
    az_u = torch.rand((HDL64_BEAMS, n_az), generator=gen, dtype=torch.float64, device=dev)
    d_l = scan_rays(el_noise, az_u)
    rng = cast_scan(street, t_wc, d_l)
    hits = torch.nonzero(torch.isfinite(rng)).squeeze(1)
    if hits.numel() < n:
        raise ValueError(f"the scan has {hits.numel()} returns, fewer than {n}")
    pick = torch.randperm(hits.numel(), generator=gen, device=dev)[:n]
    keep = torch.sort(hits[pick]).values
    return (d_l[keep] * rng[keep, None]).to(torch.float32)
