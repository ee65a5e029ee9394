"""Deterministic synthetic RGB-D room for quality benchmarking.

No dataset ships in this environment, so the Replica-room0-class quality
target (BASELINE.md) is evidenced on a committed, re-runnable fixture: a
textured box room raycast analytically (exact RGB + exact z-depth + exact
poses). The mapper trains on RGB-D keyframes of this room through the same
code path as Replica (feed_keyframe with depth -> backprojected cloud +
photometric optimization) and is evaluated on held-out views.

Geometry: axis-aligned room interior [-2,2] x [-2,2] x [-1.5,1.5]; each of
the 6 faces carries a distinct smooth-plus-checker texture (large cells so
an anisotropic-splat representation can actually fit it).

A numpy copy of `benchmarks/synthetic_room.py`: the port imports nothing of
`benchmarks/`. `gsdf_slam_tpu_torch.stream` streams `make_sequence`.
"""

from __future__ import annotations

import numpy as np

ROOM_MIN = np.array([-2.0, -2.0, -1.5])
ROOM_MAX = np.array([2.0, 2.0, 1.5])

# per-face base colors (+x, -x, +y, -y, +z, -z)
_FACE_A = np.array(
    [
        [0.85, 0.45, 0.35],
        [0.35, 0.55, 0.85],
        [0.45, 0.80, 0.45],
        [0.85, 0.75, 0.35],
        [0.80, 0.80, 0.85],
        [0.45, 0.40, 0.40],
    ]
)
_FACE_B = np.array(
    [
        [0.55, 0.25, 0.20],
        [0.20, 0.30, 0.55],
        [0.25, 0.50, 0.30],
        [0.55, 0.45, 0.20],
        [0.55, 0.55, 0.65],
        [0.25, 0.22, 0.25],
    ]
)


def camera_rays(t_wc: np.ndarray, width: int, height: int, fov: float):
    """Shared pinhole ray generator for the synthetic fixtures: returns
    (origin [3], world ray dirs [H,W,3] with unit camera-z so the ray
    parameter equals z-depth). OpenCV convention: +x right, +y down,
    +z forward; principal point at ((w-1)/2, (h-1)/2)."""
    fx = 0.5 * width / np.tan(fov / 2)
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    ys, xs = np.mgrid[0:height, 0:width]
    d_cam = np.stack(
        [(xs - cx) / fx, (ys - cy) / fx, np.ones_like(xs, np.float64)], -1
    )
    r = t_wc[:3, :3].astype(np.float64)
    o = t_wc[:3, 3].astype(np.float64)
    return o, d_cam @ r.T


def _face_texture(
    face: int, u: np.ndarray, v: np.ndarray, hard: bool = False
) -> np.ndarray:
    """Smooth gradients + a 0.5m checker, in [0,1]. u/v in world meters.

    `hard` adds high-frequency detail (fine checker + multi-octave
    sinusoids) that a splat representation must spend many small
    anisotropic Gaussians on — the round-3 evidence-hardening scene."""
    checker = ((np.floor(u / 0.5) + np.floor(v / 0.5)) % 2.0)[..., None]
    base = _FACE_A[face][None, :] * checker + _FACE_B[face][None, :] * (1 - checker)
    grad = (
        0.15 * np.sin(1.7 * u + 0.9 * face)[..., None]
        + 0.1 * np.cos(2.3 * v - 0.4 * face)[..., None]
    )
    tex = base + grad
    if hard:
        fine = ((np.floor(u / 0.08) + np.floor(v / 0.08)) % 2.0)[..., None]
        tex = tex + 0.16 * (fine - 0.5)
        tex = tex + (
            0.08 * np.sin(23.0 * u + 5.0 * face) * np.sin(19.0 * v)
            + 0.05 * np.sin(47.0 * (u + v) + face)
        )[..., None]
    return np.clip(tex, 0.02, 0.98)


# Occluder boxes for the hard scene: interior furniture-scale blocks that
# shadow large wall areas from many viewpoints (occlusion-heavy geometry).
_BOXES = [
    (np.array([0.6, -1.4, -1.5]), np.array([1.5, -0.5, -0.2])),
    (np.array([-1.6, 0.7, -1.5]), np.array([-0.8, 1.5, 0.5])),
    (np.array([-0.4, -0.5, -0.1]), np.array([0.4, 0.4, 0.6])),
]
_LIGHT = np.array([0.30, -0.45, 0.84])
_LIGHT = _LIGHT / np.linalg.norm(_LIGHT)


def raycast_room(
    t_wc: np.ndarray,
    width: int,
    height: int,
    fov: float = np.pi / 2,
    hard: bool = False,
):
    """Render (rgb [H,W,3], zdepth [H,W]) of the room from camera pose T_wc.

    OpenCV camera convention: +z forward, +x right, +y down. `hard` adds
    occluder boxes, high-frequency texture, and a Blinn-Phong specular
    term that varies with VIEW direction — view-dependent color the splat
    model can only fit through its f_rest SH coefficients."""
    o, d = camera_rays(t_wc, width, height, fov)

    best_t = np.full((height, width), np.inf)
    rgb = np.zeros((height, width, 3))
    normal = np.zeros((height, width, 3)) if hard else None
    axes = [(0, 1, 2), (1, 0, 2), (2, 0, 1)]

    def cast_faces(bmin, bmax, face0, inward):
        nonlocal best_t
        face = face0
        for ax, ua, va in axes:
            for k, bound in enumerate((bmax[ax], bmin[ax])):
                with np.errstate(divide="ignore", invalid="ignore"):
                    t = (bound - o[ax]) / d[..., ax]
                hit_u = o[ua] + t * d[..., ua]
                hit_v = o[va] + t * d[..., va]
                ok = (
                    (t > 1e-6)
                    & (t < best_t)
                    & (hit_u >= bmin[ua] - 1e-9)
                    & (hit_u <= bmax[ua] + 1e-9)
                    & (hit_v >= bmin[va] - 1e-9)
                    & (hit_v <= bmax[va] + 1e-9)
                )
                col = _face_texture(face % 6, hit_u[ok], hit_v[ok], hard=hard)
                rgb[ok] = col
                best_t[ok] = t[ok]
                if hard:
                    # surface normal facing the camera side: walls face
                    # inward, box faces outward
                    n = np.zeros(3)
                    n[ax] = (-1.0 if k == 0 else 1.0) * (1.0 if inward else -1.0)
                    normal[ok] = n
                face += 1

    cast_faces(ROOM_MIN, ROOM_MAX, 0, inward=True)
    if hard:
        for bi, (bmin, bmax) in enumerate(_BOXES):
            cast_faces(bmin, bmax, 2 * bi + 1, inward=False)
        # Blinn-Phong specular: depends on the VIEW direction, so the same
        # surface point changes color across training views (forces f_rest)
        hit_p = o[None, None, :] + best_t[..., None] * d
        w = o[None, None, :] - hit_p
        w = w / np.maximum(np.linalg.norm(w, axis=-1, keepdims=True), 1e-12)
        h = w + _LIGHT[None, None, :]
        h = h / np.maximum(np.linalg.norm(h, axis=-1, keepdims=True), 1e-12)
        spec = np.maximum((normal * h).sum(-1), 0.0) ** 16
        rgb = np.clip(rgb + 0.45 * spec[..., None], 0.0, 1.0)
    return rgb.astype(np.float32), best_t.astype(np.float32)


def room_pose(yaw: float, pitch: float = 0.0, radius: float = 0.3) -> np.ndarray:
    """T_wc looking outward at `yaw` from a small circle around the center."""
    cy_, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    # camera +z (forward) points outward at yaw; +y points world -z-ish (down)
    fwd = np.array([cy_ * cp, sy * cp, sp])
    right = np.array([-sy, cy_, 0.0])
    down = np.cross(fwd, right)
    t = np.eye(4, dtype=np.float64)
    t[:3, 0] = right
    t[:3, 1] = down
    t[:3, 2] = fwd
    t[:3, 3] = np.array([cy_, sy, 0.0]) * radius
    return t.astype(np.float32)


def make_sequence(
    n_frames: int,
    width: int,
    height: int,
    fov: float = np.pi / 2,
    hard: bool = False,
):
    """Training trajectory: two yaw rings (pitch -0.2 / +0.2) so the full
    wall height is imaged — the camera fovy (~74 deg at 4:3) cannot cover
    floor-to-ceiling from one pitch."""
    frames = []
    per_ring = max(1, n_frames // 2)
    for i in range(n_frames):
        ring = i // per_ring
        yaw = 2 * np.pi * (i % per_ring) / per_ring + 0.1 * ring
        pitch = -0.2 if ring == 0 else 0.2
        pose = room_pose(yaw, pitch)
        rgb, depth = raycast_room(pose, width, height, fov, hard=hard)
        frames.append((pose, rgb, depth))
    return frames


def make_eval_poses(n_eval: int, n_train: int):
    """Held-out poses: mid-pitch views at yaws offset half-way between
    training yaws (inside the trained coverage, novel viewpoints)."""
    per_ring = max(1, n_train // 2)
    out = []
    for i in range(n_eval):
        yaw = 2 * np.pi * (i + 0.5) / per_ring
        out.append(room_pose(yaw, 0.0))
    return out
