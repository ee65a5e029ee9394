"""Per-Gaussian rasterization preprocess: cull, project, 2D covariance.

Port of `gsdf_slam_tpu/ops/projection.py` (preprocessCUDA,
forward.cu:198-312) as plain tensor ops; autograd supplies the backward.
The numeric conventions are the JAX package's:

* frustum cull at p_view.z <= 0.2 (auxiliary.h:160-194);
* p_w = 1 / (p_hom.w + 1e-7) (forward.cu:250);
* EWA cov2D with the 1.3*tanfov clamp and the +0.3 px low-pass
  (forward.cu:104-149);
* radius = ceil(3 * sqrt(lambda_max)) (forward.cu:282-291), kept for the
  radii/visibility filter from the 3-sigma rect's area;
* the tile rect is the opacity-tight AABB of the alpha >= 1/255 ellipse,
  capped at the reference's 3-sigma rect, with the inclusive pixel-coverage
  upper bound (PARITY.md D7).

The tensors are sized to the live Gaussians; there is no capacity padding
and no liveness mask.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .sh import eval_sh_color
from .transforms import CameraMatrices, build_cov3d, ndc_to_pix

TILE = 16  # BLOCK_X == BLOCK_Y == 16 (cuda_rasterizer/config.h:15-16)


class Preprocessed(NamedTuple):
    """Per-Gaussian screen-space quantities [P, ...]."""

    means2d: torch.Tensor  # [P, 2] pixel coords
    depths: torch.Tensor  # [P] camera-space z
    conics: torch.Tensor  # [P, 3] inverse 2D covariance (a, b, c)
    colors: torch.Tensor  # [P, 3] RGB from SH
    radii: torch.Tensor  # [P] int32, 0 => culled
    rect_min: torch.Tensor  # [P, 2] int32 tile coords (x, y)
    rect_max: torch.Tensor  # [P, 2] int32 tile coords, exclusive
    tiles_touched: torch.Tensor  # [P] int32 rect area (0 => skip)


def tile_grid(width: int, height: int) -> tuple[int, int]:
    return (width + TILE - 1) // TILE, (height + TILE - 1) // TILE


def _affine3(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Rows 0..2 of m @ [p, 1], written elementwise."""
    return torch.stack(
        [m[i, 0] * p[:, 0] + m[i, 1] * p[:, 1] + m[i, 2] * p[:, 2] + m[i, 3] for i in range(3)],
        dim=-1,
    )


def compute_cov2d(
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    cam: CameraMatrices,
    focal_x: torch.Tensor,
    focal_y: torch.Tensor,
) -> torch.Tensor:
    """EWA projection J W Sigma W^T J^T of the 3D covariance, plus the
    0.3 px low-pass on the diagonal. Returns (cov_xx, cov_xy, cov_yy) [P, 3]."""
    r = cam.view[:3, :3]
    t = _affine3(means3d, cam.view)
    # |tz| >= 0.1 keeps culled Gaussians' Jacobians finite; visible ones have
    # tz > 0.2 and are unaffected.
    tz_raw = t[:, 2]
    tz = torch.where(tz_raw.abs() < 0.1, torch.full_like(tz_raw, 0.1), tz_raw)
    limx = 1.3 * cam.tanfovx
    limy = 1.3 * cam.tanfovy
    tx = torch.clamp(t[:, 0] / tz, -limx, limx) * tz
    ty = torch.clamp(t[:, 1] / tz, -limy, limy) * tz

    inv_tz = 1.0 / tz
    j00 = focal_x * inv_tz
    j02 = -(focal_x * tx) * inv_tz * inv_tz
    j11 = focal_y * inv_tz
    j12 = -(focal_y * ty) * inv_tz * inv_tz
    t0 = j00[:, None] * r[0][None, :] + j02[:, None] * r[2][None, :]
    t1 = j11[:, None] * r[1][None, :] + j12[:, None] * r[2][None, :]

    c = cov3d  # (xx, xy, xz, yy, yz, zz)
    a0, a1, a2 = t0[:, 0], t0[:, 1], t0[:, 2]
    b0, b1, b2 = t1[:, 0], t1[:, 1], t1[:, 2]
    s00 = a0 * c[:, 0] + a1 * c[:, 1] + a2 * c[:, 2]
    s01 = a0 * c[:, 1] + a1 * c[:, 3] + a2 * c[:, 4]
    s02 = a0 * c[:, 2] + a1 * c[:, 4] + a2 * c[:, 5]
    r00 = b0 * c[:, 0] + b1 * c[:, 1] + b2 * c[:, 2]
    r01 = b0 * c[:, 1] + b1 * c[:, 3] + b2 * c[:, 4]
    r02 = b0 * c[:, 2] + b1 * c[:, 4] + b2 * c[:, 5]
    cxx = s00 * a0 + s01 * a1 + s02 * a2 + 0.3
    cxy = s00 * b0 + s01 * b1 + s02 * b2
    cyy = r00 * b0 + r01 * b1 + r02 * b2 + 0.3
    return torch.stack([cxx, cxy, cyy], dim=-1)


def preprocess(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    dc: torch.Tensor,
    sh_rest: torch.Tensor,
    cam: CameraMatrices,
    *,
    width: int,
    height: int,
    sh_degree: int,
    scale_modifier: float = 1.0,
    means2d_offset: torch.Tensor | None = None,
    active_sh_degree: int | None = None,
) -> Preprocessed:
    """Preprocess every Gaussian of the map.

    `means2d_offset` is an all-zeros [P, 2] tensor added to the projected
    pixel means; its gradient is the screen-space positional gradient that
    densification reads (the reference's retained screenspace_points grad,
    gaussian_renderer.cpp:41-48).
    """
    gw, gh = tile_grid(width, height)
    focal_x = width / (2.0 * cam.tanfovx)
    focal_y = height / (2.0 * cam.tanfovy)

    v = cam.view
    p_view_z = v[2, 0] * means3d[:, 0] + v[2, 1] * means3d[:, 1] + v[2, 2] * means3d[:, 2] + v[2, 3]
    valid = p_view_z > 0.2

    fp = cam.full_proj
    p_hom = torch.stack(
        [fp[i, 0] * means3d[:, 0] + fp[i, 1] * means3d[:, 1] + fp[i, 2] * means3d[:, 2] + fp[i, 3] for i in range(4)],
        dim=-1,
    )
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    p_proj = p_hom[:, :2] * p_w[:, None]

    cov2d = compute_cov2d(means3d, build_cov3d(scales, quats, scale_modifier), cam, focal_x, focal_y)

    det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] * cov2d[:, 1]
    valid = valid & (det != 0.0)
    det_safe = torch.where(det == 0.0, torch.ones_like(det), det)
    inv_det = 1.0 / det_safe
    conics = torch.stack(
        [cov2d[:, 2] * inv_det, -cov2d[:, 1] * inv_det, cov2d[:, 0] * inv_det], dim=-1
    )

    mid = 0.5 * (cov2d[:, 0] + cov2d[:, 2])
    lambda1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(lambda1))

    means2d = torch.stack([ndc_to_pix(p_proj[:, 0], width), ndc_to_pix(p_proj[:, 1], height)], dim=-1)
    if means2d_offset is not None:
        means2d = means2d + means2d_offset

    # Everything below is integer rect bookkeeping: no gradient flows.
    m2 = means2d.detach()
    c2 = cov2d.detach()
    rf = radius_f.detach()
    grid_i = torch.tensor([gw, gh], dtype=torch.int32, device=m2.device)
    zero_i = torch.zeros((), dtype=torch.int32, device=m2.device)

    def clip_grid(x):  # clip into [0, grid]; x is int32 [P, 2]
        return torch.minimum(torch.maximum(x, zero_i), grid_i)

    # tight per-axis AABB of the {alpha >= 1/255} ellipse, NOT capped at
    # 9 sigma^2: the 3-sigma square is enforced by the min with radius_f
    op = opacities.detach()
    power_cap = torch.clamp_min(2.0 * torch.log(torch.clamp_min(op, 1e-30) * 255.0), 0.0)
    ext = torch.ceil(torch.sqrt(power_cap[:, None] * torch.clamp_min(c2[:, [0, 2]], 0.0)))
    ext = torch.minimum(ext, rf[:, None])
    # the reference-exact 3-sigma rect, kept for the radii/visibility filter
    rmin3 = clip_grid(((m2 - rf[:, None]) / TILE).to(torch.int32))
    rmax3_f = torch.clamp_min((m2 + rf[:, None] + TILE - 1) / TILE, 0.0)
    rmax3 = torch.minimum(rmax3_f.to(torch.int32), grid_i)
    area3 = (rmax3[:, 0] - rmin3[:, 0]) * (rmax3[:, 1] - rmin3[:, 1])

    rmin = clip_grid(((m2 - ext) / TILE).to(torch.int32))
    # inclusive pixel-coverage bound (D7), clamped into the 3-sigma rect
    rmax_f = torch.clamp_min(torch.floor(m2 + ext) / TILE + 1.0, 0.0)
    rmax = torch.minimum(torch.minimum(rmax_f.to(torch.int32), rmax3), grid_i)
    # strictly below 1/255 opacity can never contribute anywhere
    zero_ext = op * 255.0 < 1.0
    area = torch.where(zero_ext, zero_i, (rmax[:, 0] - rmin[:, 0]) * (rmax[:, 1] - rmin[:, 1]))

    valid_radii = valid & (area3 > 0)
    valid = valid & (area > 0)

    colors = eval_sh_color(dc, sh_rest, means3d, cam.campos, sh_degree, active_sh_degree)

    radii = torch.where(valid_radii, rf, torch.zeros_like(rf)).to(torch.int32)
    tiles_touched = torch.where(valid, area, zero_i).to(torch.int32)
    return Preprocessed(
        means2d=means2d,
        depths=p_view_z,
        conics=conics,
        colors=colors,
        radii=radii,
        rect_min=rmin,
        rect_max=rmax,
        tiles_touched=tiles_touched,
    )
