"""Differentiable Gaussian-splat rasterizer, fresh binning every call.

Port of `gsdf_slam_tpu/ops/rasterize.py` (the fresh, non-banded branch):

    preprocess (tensor ops, autograd)  ->  binning (K3, no gradient)  ->
    blend (FreshBlend: K1 / K2)        ->  background composite + crop

`render_dense_reference` is the brute-force golden renderer for tests.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .blend import ALPHA_MAX, ALPHA_MIN, T_EPS, assemble_image
from .projection import TILE, Preprocessed, preprocess, tile_grid
from .tile_blend import blend_tiles_fresh
from .transforms import CameraMatrices


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    """Static rasterization settings (GaussianRasterizationSettings,
    include/gaussian_rasterizer.h); per-view tensors travel in
    CameraMatrices. The pair arrays are sized exactly every call, so there
    is no pair capacity."""

    height: int
    width: int
    sh_degree: int = 3
    scale_modifier: float = 1.0

    @property
    def grid(self) -> tuple[int, int]:
        return tile_grid(self.width, self.height)


class RenderOutput(NamedTuple):
    image: torch.Tensor  # [H, W, 3]
    final_t: torch.Tensor  # [H, W] transmittance left after blending
    radii: torch.Tensor  # [P] int32 screen radii; 0 = culled
    total_pairs: torch.Tensor  # [] int64 pre-cull pair count


def render_preprocessed(
    pre: Preprocessed, opacities: torch.Tensor, bg: torch.Tensor, cfg: RasterizeConfig
) -> RenderOutput:
    """Binning + blend + composite on a preprocessed payload."""
    gw, gh = cfg.grid
    accum, log_t_eff, total = blend_tiles_fresh(pre, opacities, grid_w=gw, grid_h=gh)
    image, final_t = assemble_image(
        accum, log_t_eff, bg, grid_w=gw, grid_h=gh, width=cfg.width, height=cfg.height
    )
    return RenderOutput(image=image, final_t=final_t, radii=pre.radii, total_pairs=total)


def render(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    dc: torch.Tensor,
    sh_rest: torch.Tensor,
    cam: CameraMatrices,
    bg: torch.Tensor,
    cfg: RasterizeConfig,
    means2d_offset: torch.Tensor | None = None,
    active_sh_degree: int | None = None,
) -> RenderOutput:
    """Render one view (GaussianRasterizer::forward,
    gaussian_rasterizer.h:110-132) from activated parameters [P, ...]."""
    pre = preprocess(
        means3d, scales, quats, opacities, dc, sh_rest, cam,
        width=cfg.width, height=cfg.height, sh_degree=cfg.sh_degree,
        scale_modifier=cfg.scale_modifier, means2d_offset=means2d_offset,
        active_sh_degree=active_sh_degree,
    )
    return render_preprocessed(pre, opacities, bg, cfg)


def render_dense_reference(
    means3d, scales, quats, opacities, dc, sh_rest, cam: CameraMatrices, bg, cfg: RasterizeConfig
):
    """O(P * pixels) golden renderer for tests: the same math as the tiled
    path by brute force over every (Gaussian, pixel). Its autograd gradient
    gates the 0.99 clamp, unlike the blend's VJP."""
    pre = preprocess(
        means3d, scales, quats, opacities, dc, sh_rest, cam,
        width=cfg.width, height=cfg.height, sh_degree=cfg.sh_degree,
        scale_modifier=cfg.scale_modifier,
    )
    h, w = cfg.height, cfg.width
    dev = means3d.device
    ys, xs = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij")
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1).to(torch.float32)
    tile_xy = torch.div(pix, TILE, rounding_mode="floor").to(torch.int32)

    inf = torch.full_like(pre.depths, float("inf"))
    order = torch.argsort(torch.where(pre.tiles_touched > 0, pre.depths, inf), stable=True)
    xy, con, op, col = pre.means2d[order], pre.conics[order], opacities[order], pre.colors[order]
    rmin, rmax = pre.rect_min[order], pre.rect_max[order]
    vis = (pre.tiles_touched > 0)[order]

    d = xy[:, None, :] - pix[None, :, :]
    power = -0.5 * (con[:, 0:1] * d[..., 0] ** 2 + con[:, 2:3] * d[..., 1] ** 2) - con[:, 1:2] * d[..., 0] * d[..., 1]
    in_rect = (
        (tile_xy[None, :, 0] >= rmin[:, None, 0])
        & (tile_xy[None, :, 0] < rmax[:, None, 0])
        & (tile_xy[None, :, 1] >= rmin[:, None, 1])
        & (tile_xy[None, :, 1] < rmax[:, None, 1])
    )
    alpha = torch.clamp_max(op[:, None] * torch.exp(power), ALPHA_MAX)
    live = vis[:, None] & in_rect & (power <= 0.0) & (alpha >= ALPHA_MIN)
    alpha = torch.where(live, alpha, 0.0)
    log1m = torch.log1p(-alpha)
    incl = torch.cumsum(log1m, 0)
    applied = torch.exp(incl) >= T_EPS
    wgt = alpha * torch.exp(incl - log1m) * applied
    color = wgt.t() @ col
    final_t = torch.exp(torch.sum(torch.where(applied, log1m, 0.0), 0))
    out = color + final_t[:, None] * bg[None, :]
    return out.reshape(h, w, 3), final_t.reshape(h, w)
