"""Differentiable Gaussian-splat rasterizer.

Port of `gsdf_slam_tpu/ops/rasterize.py` (the non-banded branch):

    preprocess (tensor ops, autograd)  ->  binning (K3, no gradient)  ->
    blend (FreshBlend: K1 / K2)        ->  background composite + crop

An export render (`export_binning_cache=True`) runs K4 in place of K1 and
returns a pruned `BinningCache`; a cached render (`binning_cache=`) skips
binning and blends through the cache (CachedBlend: K1 / K2).

`render_dense_reference` is the brute-force golden renderer for tests.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .blend import ALPHA_MAX, ALPHA_MIN, T_EPS, assemble_image
from .projection import TILE, Preprocessed, preprocess, tile_grid
from .tile_blend import BinningCache, blend_tiles_cached, blend_tiles_export, blend_tiles_fresh
from .transforms import CameraMatrices


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    """Static rasterization settings (GaussianRasterizationSettings,
    include/gaussian_rasterizer.h); per-view tensors travel in
    CameraMatrices. The pair arrays are sized exactly every call, so there
    is no pair capacity, and an exported cache is sized to its kept pairs,
    so there is no `cache_prune_capacity_factor`."""

    height: int
    width: int
    sh_degree: int = 3
    scale_modifier: float = 1.0
    # An exported binning cache keeps the pairs that some pixel sees live
    # while its transmittance is >= T_EPS / margin: the margin is the slack
    # kept for parameter drift across the cached steps. 0 turns pruning off.
    cache_prune_margin: float = 10.0

    def __post_init__(self):
        # a margin in (0, 1) would prune pairs the export step itself
        # applies; the JAX package accepts it and corrupts its export render
        if not (self.cache_prune_margin == 0.0 or self.cache_prune_margin >= 1.0):
            raise ValueError(
                f"cache_prune_margin must be 0 (no pruning) or >= 1, got {self.cache_prune_margin}"
            )

    @property
    def grid(self) -> tuple[int, int]:
        return tile_grid(self.width, self.height)


class RenderOutput(NamedTuple):
    image: torch.Tensor  # [H, W, 3]
    final_t: torch.Tensor  # [H, W] transmittance left after blending
    radii: torch.Tensor  # [P] int32 screen radii; 0 = culled
    total_pairs: torch.Tensor  # [] int64 pre-cull pair count
    binning_cache: BinningCache | None = None  # set by an export render


def _check_cache(cache: BinningCache, num_gaussians: int, cfg: RasterizeConfig) -> None:
    """Raise unless `cache` was built for this many Gaussians at this image
    size: a cache is only valid for the model and image it was built from."""
    if cache.num_gaussians != num_gaussians:
        raise ValueError(
            f"binning cache built for {cache.num_gaussians} Gaussians, used with {num_gaussians}"
        )
    if tuple(cache.image_size) != (cfg.height, cfg.width):
        raise ValueError(
            f"binning cache built for a {cache.image_size} (height, width) image, "
            f"used at {(cfg.height, cfg.width)}"
        )


def render_preprocessed(
    pre: Preprocessed,
    opacities: torch.Tensor,
    bg: torch.Tensor,
    cfg: RasterizeConfig,
    binning_cache: BinningCache | None = None,
    export_binning_cache: bool = False,
) -> RenderOutput:
    """Binning + blend + composite on a preprocessed payload; or the blend
    through `binning_cache`; or, with `export_binning_cache`, a fresh render
    that also returns its (pruned) cache."""
    gw, gh = cfg.grid
    cache_out = None
    if binning_cache is not None:
        if export_binning_cache:
            raise ValueError("binning_cache and export_binning_cache exclude each other")
        _check_cache(binning_cache, pre.means2d.shape[0], cfg)
        accum, log_t_eff, total = blend_tiles_cached(pre, opacities, binning_cache, grid_w=gw, grid_h=gh)
    elif export_binning_cache:
        accum, log_t_eff, total, cache_out = blend_tiles_export(
            pre, opacities, grid_w=gw, grid_h=gh, margin=cfg.cache_prune_margin,
            image_size=(cfg.height, cfg.width),
        )
    else:
        accum, log_t_eff, total = blend_tiles_fresh(pre, opacities, grid_w=gw, grid_h=gh)
    image, final_t = assemble_image(
        accum, log_t_eff, bg, grid_w=gw, grid_h=gh, width=cfg.width, height=cfg.height
    )
    return RenderOutput(
        image=image, final_t=final_t, radii=pre.radii, total_pairs=total, binning_cache=cache_out
    )


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
    binning_cache: BinningCache | None = None,
    export_binning_cache: bool = False,
) -> RenderOutput:
    """Render one view (GaussianRasterizer::forward,
    gaussian_rasterizer.h:110-132) from activated parameters [P, ...].

    `export_binning_cache=True` also returns this render's binning as
    `RenderOutput.binning_cache`, pruned to its live pairs unless
    `cfg.cache_prune_margin` is 0; `binning_cache=` renders through such a
    cache with no binning. A cache is valid only for the model and image
    size it was built from; anything else raises."""
    pre = preprocess(
        means3d, scales, quats, opacities, dc, sh_rest, cam,
        width=cfg.width, height=cfg.height, sh_degree=cfg.sh_degree,
        scale_modifier=cfg.scale_modifier, means2d_offset=means2d_offset,
        active_sh_degree=active_sh_degree,
    )
    return render_preprocessed(
        pre, opacities, bg, cfg, binning_cache=binning_cache,
        export_binning_cache=export_binning_cache,
    )


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
