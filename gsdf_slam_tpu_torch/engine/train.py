"""The training step: render -> loss -> backward -> Adam (+ stats).

Port of `gsdf_slam_tpu/engine/train.py` (trainForOneIteration,
gaussian_mapper.cpp:335-468, minus host-side policy). A step bins afresh,
or exports its binning as a cache (`export_binning_cache=True`), or trains
through such a cache (`binning_cache=`): the JAX mapper's cadence after
densification is one export step and then cached steps. The live
hyperparameters are plain floats: eager PyTorch has no recompile to avoid.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import OptimizationParams
from ..models.gaussian_model import GaussianModel
from ..models.optimizer import PARAM_GROUPS, AdamState, adam_step, group_lrs
from ..ops.losses import mapper_loss, psnr
from ..ops.rasterize import RasterizeConfig, RenderOutput, render
from ..ops.tile_blend import BinningCache
from ..ops.transforms import CameraMatrices


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    psnr: torch.Tensor
    count: int
    total_pairs: torch.Tensor


def render_state(
    model: GaussianModel,
    cam: CameraMatrices,
    bg: torch.Tensor,
    cfg: RasterizeConfig,
    means2d_offset: torch.Tensor | None = None,
    active_sh_degree: int | None = None,
    binning_cache: BinningCache | None = None,
    export_binning_cache: bool = False,
) -> RenderOutput:
    """GaussianRenderer::render (gaussian_renderer.cpp:23-141): activations
    and the rasterizer call (the separate_sh dc/rest path)."""
    return render(
        model.xyz,
        model.scaling_act(),
        model.rotation_act(),
        model.opacity_act()[:, 0],
        model.f_dc,
        model.f_rest,
        cam,
        bg,
        cfg,
        means2d_offset=means2d_offset,
        active_sh_degree=active_sh_degree,
        binning_cache=binning_cache,
        export_binning_cache=export_binning_cache,
    )


def train_step(
    model: GaussianModel,
    adam: AdamState,
    cam: CameraMatrices,
    gt_image: torch.Tensor,
    mask: torch.Tensor | None,
    bg: torch.Tensor,
    iteration: int,
    spatial_lr_scale: float,
    cfg: RasterizeConfig,
    opt: OptimizationParams,
    accumulate_stats: bool = True,
    active_sh_degree: int | None = None,
    binning_cache: BinningCache | None = None,
    export_binning_cache: bool = False,
) -> StepMetrics | tuple[StepMetrics, BinningCache]:
    """One optimization iteration; updates `model` and `adam` in place.

    With `export_binning_cache=True` it returns (metrics, the BinningCache
    of this step's binning), for `binning_cache=` on later steps of the same
    view; the cache is valid only for this model's Gaussians and this image
    size, and a mismatch raises."""
    params = model.params()
    # zero screen-space offset whose gradient feeds densification (JAX :180-183)
    m2d0 = torch.zeros((model.count, 2), device=model.xyz.device, requires_grad=True)
    out = render_state(
        model, cam, bg, cfg, means2d_offset=m2d0, active_sh_degree=active_sh_degree,
        binning_cache=binning_cache, export_binning_cache=export_binning_cache,
    )
    loss = mapper_loss(out.image, gt_image, mask, opt.lambda_dssim)
    grads = torch.autograd.grad(loss, [params[k] for k in PARAM_GROUPS] + [m2d0])
    g_params = dict(zip(PARAM_GROUPS, grads[:-1]))

    if accumulate_stats:
        model.add_densification_stats(grads[-1], out.radii, cfg.width, cfg.height)

    lrs = group_lrs(opt, 1.0, iteration, device=model.xyz.device)
    lrs["xyz"] = lrs["xyz"] * spatial_lr_scale
    adam_step({k: p.data for k, p in params.items()}, g_params, adam, lrs)
    with torch.no_grad():
        metrics = StepMetrics(
            loss=loss.detach(), psnr=psnr(out.image, gt_image), count=model.count,
            total_pairs=out.total_pairs,
        )
    if export_binning_cache:
        return metrics, out.binning_cache
    return metrics
