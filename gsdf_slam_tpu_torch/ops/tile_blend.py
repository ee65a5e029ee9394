"""The fresh-binning blend: kernels K1 (forward) and K2 (backward) and the
`torch.autograd.Function` around binning, forward and backward.

Port of the fresh path of `gsdf_slam_tpu/ops/pallas_blend_grouped.py`
(`_make_fused_blend`, `_run_fwd`, `_run_bwd`, `_fold_pair_grads`). The
Function's forward bins the Gaussians (ops/binning.py, kernel K3) and runs
K1; its backward runs K2, which also folds the pair gradients into
per-Gaussian gradients with atomics. Gradients flow to means2d, conics,
opacities and colors; the binning keys (depths, rects, tiles_touched) are
not differentiated, as in JAX.

On a CPU tensor each wrapper takes its plain version (ops/blend.py); on a
CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import torch

from .. import kernels
from .binning import PAYLOAD_ROWS, bin_and_pack
from .blend import PIX_PER_TILE, blend_bwd_plain, blend_fwd_plain


def blend_fwd(ranges, payload, grid_w: int, grid_h: int):
    """K1: forward blend of every tile. Returns accum [T,256,3],
    log_t_eff [T,256] and n_contrib [T,256] int32 (last applied pair + 1).
    Replaces `_fwd_kernel` of ops/pallas_blend_grouped.py (keep_margin=None)."""
    if kernels.runs_plain(ranges):
        return blend_fwd_plain(ranges, payload, grid_w, grid_h)
    kernels.library()  # builds on first use; raises where it cannot
    dev = ranges.device
    num_tiles = grid_w * grid_h
    m = payload.shape[1]
    kernels.check("ranges", ranges, torch.int32, (num_tiles, 2), dev)
    kernels.check("payload", payload, torch.float32, (PAYLOAD_ROWS, m), dev)
    accum = torch.empty((num_tiles, PIX_PER_TILE, 3), dtype=torch.float32, device=dev)
    log_t_eff = torch.empty((num_tiles, PIX_PER_TILE), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((num_tiles, PIX_PER_TILE), dtype=torch.int32, device=dev)
    kernels.LAUNCHES["blend_fwd"] += 1
    kernels.launch(
        "gsdf_blend_fwd", ranges.data_ptr(), payload.data_ptr(), m, num_tiles,
        grid_w, accum.data_ptr(), log_t_eff.data_ptr(), n_contrib.data_ptr(),
    )
    return accum, log_t_eff, n_contrib


def blend_bwd(
    ranges, payload, gid, log_t_eff, n_contrib, ct_accum, ct_log_t_eff,
    num_gaussians: int, grid_w: int, grid_h: int,
):
    """K2: backward blend plus the fold to per-Gaussian gradients [P, 9]
    (mean x, y; conic a, b, c; opacity; rgb). Replaces `_bwd_kernel` and
    `_fold_pair_grads` of ops/pallas_blend_grouped.py."""
    if kernels.runs_plain(ranges):
        return blend_bwd_plain(
            ranges, payload, gid, log_t_eff, n_contrib, ct_accum, ct_log_t_eff,
            num_gaussians, grid_w, grid_h,
        )
    kernels.library()  # builds on first use; raises where it cannot
    dev = ranges.device
    num_tiles = grid_w * grid_h
    m = payload.shape[1]
    kernels.check("ranges", ranges, torch.int32, (num_tiles, 2), dev)
    kernels.check("payload", payload, torch.float32, (PAYLOAD_ROWS, m), dev)
    kernels.check("gid", gid, torch.int32, (m,), dev)
    kernels.check("log_t_eff", log_t_eff, torch.float32, (num_tiles, PIX_PER_TILE), dev)
    kernels.check("n_contrib", n_contrib, torch.int32, (num_tiles, PIX_PER_TILE), dev)
    kernels.check("ct_accum", ct_accum, torch.float32, (num_tiles, PIX_PER_TILE, 3), dev)
    kernels.check("ct_log_t_eff", ct_log_t_eff, torch.float32, (num_tiles, PIX_PER_TILE), dev)
    grads = torch.zeros((num_gaussians, 9), dtype=torch.float32, device=dev)
    kernels.LAUNCHES["blend_bwd"] += 1
    kernels.launch(
        "gsdf_blend_bwd", ranges.data_ptr(), payload.data_ptr(), gid.data_ptr(),
        m, num_tiles, grid_w, log_t_eff.data_ptr(), n_contrib.data_ptr(),
        ct_accum.data_ptr(), ct_log_t_eff.data_ptr(), grads.data_ptr(),
    )
    return grads


class FreshBlend(torch.autograd.Function):
    """Binning + K1 forward; K2 backward. Outputs accum [T,256,3],
    log_t_eff [T,256] and the pre-cull pair count (0-d int64, no gradient)."""

    @staticmethod
    def forward(ctx, means2d, conics, opacities, colors, depths, rect_min,
                rect_max, tiles_touched, grid_w, grid_h):
        binned = bin_and_pack(
            depths, rect_min, rect_max, tiles_touched, means2d, conics,
            opacities, colors, grid_w=grid_w, grid_h=grid_h,
        )
        accum, log_t_eff, n_contrib = blend_fwd(binned.ranges, binned.payload, grid_w, grid_h)
        ctx.save_for_backward(binned.ranges, binned.payload, binned.gid, log_t_eff, n_contrib)
        ctx.grid = (grid_w, grid_h)
        ctx.num_gaussians = means2d.shape[0]
        total = torch.tensor(binned.total_pairs, dtype=torch.int64)
        ctx.mark_non_differentiable(total)
        return accum, log_t_eff, total

    @staticmethod
    def backward(ctx, ct_accum, ct_log_t_eff, _ct_total):
        ranges, payload, gid, log_t_eff, n_contrib = ctx.saved_tensors
        grid_w, grid_h = ctx.grid
        g = blend_bwd(
            ranges, payload, gid, log_t_eff, n_contrib, ct_accum.contiguous(),
            ct_log_t_eff.contiguous(), ctx.num_gaussians, grid_w, grid_h,
        )
        return g[:, 0:2], g[:, 2:5], g[:, 5], g[:, 6:9], None, None, None, None, None, None


def blend_tiles_fresh(pre, opacities, *, grid_w: int, grid_h: int):
    """Fresh-binning blend of a Preprocessed payload: (accum [T,256,3],
    log_t_eff [T,256], total_pairs 0-d int64)."""
    return FreshBlend.apply(
        pre.means2d, pre.conics, opacities, pre.colors,
        pre.depths.detach(), pre.rect_min, pre.rect_max, pre.tiles_touched,
        grid_w, grid_h,
    )
