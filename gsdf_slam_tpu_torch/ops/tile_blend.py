"""The tile blend: kernels K1 (forward), K4 (the forward of an export
step, with the keep flag) and K2 (backward), the fresh and the cached
`torch.autograd.Function`, and the binning cache.

Port of `gsdf_slam_tpu/ops/pallas_blend_grouped.py` (`_make_fused_blend`,
`_make_cached_blend`, `_run_fwd`, `_run_bwd`, `_fold_pair_grads`,
`BinningCache`, `build_pruned_cache`). `FreshBlend`'s forward bins the
Gaussians (ops/binning.py, kernel K3) and runs K1, or K4 on an export
step; `CachedBlend`'s forward gathers fresh per-Gaussian payload through a
frozen `BinningCache` and runs K1, with no binning, on the cache's
compacted ranges. K1 and K4 also write each pixel's state at every 32nd
pair of its tile (the bucket checkpoints), which both autograd functions
save; both backwards run K2 from them, one warp per 32-pair bucket, which
also folds the pair gradients into per-Gaussian gradients with atomics. Gradients flow to means2d, conics, opacities and colors; the
binning keys (depths, rects, tiles_touched) are not differentiated, as in
JAX.

On a CPU tensor each wrapper takes its plain version (ops/blend.py); on a
CUDA tensor it launches its kernel or raises.

Each blend adds the pairs it walks (the binning's or the cache's pair
count, known to the host) to the current tracer's counter "blend.pairs";
the binning and the cache's compaction are its span "render.binning"
(`utils/observability.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..utils.observability import count, span
from .binning import PAYLOAD_ROWS, Binned, bin_and_pack, payload_table
from .blend import PIX_PER_TILE, blend_bwd_plain, blend_fwd_plain, checkpoint_slots, keep_log_exit


def _fwd_outputs(num_tiles: int, m: int, dev):
    accum = torch.empty((num_tiles, PIX_PER_TILE, 3), dtype=torch.float32, device=dev)
    log_t_eff = torch.empty((num_tiles, PIX_PER_TILE), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((num_tiles, PIX_PER_TILE), dtype=torch.int32, device=dev)
    # sized from shapes alone: no read-back of the pair counts
    ckpt = torch.empty((checkpoint_slots(num_tiles, m), PIX_PER_TILE, 4), dtype=torch.float32, device=dev)
    return accum, log_t_eff, n_contrib, ckpt


def blend_fwd(ranges, payload, grid_w: int, grid_h: int):
    """K1: forward blend of every tile. Returns accum [T,256,3],
    log_t_eff [T,256], n_contrib [T,256] int32 (last applied pair + 1) and
    the bucket checkpoints [T + M // 32, 256, 4] (ops/blend.py) that K2
    starts from. Replaces `_fwd_kernel` of ops/pallas_blend_grouped.py
    (keep_margin=None)."""
    if kernels.runs_plain(ranges):
        return blend_fwd_plain(ranges, payload, grid_w, grid_h)
    kernels.library()  # builds on first use; raises where it cannot
    dev = ranges.device
    num_tiles = grid_w * grid_h
    m = payload.shape[1]
    kernels.check("ranges", ranges, torch.int32, (num_tiles, 2), dev)
    kernels.check("payload", payload, torch.float32, (PAYLOAD_ROWS, m), dev)
    accum, log_t_eff, n_contrib, ckpt = _fwd_outputs(num_tiles, m, dev)
    kernels.LAUNCHES["blend_fwd"] += 1
    kernels.launch(
        "gsdf_blend_fwd", ranges.data_ptr(), payload.data_ptr(), m, num_tiles,
        grid_w, accum.data_ptr(), log_t_eff.data_ptr(), n_contrib.data_ptr(), ckpt.data_ptr(),
    )
    return accum, log_t_eff, n_contrib, ckpt


def blend_fwd_export(ranges, payload, grid_w: int, grid_h: int, margin: float):
    """K4: K1's outputs, checkpoints included (bit-equal where K2 reads
    them), plus keep [M] bool, True for a pair that some pixel sees live
    while its exclusive raw log T is still >= log(1e-4 / margin), margin
    >= 1. Replaces `_fwd_kernel` of ops/pallas_blend_grouped.py launched
    with keep_margin. The kernel writes keep over every tile's range, so
    the ranges must tile [0, M), as K3's do."""
    if not margin >= 1.0:
        raise ValueError(f"blend_fwd_export: margin must be >= 1, got {margin}")
    if kernels.runs_plain(ranges):
        return blend_fwd_plain(ranges, payload, grid_w, grid_h, keep_margin=margin)
    kernels.library()  # builds on first use; raises where it cannot
    dev = ranges.device
    num_tiles = grid_w * grid_h
    m = payload.shape[1]
    kernels.check("ranges", ranges, torch.int32, (num_tiles, 2), dev)
    kernels.check("payload", payload, torch.float32, (PAYLOAD_ROWS, m), dev)
    accum, log_t_eff, n_contrib, ckpt = _fwd_outputs(num_tiles, m, dev)
    keep = torch.empty((m,), dtype=torch.bool, device=dev)
    kernels.LAUNCHES["blend_fwd_export"] += 1
    kernels.launch(
        "gsdf_blend_fwd_export", ranges.data_ptr(), payload.data_ptr(), m, num_tiles,
        grid_w, keep_log_exit(margin), accum.data_ptr(), log_t_eff.data_ptr(),
        n_contrib.data_ptr(), ckpt.data_ptr(), keep.data_ptr(),
    )
    return accum, log_t_eff, n_contrib, ckpt, keep


def blend_bwd(
    ranges, payload, gid, accum, n_contrib, ckpt, ct_accum, ct_log_t_eff,
    num_gaussians: int, grid_w: int, grid_h: int,
):
    """K2: backward blend plus the fold to per-Gaussian gradients [P, 9]
    (mean x, y; conic a, b, c; opacity; rgb), from the forward's accum,
    n_contrib and bucket checkpoints on the same binning. Replaces
    `_bwd_kernel` and `_fold_pair_grads` of ops/pallas_blend_grouped.py."""
    if kernels.runs_plain(ranges):
        return blend_bwd_plain(
            ranges, payload, gid, accum, n_contrib, ckpt, ct_accum, ct_log_t_eff,
            num_gaussians, grid_w, grid_h,
        )
    kernels.library()  # builds on first use; raises where it cannot
    dev = ranges.device
    num_tiles = grid_w * grid_h
    m = payload.shape[1]
    kernels.check("ranges", ranges, torch.int32, (num_tiles, 2), dev)
    kernels.check("payload", payload, torch.float32, (PAYLOAD_ROWS, m), dev)
    kernels.check("gid", gid, torch.int32, (m,), dev)
    kernels.check("accum", accum, torch.float32, (num_tiles, PIX_PER_TILE, 3), dev)
    kernels.check("n_contrib", n_contrib, torch.int32, (num_tiles, PIX_PER_TILE), dev)
    kernels.check("ckpt", ckpt, torch.float32, (checkpoint_slots(num_tiles, m), PIX_PER_TILE, 4), dev)
    kernels.check("ct_accum", ct_accum, torch.float32, (num_tiles, PIX_PER_TILE, 3), dev)
    kernels.check("ct_log_t_eff", ct_log_t_eff, torch.float32, (num_tiles, PIX_PER_TILE), dev)
    grads = torch.zeros((num_gaussians, 9), dtype=torch.float32, device=dev)
    kernels.LAUNCHES["blend_bwd"] += 1
    kernels.launch(
        "gsdf_blend_bwd", ranges.data_ptr(), payload.data_ptr(), gid.data_ptr(),
        m, num_tiles, grid_w, accum.data_ptr(), n_contrib.data_ptr(), ckpt.data_ptr(),
        ct_accum.data_ptr(), ct_log_t_eff.data_ptr(), grads.data_ptr(),
    )
    return grads


class BinningCache(NamedTuple):
    """A frozen binning for reuse across steps of the same view.

    The pair -> Gaussian map and each tile's depth order are frozen at the
    export step; every cached step gathers fresh per-Gaussian payload, so
    values are exact and only membership and order are stale. The cache
    is valid only for the model (`num_gaussians` and `generation`, the
    model's surgery count when the cache was built) and image size it was
    built from.

    The TPU cache also holds `kept_bounds` (an input of its sorted fold),
    `compact_overflow` and 128-lane-aligned group starts; all three exist
    for XLA's static shapes. Here the cache is sized to its kept pairs, K2
    folds with atomics and K1 reads any offset, so none is needed.
    """

    ranges: torch.Tensor  # [T, 2] int32 [start, end) per tile in the compacted order
    gid: torch.Tensor  # [M'] int32 Gaussian of each kept pair
    total_pairs: int  # pre-cull pair count of the export step
    num_gaussians: int
    image_size: tuple[int, int]  # (height, width)
    generation: int = 0  # GaussianModel.generation at the export step


def build_pruned_cache(
    binned: Binned, keep: torch.Tensor | None, *, num_gaussians: int, image_size: tuple[int, int],
    generation: int = 0,
) -> BinningCache:
    """The cache of an export step, compacted to its kept pairs in their
    order (`build_pruned_cache`, pallas_blend_grouped.py:476-574); with
    `keep` None, the unpruned binning.

    Pruning is exact at export parameters: a pair that no pixel sees live
    with exclusive T >= T_EPS / margin is applied at no pixel, and where it
    is live its pixel is already past the frontier, so removing it changes
    no colour, no log T_eff and no gradient of the pairs that stay. The
    compaction reads the kept count back to the host (`nonzero`); the cache
    then has exactly that many pairs, so it cannot overflow (the TPU's
    `compact_cache_len`, `cache_prune_capacity_factor` and
    `compact_overflow` have no counterpart)."""
    ranges, gid = binned.ranges, binned.gid
    if keep is not None:
        csum = torch.cumsum(keep, 0, dtype=torch.int32)
        csum0 = torch.cat([csum.new_zeros(1), csum])
        ranges = csum0[ranges.to(torch.int64)]
        gid = gid[torch.nonzero(keep).squeeze(1)]
    return BinningCache(
        ranges=ranges, gid=gid, total_pairs=binned.total_pairs,
        num_gaussians=num_gaussians, image_size=tuple(image_size), generation=generation,
    )


class FreshBlend(torch.autograd.Function):
    """Binning + K1 forward (K4 on an export step); K2 backward. Outputs
    accum [T,256,3], log_t_eff [T,256], the pre-cull pair count (0-d int64)
    and, on an export step, the `Binned` pairs and K4's keep flags (None
    with margin 0); none of the last three has a gradient."""

    @staticmethod
    def forward(ctx, means2d, conics, opacities, colors, depths, rect_min,
                rect_max, tiles_touched, grid_w, grid_h, export_margin):
        with span("render.binning"):
            binned = bin_and_pack(
                depths, rect_min, rect_max, tiles_touched, means2d, conics,
                opacities, colors, grid_w=grid_w, grid_h=grid_h,
            )
        count("blend.pairs", binned.gid.shape[0])
        keep = None
        if export_margin:
            accum, log_t_eff, n_contrib, ckpt, keep = blend_fwd_export(
                binned.ranges, binned.payload, grid_w, grid_h, export_margin
            )
        else:
            accum, log_t_eff, n_contrib, ckpt = blend_fwd(binned.ranges, binned.payload, grid_w, grid_h)
        ctx.save_for_backward(binned.ranges, binned.payload, binned.gid, accum, n_contrib, ckpt)
        ctx.grid = (grid_w, grid_h)
        ctx.num_gaussians = means2d.shape[0]
        total = torch.tensor(binned.total_pairs, dtype=torch.int64)
        ctx.mark_non_differentiable(*(x for x in (total, keep) if x is not None))
        if export_margin is None:
            return accum, log_t_eff, total
        return accum, log_t_eff, total, binned, keep

    @staticmethod
    def backward(ctx, ct_accum, ct_log_t_eff, *_ct_rest):
        ranges, payload, gid, accum, n_contrib, ckpt = ctx.saved_tensors
        grid_w, grid_h = ctx.grid
        g = blend_bwd(
            ranges, payload, gid, accum, n_contrib, ckpt, ct_accum.contiguous(),
            ct_log_t_eff.contiguous(), ctx.num_gaussians, grid_w, grid_h,
        )
        return g[:, 0:2], g[:, 2:5], g[:, 5], g[:, 6:9], None, None, None, None, None, None, None


def _fresh_args(pre, opacities):
    return (pre.means2d, pre.conics, opacities, pre.colors, pre.depths.detach(),
            pre.rect_min, pre.rect_max, pre.tiles_touched)


def blend_tiles_fresh(pre, opacities, *, grid_w: int, grid_h: int):
    """Fresh-binning blend of a Preprocessed payload: (accum [T,256,3],
    log_t_eff [T,256], total_pairs 0-d int64)."""
    return FreshBlend.apply(*_fresh_args(pre, opacities), grid_w, grid_h, None)


def blend_tiles_export(pre, opacities, *, grid_w: int, grid_h: int, margin: float, image_size,
                       generation: int = 0):
    """The fresh blend of an export step (`_make_fused_blend(export=True)`):
    (accum, log_t_eff, total_pairs, BinningCache). With margin > 0 it runs
    K4 and prunes the cache to the pairs K4 keeps; with margin 0 it runs
    K1 and exports the unpruned binning."""
    accum, log_t_eff, total, binned, keep = FreshBlend.apply(
        *_fresh_args(pre, opacities), grid_w, grid_h, float(margin)
    )
    with span("render.binning"):
        cache = build_pruned_cache(
            binned, keep, num_gaussians=pre.means2d.shape[0], image_size=image_size, generation=generation,
        )
    return accum, log_t_eff, total, cache


class CachedBlend(torch.autograd.Function):
    """Blend through a frozen `BinningCache` (`_make_cached_blend`,
    pallas_blend_grouped.py:650-745): one gather of fresh payload by the
    cached gid in place of expand, cull, sort and K3; K1 forward, K2
    backward. Outputs accum [T,256,3] and log_t_eff [T,256]."""

    @staticmethod
    def forward(ctx, means2d, conics, opacities, colors, valid, ranges, gid, grid_w, grid_h):
        # Gaussians not valid this step (culled or faded since the export)
        # may carry non-finite payload; zero opacity makes them blend as
        # nothing, with no gradient, as the fresh path would (`_pack`, :666-689)
        ok = valid[:, None]
        ident = torch.zeros_like(conics[0])
        ident[0::2] = 1.0  # conic (1, 0, 1)
        table = payload_table(
            torch.where(ok, means2d, 0.0), torch.where(ok, conics, ident),
            torch.where(valid, opacities, 0.0), torch.where(ok, colors, 0.0),
        )
        payload = table.index_select(0, gid).t().contiguous()
        accum, log_t_eff, n_contrib, ckpt = blend_fwd(ranges, payload, grid_w, grid_h)
        ctx.save_for_backward(ranges, payload, gid, accum, n_contrib, ckpt, valid)
        ctx.grid = (grid_w, grid_h)
        return accum, log_t_eff

    @staticmethod
    def backward(ctx, ct_accum, ct_log_t_eff):
        ranges, payload, gid, accum, n_contrib, ckpt, valid = ctx.saved_tensors
        grid_w, grid_h = ctx.grid
        g = blend_bwd(
            ranges, payload, gid, accum, n_contrib, ckpt, ct_accum.contiguous(),
            ct_log_t_eff.contiguous(), valid.shape[0], grid_w, grid_h,
        )
        # the VJP of the sanitising `where`s (:724-742)
        g = torch.where(valid[:, None], g, 0.0)
        return g[:, 0:2], g[:, 2:5], g[:, 5], g[:, 6:9], None, None, None, None, None


def blend_tiles_cached(pre, opacities, cache: BinningCache, *, grid_w: int, grid_h: int):
    """Cached blend of a Preprocessed payload (`blend_tiles_grouped_cached`):
    (accum [T,256,3], log_t_eff [T,256], the cache's total_pairs 0-d int64).
    Rects and depths of `pre` are unused."""
    count("blend.pairs", cache.gid.shape[0])
    accum, log_t_eff = CachedBlend.apply(
        pre.means2d, pre.conics, opacities, pre.colors, pre.tiles_touched > 0,
        cache.ranges, cache.gid, grid_w, grid_h,
    )
    return accum, log_t_eff, torch.tensor(cache.total_pairs, dtype=torch.int64)
