"""Tile binning: expand Gaussians to (tile, Gaussian) pairs, cull, sort, pack.

Port of the binning half of `gsdf_slam_tpu/ops/pallas_binning.py::
sort_expand_pack` with the semantics of `ops/binning.py::bin_gaussians`
(the reference's duplicateWithKeys + radix sort + identifyTileRanges,
rasterizer_impl.cu:137-246, 456-500):

* pairs are expanded in buffer order: Gaussian index, then
  tx = rmin.x + local % rw, ty = rmin.y + local // rw;
* pairs whose peak in-tile opacity is below 1/255 are culled
  (`tile_opacity_keep`, rasterizer_impl.cu:66-118, with the D1 fix);
* one stable sort of the 64-bit key tile << 32 | depth bits orders the pairs
  by (tile, depth), ties in expansion order. Visible depths are > 0.2, so
  the float bits order like the floats;
* kernel K3 (`tile_ranges_pack`) finds each tile's [start, end) and gathers
  each sorted pair's blend payload into one contiguous field-major buffer.

Two routes give the same `Binned`, bit for bit. The plain route
(`bin_and_pack_plain`: `expand_and_sort`, then K3's plain version) is the
CPU's and the yardstick; it sizes the pair arrays exactly from
`tiles_touched.sum()`, read back, and its cull's `nonzero` reads the kept
count back. On the card `bin_and_pack_depth_first` sorts the Gaussians by
their depth bits, expands and culls them in that order with the kernels
`bin_count` and `bin_write` (csrc/binning.cu) around one read-back of both
totals, and sorts the pairs stably by the tile id alone: a Gaussian has one
pair at most in a tile, so the tile's pairs keep the depth order, ties by
Gaussian index.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from .projection import TILE

# rows of the payload: mean x, mean y, conic a, b, c, opacity, r, g, b
PAYLOAD_ROWS = 9


class Binned(NamedTuple):
    ranges: torch.Tensor  # [T, 2] int32 [start, end) per tile; (0, 0) if empty
    gid: torch.Tensor  # [M] int32 Gaussian of each sorted pair
    payload: torch.Tensor  # [9, M] float32 blend payload in sorted order
    total_pairs: int  # pre-cull pair count, sum of tiles_touched


def tile_peak_power(mx, my, a, b, c, tx, ty) -> torch.Tensor:
    """The Gaussian's exponent at its peak inside the 16x16 tile (tx, ty), 0
    where the mean lies in the tile (max_contrib_power_rect_gaussian_float,
    rasterizer_impl.cu:66-118): the pair is kept where it is <= log(opacity
    * 255). Port of `ops/binning.py::_tile_opacity_keep`'s power."""
    patch = float(TILE - 1)
    rect_min_x = (tx * TILE).to(torch.float32)
    rect_min_y = (ty * TILE).to(torch.float32)
    rect_max_x = rect_min_x + patch
    rect_max_y = rect_min_y + patch

    x_min_diff = rect_min_x - mx
    x_left = (x_min_diff > 0.0).to(torch.float32)
    not_in_x = x_left + (mx > rect_max_x).to(torch.float32)
    y_min_diff = rect_min_y - my
    y_above = (y_min_diff > 0.0).to(torch.float32)
    not_in_y = y_above + (my > rect_max_y).to(torch.float32)

    px = x_left * rect_min_x + (1.0 - x_left) * rect_max_x
    py = y_above * rect_min_y + (1.0 - y_above) * rect_max_y
    # D1 fix over the reference: a mean exactly on the rect boundary must
    # not walk the probe point away from it (strict comparisons)
    dx = torch.where(x_min_diff > 0.0, patch, -patch)
    dy = torch.where(y_min_diff > 0.0, patch, -patch)
    diffx = mx - px
    diffy = my - py

    txf = not_in_y * torch.clamp((dx * a * diffx + dx * b * diffy) / (patch * patch * a), 0.0, 1.0)
    tyf = not_in_x * torch.clamp((dy * b * diffx + dy * c * diffy) / (patch * patch * c), 0.0, 1.0)
    max_x = px + txf * dx
    max_y = py + tyf * dy

    ddx = mx - max_x
    ddy = my - max_y
    factor = 0.5 * (a * ddx * ddx + c * ddy * ddy) + b * ddx * ddy
    return torch.where((not_in_x + not_in_y) > 0.0, factor, 0.0)


def tile_opacity_keep(mx, my, a, b, c, opacity, tx, ty) -> torch.Tensor:
    """Keep mask: the Gaussian's peak opacity inside the 16x16 tile is
    >= 1/255 (max_contrib_power_rect_gaussian_float,
    rasterizer_impl.cu:66-118). Port of `ops/binning.py::_tile_opacity_keep`."""
    return tile_peak_power(mx, my, a, b, c, tx, ty) <= torch.log(opacity * 255.0)


def _expand_in_order(perm, tiles_touched, rect_min, rect_max, means2d, conics, log_op, grid_w):
    """Every pre-cull pair of the Gaussians in `perm`'s order, in expansion
    order: (the position in `perm` of its Gaussian, its tile, its Gaussian,
    its keep flag, the pre-cull count). `log_op` is log(opacity * 255) [P];
    the count's read-back sizes the pair arrays exactly."""
    dev = perm.device
    tt = torch.clamp_min(tiles_touched.to(torch.int64)[perm], 0)
    total = int(tt.sum())
    pos = torch.repeat_interleave(torch.arange(perm.shape[0], device=dev), tt, output_size=total)
    gid = perm[pos]
    local = torch.arange(total, device=dev) - (torch.cumsum(tt, 0) - tt)[pos]
    rmin = rect_min.to(torch.int64)[gid]
    rw = torch.clamp_min((rect_max[:, 0] - rect_min[:, 0]).to(torch.int64)[gid], 1)
    tx = rmin[:, 0] + local % rw
    ty = rmin[:, 1] + local // rw
    m2, con = means2d[gid], conics[gid]
    keep = tile_peak_power(m2[:, 0], m2[:, 1], con[:, 0], con[:, 1], con[:, 2], tx, ty) <= log_op[gid]
    return pos, ty * grid_w + tx, gid, keep, total


def expand_and_sort(
    depths: torch.Tensor,
    rect_min: torch.Tensor,
    rect_max: torch.Tensor,
    tiles_touched: torch.Tensor,
    means2d: torch.Tensor,
    conics: torch.Tensor,
    opacities: torch.Tensor,
    *,
    grid_w: int,
):
    """Expand the pairs in Gaussian order, cull them (`tile_opacity_keep`'s
    ops, the log taken per Gaussian) and sort them stably by 64-bit key.

    Returns (sorted 64-bit keys [M], sort permutation [M] int64, each kept
    pair's Gaussian in expansion order [M] int32, pre-cull total)."""
    perm = torch.arange(depths.shape[0], device=depths.device)
    _, tile, gid, keep, total = _expand_in_order(perm, tiles_touched, rect_min, rect_max, means2d, conics,
                                                 torch.log(opacities * 255.0), grid_w)
    pair_gid = gid[keep]  # the cull's read-back
    depth_bits = depths.contiguous().view(torch.int32).to(torch.int64)[pair_gid] & 0xFFFFFFFF
    keys = (tile[keep] << 32) | depth_bits
    sorted_keys, order = torch.sort(keys, stable=True)
    return sorted_keys, order, pair_gid.to(torch.int32), total


def tile_ranges_pack_plain(tiles, order, pair_gid, table, num_tiles):
    """Plain version of K3: `searchsorted` on the sorted tile ids for the
    ranges, `index_select` for the sorted Gaussian ids and payload."""
    tiles = tiles.to(torch.int64)
    t = torch.arange(num_tiles, device=tiles.device, dtype=torch.int64)
    start = torch.searchsorted(tiles, t, side="left")
    end = torch.searchsorted(tiles, t, side="right")
    empty = start == end
    ranges = torch.stack(
        [torch.where(empty, 0, start), torch.where(empty, 0, end)], dim=1
    ).to(torch.int32)
    gid = pair_gid.index_select(0, order)
    payload = table.index_select(0, gid).t().contiguous()
    return ranges, gid, payload


def tile_ranges_pack(tiles, order, pair_gid, table, num_tiles):
    """K3: per-tile [start, end) of the sorted pairs (identifyTileRanges,
    rasterizer_impl.cu:217-246) from their tile ids `tiles` (int32 on the
    card), each sorted pair's Gaussian id, and its payload gathered
    from the per-Gaussian `table` [P, 9] into a contiguous field-major
    [9, M] buffer. Replaces `_realign_kernel` and the `searchsorted` of
    `ops/pallas_binning.py:283-287`."""
    if kernels.runs_plain(tiles):
        return tile_ranges_pack_plain(tiles, order, pair_gid, table, num_tiles)
    kernels.library()  # builds on first use; raises where it cannot
    dev = tiles.device
    m = tiles.shape[0]
    kernels.check("tiles", tiles, torch.int32, (m,), dev)
    kernels.check("order", order, torch.int64, (m,), dev)
    kernels.check("pair_gid", pair_gid, torch.int32, (m,), dev)
    kernels.check("table", table, torch.float32, (-1, PAYLOAD_ROWS), dev)
    ranges = torch.zeros((num_tiles, 2), dtype=torch.int32, device=dev)
    gid = torch.empty((m,), dtype=torch.int32, device=dev)
    payload = torch.empty((PAYLOAD_ROWS, m), dtype=torch.float32, device=dev)
    if m > 0:
        kernels.LAUNCHES["tile_ranges_pack"] += 1
        kernels.launch(
            "gsdf_tile_ranges_pack", tiles.data_ptr(), order.data_ptr(),
            pair_gid.data_ptr(), table.data_ptr(), m, ranges.data_ptr(), gid.data_ptr(), payload.data_ptr(),
        )
    return ranges, gid, payload


def depth_order(depths: torch.Tensor) -> torch.Tensor:
    """The Gaussians [P] int64 ordered by their depth's float bits read
    unsigned, ties by index: one stable sort of the bits with the sign bit
    flipped, which orders them as int32 as they order unsigned."""
    bits = depths.contiguous().view(torch.int32) ^ torch.iinfo(torch.int32).min
    return torch.sort(bits, stable=True)[1]


def bin_count_plain(perm, tiles_touched, rect_min, rect_max, means2d, conics, log_op, *, grid_w: int):
    """Plain version of `bin_count`."""
    pos, _, _, keep, total = _expand_in_order(perm, tiles_touched, rect_min, rect_max, means2d, conics, log_op,
                                              grid_w)
    n_warps = (perm.shape[0] + 31) // 32
    counts = torch.bincount(pos[keep] // 32, minlength=n_warps).to(torch.int32)
    totals = torch.tensor([int(keep.sum()), total], dtype=torch.int64, device=perm.device)
    return counts, totals


def _check_gaussians(perm, tiles_touched, rect_min, rect_max, means2d, conics, log_op):
    dev, p = perm.device, perm.shape[0]
    kernels.check("perm", perm, torch.int64, (p,), dev)
    kernels.check("tiles_touched", tiles_touched, torch.int32, (p,), dev)
    kernels.check("rect_min", rect_min, torch.int32, (p, 2), dev)
    kernels.check("rect_max", rect_max, torch.int32, (p, 2), dev)
    kernels.check("means2d", means2d, torch.float32, (p, 2), dev)
    kernels.check("conics", conics, torch.float32, (p, 3), dev)
    kernels.check("log_op", log_op, torch.float32, (p,), dev)
    return dev, p


def bin_count(perm, tiles_touched, rect_min, rect_max, means2d, conics, log_op, *, grid_w: int):
    """Kernel `bin_count`: for the Gaussians in `perm`'s order (depth order),
    the kept pairs of each 32 of them, counts [ceil(P / 32)] int32, and the
    totals [2] int64 (kept pairs, pre-cull pairs). `log_op` is
    log(opacity * 255) [P]. Replaces no Pallas kernel (csrc/binning.cu)."""
    args = (perm, tiles_touched, rect_min, rect_max, means2d, conics, log_op)
    if kernels.runs_plain(perm):
        return bin_count_plain(*args, grid_w=grid_w)
    kernels.library()  # builds on first use; raises where it cannot
    dev, p = _check_gaussians(*args)
    counts = torch.empty(((p + 31) // 32,), dtype=torch.int32, device=dev)
    totals = torch.empty((2,), dtype=torch.int64, device=dev)
    if p > 0:
        kernels.LAUNCHES["bin_count"] += 1
    # zeroes the totals, and launches the kernel where there are Gaussians
    kernels.launch("gsdf_bin_count", perm.data_ptr(), p, *(t.data_ptr() for t in args[1:]), grid_w,
                   counts.data_ptr(), totals.data_ptr())
    return counts, totals


def bin_write_plain(perm, tiles_touched, rect_min, rect_max, means2d, conics, log_op, warp_end, m: int, *,
                    grid_w: int):
    """Plain version of `bin_write` (`warp_end` and `m` only place and size
    what it computes whole)."""
    _, tile, gid, keep, _ = _expand_in_order(perm, tiles_touched, rect_min, rect_max, means2d, conics, log_op,
                                             grid_w)
    return tile[keep].to(torch.int32), gid[keep].to(torch.int32)


def bin_write(perm, tiles_touched, rect_min, rect_max, means2d, conics, log_op, warp_end, m: int, *,
              grid_w: int):
    """Kernel `bin_write`: the `m` kept pairs of the Gaussians in `perm`'s
    order, in expansion order: their tile ids [m] int32 and Gaussians [m]
    int32. `warp_end` [ceil(P / 32)] int64 is the
    inclusive scan of `bin_count`'s counts and `m` its kept total."""
    args = (perm, tiles_touched, rect_min, rect_max, means2d, conics, log_op)
    if kernels.runs_plain(perm):
        return bin_write_plain(*args, warp_end, m, grid_w=grid_w)
    kernels.library()  # builds on first use; raises where it cannot
    dev, p = _check_gaussians(*args)
    kernels.check("warp_end", warp_end, torch.int64, ((p + 31) // 32,), dev)
    tiles = torch.empty((m,), dtype=torch.int32, device=dev)
    pair_gid = torch.empty((m,), dtype=torch.int32, device=dev)
    if m > 0:
        kernels.LAUNCHES["bin_write"] += 1
        kernels.launch("gsdf_bin_write", perm.data_ptr(), p, *(t.data_ptr() for t in args[1:]), grid_w,
                       warp_end.data_ptr(), tiles.data_ptr(), pair_gid.data_ptr())
    return tiles, pair_gid


def payload_table(means2d, conics, opacities, colors) -> torch.Tensor:
    """Per-Gaussian blend payload [P, 9]: mean x, y, conic a, b, c, opacity, rgb."""
    return torch.cat([means2d, conics, opacities[:, None], colors], dim=1).contiguous()


def bin_and_pack_plain(
    depths, rect_min, rect_max, tiles_touched, means2d, conics, opacities, colors,
    *, grid_w: int, grid_h: int,
) -> Binned:
    """The plain route on detached inputs: `expand_and_sort`, then K3's
    plain version. Two read-backs (the pre-cull count, the cull's
    `nonzero`)."""
    keys, order, pair_gid, total = expand_and_sort(
        depths, rect_min, rect_max, tiles_touched, means2d, conics, opacities,
        grid_w=grid_w,
    )
    ranges, gid, payload = tile_ranges_pack_plain(
        keys >> 32, order, pair_gid, payload_table(means2d, conics, opacities, colors),
        grid_w * grid_h,
    )
    return Binned(ranges=ranges, gid=gid, payload=payload, total_pairs=total)


def bin_and_pack_depth_first(
    depths, rect_min, rect_max, tiles_touched, means2d, conics, opacities, colors,
    *, grid_w: int, grid_h: int,
) -> Binned:
    """The card's route on detached inputs, `bin_and_pack_plain`'s `Binned`
    bit for bit: the Gaussians sorted by their depth bits; `bin_count`,
    one read-back of the kept and pre-cull totals, `bin_write` in that
    order; a stable sort of the tile ids alone; K3. Each kernel wrapper
    takes its plain version on the CPU."""
    num_tiles = grid_w * grid_h
    perm = depth_order(depths)
    log_op = torch.log(opacities * 255.0)  # the plain cull's own op
    gauss = (perm, tiles_touched, rect_min, rect_max, means2d.contiguous(), conics.contiguous(), log_op)
    counts, totals = bin_count(*gauss, grid_w=grid_w)
    warp_end = torch.cumsum(counts, 0)
    table = payload_table(means2d, conics, opacities, colors)
    kept, total = totals.tolist()  # the one read-back: both totals in one copy
    tiles, pair_gid = bin_write(*gauss, warp_end, kept, grid_w=grid_w)
    sorted_tiles, order = torch.sort(tiles, stable=True)
    ranges, gid, payload = tile_ranges_pack(sorted_tiles, order, pair_gid, table, num_tiles)
    return Binned(ranges=ranges, gid=gid, payload=payload, total_pairs=total)


def bin_and_pack(
    depths, rect_min, rect_max, tiles_touched, means2d, conics, opacities, colors,
    *, grid_w: int, grid_h: int,
) -> Binned:
    """The whole binning stage on detached inputs: the plain route on a CPU
    tensor, the card's route (`bin_and_pack_depth_first`) on a CUDA one."""
    route = bin_and_pack_plain if kernels.runs_plain(depths) else bin_and_pack_depth_first
    return route(depths, rect_min, rect_max, tiles_touched, means2d, conics, opacities, colors,
                 grid_w=grid_w, grid_h=grid_h)
