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

The pair arrays are sized exactly from `tiles_touched.sum()`, read back
once per step, as the reference does with num_rendered.
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


def tile_opacity_keep(mx, my, a, b, c, opacity, tx, ty) -> torch.Tensor:
    """Keep mask: the Gaussian's peak opacity inside the 16x16 tile is
    >= 1/255 (max_contrib_power_rect_gaussian_float,
    rasterizer_impl.cu:66-118). Port of `ops/binning.py::_tile_opacity_keep`."""
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
    factor = torch.where((not_in_x + not_in_y) > 0.0, factor, 0.0)
    return factor <= torch.log(opacity * 255.0)


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
    """Expand, cull and stably sort the pairs.

    Returns (sorted 64-bit keys [M], sort permutation [M] int64, each kept
    pair's Gaussian in expansion order [M] int32, pre-cull total)."""
    dev = depths.device
    tt = tiles_touched.to(torch.int64)
    total = int(tt.sum())  # the one read-back that sizes the pair arrays
    starts = torch.cumsum(tt, 0) - tt
    gid = torch.repeat_interleave(
        torch.arange(tt.shape[0], device=dev), tt, output_size=total
    )
    local = torch.arange(total, device=dev) - starts[gid]
    rmin = rect_min.to(torch.int64)[gid]
    rw = torch.clamp_min((rect_max[:, 0] - rect_min[:, 0]).to(torch.int64)[gid], 1)
    tx = rmin[:, 0] + local % rw
    ty = rmin[:, 1] + local // rw
    m2 = means2d[gid]
    con = conics[gid]
    keep = tile_opacity_keep(
        m2[:, 0], m2[:, 1], con[:, 0], con[:, 1], con[:, 2], opacities[gid], tx, ty
    )
    kept = torch.nonzero(keep).squeeze(1)
    pair_gid = gid[kept]
    tile = ty[kept] * grid_w + tx[kept]
    depth_bits = depths.contiguous().view(torch.int32).to(torch.int64)[pair_gid] & 0xFFFFFFFF
    keys = (tile << 32) | depth_bits
    sorted_keys, order = torch.sort(keys, stable=True)
    return sorted_keys, order, pair_gid.to(torch.int32), total


def tile_ranges_pack_plain(keys, order, pair_gid, table, num_tiles):
    """Plain version of K3: `searchsorted` for the ranges, `index_select`
    for the sorted Gaussian ids and payload."""
    tiles = keys >> 32
    t = torch.arange(num_tiles, device=keys.device, dtype=torch.int64)
    start = torch.searchsorted(tiles, t, side="left")
    end = torch.searchsorted(tiles, t, side="right")
    empty = start == end
    ranges = torch.stack(
        [torch.where(empty, 0, start), torch.where(empty, 0, end)], dim=1
    ).to(torch.int32)
    gid = pair_gid.index_select(0, order)
    payload = table.index_select(0, gid).t().contiguous()
    return ranges, gid, payload


def tile_ranges_pack(keys, order, pair_gid, table, num_tiles):
    """K3: per-tile [start, end) of the sorted pairs (identifyTileRanges,
    rasterizer_impl.cu:217-246), each sorted pair's Gaussian id, and its
    payload gathered from the per-Gaussian `table` [P, 9] into a contiguous
    field-major [9, M] buffer. Replaces `_realign_kernel` and the
    `searchsorted` of `ops/pallas_binning.py:283-287`."""
    if kernels.runs_plain(keys):
        return tile_ranges_pack_plain(keys, order, pair_gid, table, num_tiles)
    kernels.library()  # builds on first use; raises where it cannot
    dev = keys.device
    m = keys.shape[0]
    kernels.check("keys", keys, torch.int64, (m,), dev)
    kernels.check("order", order, torch.int64, (m,), dev)
    kernels.check("pair_gid", pair_gid, torch.int32, (m,), dev)
    kernels.check("table", table, torch.float32, (-1, PAYLOAD_ROWS), dev)
    ranges = torch.zeros((num_tiles, 2), dtype=torch.int32, device=dev)
    gid = torch.empty((m,), dtype=torch.int32, device=dev)
    payload = torch.empty((PAYLOAD_ROWS, m), dtype=torch.float32, device=dev)
    if m > 0:
        kernels.LAUNCHES["tile_ranges_pack"] += 1
        kernels.launch(
            "gsdf_tile_ranges_pack", keys.data_ptr(), order.data_ptr(),
            pair_gid.data_ptr(), table.data_ptr(), m, ranges.data_ptr(),
            gid.data_ptr(), payload.data_ptr(),
        )
    return ranges, gid, payload


def payload_table(means2d, conics, opacities, colors) -> torch.Tensor:
    """Per-Gaussian blend payload [P, 9]: mean x, y, conic a, b, c, opacity, rgb."""
    return torch.cat([means2d, conics, opacities[:, None], colors], dim=1).contiguous()


def bin_and_pack(
    depths, rect_min, rect_max, tiles_touched, means2d, conics, opacities, colors,
    *, grid_w: int, grid_h: int,
) -> Binned:
    """The whole binning stage on detached inputs."""
    keys, order, pair_gid, total = expand_and_sort(
        depths, rect_min, rect_max, tiles_touched, means2d, conics, opacities,
        grid_w=grid_w,
    )
    ranges, gid, payload = tile_ranges_pack(
        keys, order, pair_gid, payload_table(means2d, conics, opacities, colors),
        grid_w * grid_h,
    )
    return Binned(ranges=ranges, gid=gid, payload=payload, total_pairs=total)
