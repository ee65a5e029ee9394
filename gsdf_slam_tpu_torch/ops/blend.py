"""Tile alpha blending: constants, plain forward/backward, image assembly.

Port of `gsdf_slam_tpu/ops/blend.py`. `blend_fwd_plain` and
`blend_bwd_plain` are the plain PyTorch versions of kernels K1 and K2
(`ops/tile_blend.py`): the chunked scans `_forward_scan` and
`_backward_scan`, reading the contiguous sorted payload that K3 packs.

Early-termination parity (PARITY.md D9): the reference stops a pixel once
T * (1 - alpha) < 1e-4 (forward.cu:437-442). Raw transmittance never
increases, so "pair k is applied" is exactly: inclusive raw log T >=
log(1e-4). The applied pairs of a pixel are therefore a prefix of its
tile's pairs, ending at `n_contrib` (the last applied live pair + 1), and
log T_eff is the raw log T at that pair.

The backward follows the reference's conventions (backward.cu:598-640):
dL/dalpha uses the suffix sum of later w * (c . dL/dpixel) plus the
cotangent of log T_eff; the 0.99 opacity clamp is not gated
(dL/dG = opacity * dL/dalpha); skipped pairs get zero gradient. The
transmittance is rebuilt backwards, log T_start = log T_end - log1p(-alpha).

Within a chunk the segmented prefix sums are taken in float64 and rounded
once, so the plain versions carry no cancellation error from the pairs of
other tiles in the chunk.
"""

from __future__ import annotations

import numpy as np
import torch

from .projection import TILE

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
LOG_T_EPS = float(np.float32(np.log(T_EPS)))
PIX_PER_TILE = TILE * TILE  # 256
# pairs per step of the plain versions' scans: [4096, 256] float panels
PLAIN_CHUNK = 4096


def _pixel_offsets(device):
    j = torch.arange(PIX_PER_TILE, device=device)
    return (j % TILE).to(torch.float32), (j // TILE).to(torch.float32)


def pair_tiles(ranges: torch.Tensor, m: int):
    """Tile of each sorted pair [M] and its index within the tile [M]."""
    num_tiles = ranges.shape[0]
    counts = (ranges[:, 1] - ranges[:, 0]).to(torch.int64)
    tile = torch.repeat_interleave(
        torch.arange(num_tiles, device=ranges.device), counts, output_size=m
    )
    local = torch.arange(m, device=ranges.device) - ranges[:, 0].to(torch.int64)[tile]
    return tile, local


def _segment_starts(t: torch.Tensor) -> torch.Tensor:
    """Index of the first pair of each tile segment within a chunk [K]."""
    idx = torch.arange(t.shape[0], device=t.device)
    is_start = torch.ones_like(t, dtype=torch.bool)
    is_start[1:] = t[1:] != t[:-1]
    return torch.cummax(torch.where(is_start, idx, 0), 0).values


def _segmented_prefix(x: torch.Tensor, seg: torch.Tensor):
    """(exclusive, inclusive) prefix sums of x [K, 256] within each tile
    segment, in float64."""
    incl = torch.cumsum(x.to(torch.float64), 0)
    excl = incl - x
    base = excl[seg]
    return excl - base, incl - base


def _geometry(pl: torch.Tensor, t: torch.Tensor, grid_w: int, dxl, dyl):
    """Per-(pair, pixel) quantities of one chunk; pl is the [9, K] payload."""
    mx, my, a, b, c, op = (pl[i][:, None] for i in range(6))
    tile_x = (t % grid_w).to(torch.float32)[:, None] * TILE
    tile_y = (t // grid_w).to(torch.float32)[:, None] * TILE
    dx = mx - (tile_x + dxl[None, :])
    dy = my - (tile_y + dyl[None, :])
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    g = torch.exp(power)
    alpha = torch.clamp_max(op * g, ALPHA_MAX)
    live = (power <= 0.0) & (alpha >= ALPHA_MIN)
    return alpha, live, g, dx, dy


def blend_fwd_plain(ranges, payload, grid_w: int, grid_h: int):
    """Plain version of K1. Returns accum [T,256,3], log_t_eff [T,256] and
    n_contrib [T,256] int32."""
    dev = payload.device
    num_tiles = grid_w * grid_h
    m = payload.shape[1]
    dxl, dyl = _pixel_offsets(dev)
    log_raw = torch.zeros((num_tiles, PIX_PER_TILE), device=dev)
    log_eff = torch.zeros((num_tiles, PIX_PER_TILE), device=dev)
    accum = torch.zeros((num_tiles, PIX_PER_TILE, 3), device=dev)
    n_contrib = torch.zeros((num_tiles, PIX_PER_TILE), dtype=torch.int32, device=dev)
    tile, local = pair_tiles(ranges, m)
    for s in range(0, m, PLAIN_CHUNK):
        t = tile[s : s + PLAIN_CHUNK]
        pl = payload[:, s : s + PLAIN_CHUNK]
        alpha, live, _, _, _ = _geometry(pl, t, grid_w, dxl, dyl)
        alpha = torch.where(live, alpha, 0.0)
        log1m = torch.log1p(-alpha)
        excl, incl = _segmented_prefix(log1m, _segment_starts(t))
        carry = log_raw[t]
        t_excl = torch.exp(carry + excl.to(torch.float32))
        applied = (carry + incl.to(torch.float32)) >= LOG_T_EPS
        w = alpha * t_excl * applied
        col = pl[6:9].t()
        accum.index_add_(0, t, w[:, :, None] * col[:, None, :])
        log_raw.index_add_(0, t, log1m)
        log_eff.index_add_(0, t, torch.where(applied, log1m, 0.0))
        idx = (local[s : s + PLAIN_CHUNK] + 1).to(torch.int32)[:, None]
        cand = torch.where(applied & live, idx, 0)
        n_contrib.scatter_reduce_(0, t[:, None].expand_as(cand), cand, reduce="amax")
    return accum, log_eff, n_contrib


def blend_bwd_plain(
    ranges, payload, gid, log_t_eff, n_contrib, ct_accum, ct_log_t_eff,
    num_gaussians: int, grid_w: int, grid_h: int,
):
    """Plain version of K2, with the fold to per-Gaussian gradients.

    Returns [P, 9]: dL/d(mean x, y), dL/d(conic a, b, c), dL/d opacity,
    dL/d rgb."""
    dev = payload.device
    num_tiles = grid_w * grid_h
    m = payload.shape[1]
    dxl, dyl = _pixel_offsets(dev)
    grads = torch.zeros((num_gaussians, 9), device=dev)
    tile, local = pair_tiles(ranges, m)
    log_end = log_t_eff.clone()
    suffix = torch.zeros((num_tiles, PIX_PER_TILE), device=dev)
    for s in reversed(range(0, m, PLAIN_CHUNK)):
        t = tile[s : s + PLAIN_CHUNK]
        pl = payload[:, s : s + PLAIN_CHUNK]
        alpha, live, g, dx, dy = _geometry(pl, t, grid_w, dxl, dyl)
        applied = live & (local[s : s + PLAIN_CHUNK][:, None] < n_contrib[t])
        alpha = torch.where(applied, alpha, 0.0)
        log1m = torch.log1p(-alpha)
        log_start = log_end.index_add(0, t, -log1m)
        seg = _segment_starts(t)
        excl, _ = _segmented_prefix(log1m, seg)
        t_excl = torch.exp(log_start[t] + excl.to(torch.float32))
        w = torch.where(applied, alpha * t_excl, 0.0)

        col = pl[6:9]
        ct = ct_accum[t]  # [K, 256, 3]
        dot_c = col[0][:, None] * ct[..., 0] + col[1][:, None] * ct[..., 1] + col[2][:, None] * ct[..., 2]
        wc = w * dot_c
        # exclusive suffix of wc within the chunk's tile segment
        _, in_seg_incl = _segmented_prefix(wc, seg)
        seg_total = torch.zeros((num_tiles, PIX_PER_TILE), dtype=torch.float64, device=dev)
        seg_total.index_add_(0, t, wc.to(torch.float64))
        sfx = (seg_total[t] - in_seg_incl).to(torch.float32) + suffix[t]

        inv_1m = 1.0 / (1.0 - alpha)
        dl_dalpha = torch.where(applied, t_excl * dot_c - (sfx + ct_log_t_eff[t]) * inv_1m, 0.0)
        a, b, c, op = (pl[i][:, None] for i in range(2, 6))
        dl_dg = op * dl_dalpha
        gdx = g * dx
        gdy = g * dy
        pair = torch.stack(
            [
                torch.sum(dl_dg * (-gdx * a - gdy * b), 1),
                torch.sum(dl_dg * (-gdy * c - gdx * b), 1),
                torch.sum(dl_dg * (-0.5 * g * dx * dx), 1),
                torch.sum(dl_dg * (-g * dx * dy), 1),
                torch.sum(dl_dg * (-0.5 * g * dy * dy), 1),
                torch.sum(g * dl_dalpha, 1),
                torch.sum(w * ct[..., 0], 1),
                torch.sum(w * ct[..., 1], 1),
                torch.sum(w * ct[..., 2], 1),
            ],
            dim=1,
        )
        grads.index_add_(0, gid[s : s + PLAIN_CHUNK].to(torch.int64), pair)
        suffix.index_add_(0, t, wc)
        log_end = log_start
    return grads


def assemble_image(accum, log_t_eff, bg, *, grid_w: int, grid_h: int, width: int, height: int):
    """Composite the background and crop the tile grid to the image:
    out = C + final_T * bg (forward.cu:458-463). Returns (image [H, W, 3],
    final_T [H, W])."""
    final_t = torch.exp(log_t_eff)
    tiles = accum + final_t[:, :, None] * bg[None, None, :]
    img = tiles.reshape(grid_h, grid_w, TILE, TILE, 3).permute(0, 2, 1, 3, 4)
    img = img.reshape(grid_h * TILE, grid_w * TILE, 3)[:height, :width]
    ft = final_t.reshape(grid_h, grid_w, TILE, TILE).permute(0, 2, 1, 3)
    ft = ft.reshape(grid_h * TILE, grid_w * TILE)[:height, :width]
    return img, ft
