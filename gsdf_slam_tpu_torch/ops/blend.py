"""Tile alpha blending: constants, plain forward/backward, image assembly.

Port of `gsdf_slam_tpu/ops/blend.py`. `blend_fwd_plain` and
`blend_bwd_plain` are the plain PyTorch versions of kernels K1 and K2
(`ops/tile_blend.py`), reading the contiguous sorted payload that K3
packs: the forward scans chunks of pairs, the backward K2's 32-pair
buckets from the forward's checkpoints. `blend_fwd_plain` with
`keep_margin` is also the plain version of K4.

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
transmittance and colour are rebuilt forward from the checkpoint at the
pair's bucket start, and the suffix is ct . (accum - colour through the
pair).

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
# pairs per step of the plain forward's scans: [4096, 256] float panels
PLAIN_CHUNK = 4096
# pairs per bucket: the forward's checkpoints and K2's unit of work
BUCKET = 32
# buckets per step of the plain backward: [64, 256, 32] float panels
PLAIN_BUCKETS = 64


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


def checkpoint_slots(num_tiles: int, m: int) -> int:
    """Rows of the checkpoint buffer for T tiles and M pairs. Bucket b of
    tile t lives in row t + start_t // 32 + b; a tile's buckets end before
    the next tile's start, so the rows are distinct and below T + M // 32."""
    return num_tiles + m // BUCKET


def checkpoint_first(ranges: torch.Tensor) -> torch.Tensor:
    """Checkpoint row of each tile's first bucket [T] int64."""
    return torch.arange(ranges.shape[0], device=ranges.device) + ranges[:, 0].to(torch.int64) // BUCKET


def live_buckets(ranges: torch.Tensor, n_contrib: torch.Tensor):
    """The buckets K2 runs, those that start below their tile's largest
    n_contrib: (tile, bucket index, checkpoint row), [NB] int64 each."""
    n_buckets = (n_contrib.amax(1).to(torch.int64) + BUCKET - 1) // BUCKET
    total = int(n_buckets.sum())
    tile = torch.repeat_interleave(
        torch.arange(ranges.shape[0], device=ranges.device), n_buckets, output_size=total
    )
    b = torch.arange(total, device=ranges.device) - (torch.cumsum(n_buckets, 0) - n_buckets)[tile]
    return tile, b, checkpoint_first(ranges)[tile] + b


def checkpoints_read(ranges: torch.Tensor, n_contrib: torch.Tensor):
    """The checkpoint words K2 reads: (rows [NB] int64, mask [NB, 256]
    bool), the pixels of each live bucket b with 32b < n_contrib."""
    tile, b, rows = live_buckets(ranges, n_contrib)
    return rows, (b * BUCKET)[:, None] < n_contrib[tile]


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


def _excl_prefix_last(x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sums of x [..., K] along its last axis within each
    tile segment of the chunk, in float64."""
    x = x.to(torch.float64).contiguous()
    excl = torch.cumsum(x, -1) - x
    return excl - excl[..., seg]


def keep_log_exit(margin: float) -> float:
    """The export keep test's threshold log(T_EPS / margin), rounded to
    float32 as the TPU kernel compares it (pallas_blend_grouped.py:109)."""
    return float(np.float32(np.log(T_EPS) - np.log(margin)))


def blend_fwd_plain(ranges, payload, grid_w: int, grid_h: int, keep_margin: float | None = None):
    """Plain version of K1. Returns accum [T,256,3], log_t_eff [T,256],
    n_contrib [T,256] int32 and the checkpoints [T + M // 32, 256, 4]: at
    local pair 32b of tile t, row t + start_t // 32 + b holds each pixel's
    exclusive raw log T and colour prefix (carry + excl, and the segmented
    prefix of w * c). While the pixel still applies, that is its applied
    log T and colour (K1's checkpoint), which K2 reads where 32b <
    n_contrib; rows of no bucket are 0.

    With `keep_margin`, the plain version of K4: it also returns keep [M]
    bool, True for a pair that some pixel of its tile sees live (alpha > 0)
    while the pixel's exclusive raw log T is >= log(T_EPS / keep_margin)
    (`_fwd_kernel` with keep_margin, pallas_blend_grouped.py:173-184)."""
    dev = payload.device
    num_tiles = grid_w * grid_h
    m = payload.shape[1]
    dxl, dyl = _pixel_offsets(dev)
    log_raw = torch.zeros((num_tiles, PIX_PER_TILE), device=dev)
    log_eff = torch.zeros((num_tiles, PIX_PER_TILE), device=dev)
    accum = torch.zeros((num_tiles, PIX_PER_TILE, 3), device=dev)
    n_contrib = torch.zeros((num_tiles, PIX_PER_TILE), dtype=torch.int32, device=dev)
    keep = None if keep_margin is None else torch.zeros((m,), dtype=torch.bool, device=dev)
    ckpt = torch.zeros((checkpoint_slots(num_tiles, m), PIX_PER_TILE, 4), device=dev)
    first = checkpoint_first(ranges)
    tile, local = pair_tiles(ranges, m)
    for s in range(0, m, PLAIN_CHUNK):
        t = tile[s : s + PLAIN_CHUNK]
        pl = payload[:, s : s + PLAIN_CHUNK]
        alpha, live, _, _, _ = _geometry(pl, t, grid_w, dxl, dyl)
        alpha = torch.where(live, alpha, 0.0)
        log1m = torch.log1p(-alpha)
        seg = _segment_starts(t)
        excl, incl = _segmented_prefix(log1m, seg)
        carry = log_raw[t]
        t_excl = torch.exp(carry + excl.to(torch.float32))
        applied = (carry + incl.to(torch.float32)) >= LOG_T_EPS
        w = alpha * t_excl * applied
        col = pl[6:9].t()
        wc = w[:, :, None] * col[:, None, :]
        loc = local[s : s + PLAIN_CHUNK]
        rows = torch.nonzero(loc % BUCKET == 0).squeeze(1)  # the chunk's bucket starts
        if rows.numel():
            tr = t[rows]
            c_excl = _excl_prefix_last(wc.permute(1, 2, 0), seg)[..., rows].permute(2, 0, 1)
            ckpt[first[tr] + loc[rows] // BUCKET] = torch.cat(
                [(carry[rows] + excl[rows].to(torch.float32))[..., None], accum[tr] + c_excl.to(torch.float32)],
                -1)
        accum.index_add_(0, t, wc)
        log_raw.index_add_(0, t, log1m)
        log_eff.index_add_(0, t, torch.where(applied, log1m, 0.0))
        idx = (local[s : s + PLAIN_CHUNK] + 1).to(torch.int32)[:, None]
        cand = torch.where(applied & live, idx, 0)
        n_contrib.scatter_reduce_(0, t[:, None].expand_as(cand), cand, reduce="amax")
        if keep is not None:
            seen = live & ((carry + excl.to(torch.float32)) >= keep_log_exit(keep_margin))
            keep[s : s + PLAIN_CHUNK] = seen.any(1)
    if keep is not None:
        return accum, log_eff, n_contrib, ckpt, keep
    return accum, log_eff, n_contrib, ckpt


def _bucket_steps(ranges, payload, n_contrib, grid_w: int):
    """The live buckets (those that start below their tile's largest
    n_contrib), PLAIN_BUCKETS at a time. Yields, per step of K buckets: the
    tile [K], checkpoint row [K], pair index [K, 32] (0 past the tile's
    end), valid [K, 32] (the pair lies in the tile), payload [9, K, 32], and
    [K, 256, 32] (pixel, then the bucket's pairs innermost) dx, dy,
    g = exp(power), alpha and applied (the pair is live at the pixel and
    below its n_contrib)."""
    dev = payload.device
    dxl, dyl = _pixel_offsets(dev)
    start = ranges[:, 0].to(torch.int64)
    count = (ranges[:, 1] - ranges[:, 0]).to(torch.int64)
    b_tile, b_idx, b_row = live_buckets(ranges, n_contrib)
    lane = torch.arange(BUCKET, device=dev)
    for s in range(0, b_tile.shape[0], PLAIN_BUCKETS):
        t, b = b_tile[s : s + PLAIN_BUCKETS], b_idx[s : s + PLAIN_BUCKETS]
        jl = b[:, None] * BUCKET + lane  # pair index within the tile
        valid = jl < count[t][:, None]
        j = torch.where(valid, start[t][:, None] + jl, 0)
        pl = payload[:, j]
        mx, my, a, bq, c, op = (pl[i][:, None, :] for i in range(6))
        dx = mx - (((t % grid_w) * TILE).to(torch.float32)[:, None, None] + dxl[None, :, None])
        dy = my - (((t // grid_w) * TILE).to(torch.float32)[:, None, None] + dyl[None, :, None])
        power = -0.5 * (a * dx * dx + c * dy * dy) - bq * dx * dy
        g = torch.exp(power)
        alpha = torch.clamp_max(op * g, ALPHA_MAX)
        live = (power <= 0.0) & (alpha >= ALPHA_MIN)
        applied = live & valid[:, None, :] & (jl[:, None, :] < n_contrib[t][:, :, None])
        yield t, b_row[s : s + PLAIN_BUCKETS], j, valid, pl, dx, dy, g, alpha, applied


def bucket_counts(ranges, payload, n_contrib, grid_w: int) -> dict:
    """What a binning makes K2 do: `live_buckets`, `applied` (pixel-pairs
    applied, each with an expf of the exponent, an expf of log T and a
    reciprocal) and `taken` (pairs some pixel applied, each folded with
    nine atomics)."""
    applied_n = taken_n = 0
    for *_, applied in _bucket_steps(ranges, payload, n_contrib, grid_w):
        applied_n += int(applied.sum())
        taken_n += int(applied.any(1).sum())
    return dict(live_buckets=live_buckets(ranges, n_contrib)[0].shape[0], applied=applied_n, taken=taken_n)


def blend_bwd_plain(
    ranges, payload, gid, accum, n_contrib, ckpt, ct_accum, ct_log_t_eff,
    num_gaussians: int, grid_w: int, grid_h: int,
):
    """Plain version of K2, with the fold to per-Gaussian gradients, in
    K2's bucket form: for each bucket of 32 pairs that starts below its
    tile's largest n_contrib, start every pixel from its checkpoint, scan
    log(1 - alpha) and w * c over the bucket's pairs (the innermost axis),
    and take the suffix of later colour as accum minus the colour through
    the pair.

    Returns [P, 9]: dL/d(mean x, y), dL/d(conic a, b, c), dL/d opacity,
    dL/d rgb."""
    grads = torch.zeros((num_gaussians, 9), device=payload.device)
    for t, rows, j, valid, pl, dx, dy, g, alpha, applied in _bucket_steps(ranges, payload, n_contrib, grid_w):
        a, bq, c, op = (pl[i][:, None, :] for i in range(2, 6))
        ck = ckpt[rows]  # [K, 256, 4]: log T, c0, c1, c2 at pair 32b
        alpha = torch.where(applied, alpha, 0.0)
        log1m = torch.log1p(-alpha)
        l64 = log1m.to(torch.float64)
        t_excl = torch.exp(ck[..., 0:1] + (torch.cumsum(l64, -1) - l64).to(torch.float32))
        w = torch.where(applied, alpha * t_excl, 0.0)
        col = pl[6:9][:, :, None, :]  # [3, K, 1, 32]
        ct = ct_accum[t]  # [K, 256, 3]
        # colour through each pair, from the checkpoint, in float64
        through = ck[..., 1:4].permute(2, 0, 1)[..., None].to(torch.float64) + torch.cumsum(
            (w[None] * col).to(torch.float64), -1)
        acc = accum[t].to(torch.float64)
        sfx = sum(ct[..., ch, None] * (acc[..., ch, None] - through[ch]) for ch in range(3)).to(torch.float32)
        dot_c = col[0] * ct[..., 0, None] + col[1] * ct[..., 1, None] + col[2] * ct[..., 2, None]
        inv_1m = 1.0 / (1.0 - alpha)
        dl_dalpha = torch.where(applied, t_excl * dot_c - (sfx + ct_log_t_eff[t][..., None]) * inv_1m, 0.0)
        dl_dg = op * dl_dalpha
        gdx = g * dx
        gdy = g * dy
        pair = torch.stack(
            [
                torch.sum(dl_dg * (-gdx * a - gdy * bq), 1),
                torch.sum(dl_dg * (-gdy * c - gdx * bq), 1),
                torch.sum(dl_dg * (-0.5 * g * dx * dx), 1),
                torch.sum(dl_dg * (-g * dx * dy), 1),
                torch.sum(dl_dg * (-0.5 * g * dy * dy), 1),
                torch.sum(g * dl_dalpha, 1),
                torch.sum(w * ct[..., 0, None], 1),
                torch.sum(w * ct[..., 1, None], 1),
                torch.sum(w * ct[..., 2, None], 1),
            ],
            dim=-1,
        )  # [K, 32, 9]
        grads.index_add_(0, gid[j[valid]].to(torch.int64), pair[valid])
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
