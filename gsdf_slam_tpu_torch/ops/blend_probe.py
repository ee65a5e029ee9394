"""Probe kernels of the blend and of the binning expansion, with their
plain versions.

Port of the measurement probes in `benchmarks/kernel_probe.py` and
`benchmarks/expand_probe.py`. Each probe computes what its TPU body
computes at `group=1`, where a TPU group is one tile: the tile's
depth-sorted pairs are walked in `chunk`-pair chunks and the tile stops,
where the mode has an exit, once no pixel's raw log T is >= log(1e-4) at a
chunk boundary (the TPU's `cond`). Edge pixels outside the image count.

Forward modes of `blend_probe_fwd` (kernel `csrc/blend_probe.cu`), each
returning accum [T,256,3], log_t_eff [T,256], log_t_raw [T,256] and n_done
[T] int32, the number of chunks walked (the TPU's accum, teff, traw,
ndone):

- `floor` (`_fwd_kernel_floor`): staging and loop only; log_t_eff holds
  the sum over chunks of 1e-30 x the sum of the chunk's mean x, accum and
  log_t_raw are 0, every chunk is walked;
- `nocarry` (`_fwd_kernel_variant("nomxu")`): the carry replaced by the
  stand-ins incl = 0.5 l1m, carry = 0.25 l1m; accum gets sum w col0 on all
  three channels;
- `notrans` (`_fwd_kernel_variant("novpu")`): production carry with
  log1p(-alpha) -> -alpha and exp(log T) -> log T;
- `noexit` (`_fwd_kernel_noterm`): production math over every chunk;
- `chunk_exit` (`_fwd_kernel_opt`, `_fwd_kernel_roll`): production math
  with the chunk-granular exit;
- `unroll2` (`_fwd_kernel_unroll2`): production math, exit tested every
  second chunk, n_done = min(chunks walked in pairs, n_chunks).

`blend_probe_fwd_pair2` (`_fwd_kernel_pair2`) walks tiles 2h and 2h+1 in
lock step: each tile's outputs are `chunk_exit`'s, and both get the
pair's common loop count as n_done. `blend_probe_bwd` (`_bwd_kernel_opt`)
walks the chunks [0, n_done) back from the raw log T and returns per-pair
gradients [9, M], summed over the tile's pixels and not folded per
Gaussian. `expand_gather` (`make_expand`) is out[f, i] = table[f, rank[i]]
for a nondecreasing rank given as a window start per 512-lane cell and an
in-window rank.

On a CPU tensor each wrapper takes its plain version; on a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

import torch

from .. import kernels
from .binning import PAYLOAD_ROWS
from .blend import ALPHA_MAX, ALPHA_MIN, LOG_T_EPS, PIX_PER_TILE, _pixel_offsets
from .projection import TILE

# in the order of the kernel's `Mode` enum (csrc/blend_probe.cu)
FWD_MODES = ("floor", "nocarry", "notrans", "noexit", "chunk_exit", "unroll2")
_MODE_ID = {m: i for i, m in enumerate(FWD_MODES)}
_EXITS = ("nocarry", "notrans", "chunk_exit", "unroll2")
MAX_CHUNK = 128  # the kernels stage one chunk per shared-memory buffer
FLOOR_SCALE = 1e-30
# tiles per step of the plain versions: [1024, chunk, 256] panels
PLAIN_TILES = 1024

EXPAND_CELL = 512  # output lanes per block (expand_probe.BC)
EXPAND_WIN = EXPAND_CELL + 128  # table lanes staged per block (expand_probe.WIN)
EXPAND_ROWS = 16


def _check_chunk(chunk: int) -> None:
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in [1, {MAX_CHUNK}], got {chunk}")


def _chunk_geometry(ranges, payload, tiles, c, chunk, grid_w):
    """Chunk c of each of `tiles` [A]: lane index [A, K] into the payload,
    its validity, the payload [9, A, K] (zero past a tile's end) and
    alpha (0 where dead) with the Gaussian, dx and dy, each [A, K, 256]."""
    dev = payload.device
    lane = ranges[tiles, 0].to(torch.int64)[:, None] + c * chunk + torch.arange(chunk, device=dev)
    valid = lane < ranges[tiles, 1].to(torch.int64)[:, None]
    pl = torch.where(valid, payload[:, torch.where(valid, lane, 0)], 0.0)
    mx, my, a, b, cc, op = (pl[i][:, :, None] for i in range(6))
    dxl, dyl = _pixel_offsets(dev)
    tx = ((tiles % grid_w) * TILE).to(torch.float32)[:, None, None]
    ty = ((tiles // grid_w) * TILE).to(torch.float32)[:, None, None]
    dx = mx - (tx + dxl)
    dy = my - (ty + dyl)
    power = -0.5 * (a * dx * dx + cc * dy * dy) - b * dx * dy
    g = torch.exp(power)
    alpha = torch.clamp_max(op * g, ALPHA_MAX)
    live = (power <= 0.0) & (alpha >= ALPHA_MIN) & valid[:, :, None]
    return lane, valid, pl, torch.where(live, alpha, 0.0), g, dx, dy


def _fwd_chunk(mode, pl, valid, alpha, carry):
    """One chunk of one forward mode for A tiles. Returns the additions to
    accum [A,256,3] and log_t_eff, and the new log_t_raw [A,256]."""
    if mode == "floor":
        s = torch.where(valid, pl[0], 0.0).sum(1) * FLOOR_SCALE
        return torch.zeros(carry.shape + (3,), device=carry.device), s[:, None].expand_as(carry), carry
    l1m = -alpha if mode == "notrans" else torch.log1p(-alpha)
    if mode == "nocarry":
        incl = l1m * 0.5
        cc = l1m * 0.25
        t_excl = torch.exp(cc + (incl - l1m))
        applied = (cc + incl) >= LOG_T_EPS
        w = torch.where(applied, alpha * t_excl, 0.0)
        c0 = (w * pl[6][:, :, None]).sum(1)
        add = c0[:, :, None].expand(-1, -1, 3)
        new_raw = carry + l1m.double().sum(1).float()
    else:
        # inclusive and exclusive raw log T of every pair, prefix in float64
        incl = torch.cumsum(l1m.double(), 1)
        excl = (incl - l1m).float()
        applied = (carry[:, None] + incl.float()) >= LOG_T_EPS
        log_excl = carry[:, None] + excl
        t_excl = log_excl if mode == "notrans" else torch.exp(log_excl)
        w = torch.where(applied, alpha * t_excl, 0.0)
        add = torch.stack([(w * pl[ch][:, :, None]).sum(1) for ch in (6, 7, 8)], -1)
        new_raw = carry + incl[:, -1].float()
    eff = torch.where(applied, l1m, 0.0).double().sum(1).float()
    return add, eff, new_raw


def blend_probe_fwd_plain(ranges, payload, grid_w: int, grid_h: int, mode: str, chunk: int = 128):
    """Plain version of `blend_probe_fwd`: the chunks of every tile in
    step, all tiles of a step at once."""
    if mode not in FWD_MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {FWD_MODES}")
    _check_chunk(chunk)
    dev = payload.device
    num_tiles = grid_w * grid_h
    log_raw = torch.zeros((num_tiles, PIX_PER_TILE), device=dev)
    log_eff = torch.zeros((num_tiles, PIX_PER_TILE), device=dev)
    accum = torch.zeros((num_tiles, PIX_PER_TILE, 3), device=dev)
    n_done = torch.zeros((num_tiles,), dtype=torch.int32, device=dev)
    n_chunks = ((ranges[:, 1] - ranges[:, 0]).to(torch.int64) + chunk - 1) // chunk
    step = 2 if mode == "unroll2" else 1
    running = n_chunks > 0
    for c in range(int(n_chunks.max()) if num_tiles else 0):
        if mode in _EXITS and c % step == 0:
            running &= log_raw.amax(1) >= LOG_T_EPS
        running &= c < n_chunks
        tiles = torch.nonzero(running).squeeze(1)
        if tiles.numel() == 0:
            break
        for t in tiles.split(PLAIN_TILES):
            _, valid, pl, alpha, _, _, _ = _chunk_geometry(ranges, payload, t, c, chunk, grid_w)
            add, eff, raw = _fwd_chunk(mode, pl, valid, alpha, log_raw[t])
            accum[t] += add
            log_eff[t] += eff
            log_raw[t] = raw
        n_done[tiles] += 1
    return accum, log_eff, log_raw, n_done


def blend_probe_fwd_pair2_plain(ranges, payload, grid_w: int, grid_h: int, chunk: int = 128):
    """Plain version of `blend_probe_fwd_pair2`: `chunk_exit`, with n_done of
    tiles 2h and 2h+1 the larger of the two (a lone last tile keeps its
    own, its partner being empty)."""
    accum, log_eff, log_raw, n_done = blend_probe_fwd_plain(
        ranges, payload, grid_w, grid_h, "chunk_exit", chunk
    )
    return accum, log_eff, log_raw, pair_n_done(n_done)


def pair_n_done(n_done):
    """n_done of tiles 2h and 2h+1 walked in lock step: the larger of the
    two for both (the partner of an odd last tile is empty)."""
    num_tiles = n_done.shape[0]
    padded = torch.cat([n_done, n_done.new_zeros(num_tiles % 2)])
    pair = torch.maximum(padded[0::2], padded[1::2])
    return pair.repeat_interleave(2)[:num_tiles]


def blend_probe_bwd_plain(
    ranges, payload, n_done, log_t_raw, ct_accum, ct_log_t_eff, grid_w: int, grid_h: int,
    chunk: int = 128, chunk_carry32: bool = False, with_applied: bool = False,
):
    """Plain version of `blend_probe_bwd`: per-pair gradients [9, M] (mean
    x, y; conic a, b, c; opacity; rgb), zero past each tile's n_done chunks.

    The raw log T is carried back in float64, as the kernel does: an opaque
    tile's reaches -300, where a float32 rounding at each chunk boundary
    moves the frontier. `chunk_carry32` carries it as the JAX body does
    instead, rounded to float32 once per chunk (`log_start = log_end -
    chunk total`), to measure that departure. `with_applied` also returns
    the number of pairs applied at each pixel [T, 256] int32; the applied
    pairs of a pixel are a prefix of its live pairs, so two walks apply the
    same pairs where the counts agree."""
    _check_chunk(chunk)
    dev = payload.device
    m = payload.shape[1]
    grads = torch.zeros((PAYLOAD_ROWS, m), device=dev)
    log_end = log_t_raw.double()
    suffix = torch.zeros_like(log_t_raw)
    n_applied = torch.zeros(log_t_raw.shape, dtype=torch.int32, device=dev)
    nd = n_done.to(torch.int64)
    for c in reversed(range(int(nd.max()) if nd.numel() else 0)):
        tiles = torch.nonzero(c < nd).squeeze(1)
        for t in tiles.split(PLAIN_TILES):
            lane, valid, pl, alpha, g, dx, dy = _chunk_geometry(ranges, payload, t, c, chunk, grid_w)
            l1m = torch.log1p(-alpha)
            incl = torch.cumsum(l1m.double(), 1)
            tot = incl[:, -1:]
            # inclusive raw log T of every pair, rebuilt back from log_end
            if chunk_carry32:
                log_start = log_end[t][:, None].float() - tot.float()
                s = log_start + incl.float()
            else:
                s = (log_end[t][:, None] - (tot - incl)).float()
            t_excl = torch.exp(s - l1m)
            applied = (s >= LOG_T_EPS) & (alpha > 0.0)
            w = torch.where(applied, alpha * t_excl, 0.0)
            ct = ct_accum[t][:, None]  # [A, 1, 256, 3]
            col = pl[6:9][..., None]  # [3, A, K, 1]
            dot = col[0] * ct[..., 0] + col[1] * ct[..., 1] + col[2] * ct[..., 2]
            wc = torch.cumsum((w * dot).double(), 1)
            sfx = (suffix[t][:, None].double() + (wc[:, -1:] - wc)).float()
            inv_1m = 1.0 / (1.0 - alpha)
            dl_dalpha = torch.where(
                applied, t_excl * dot - (sfx + ct_log_t_eff[t][:, None]) * inv_1m, 0.0
            )
            a, b, cc, op = (pl[i][:, :, None] for i in range(2, 6))
            dl_dg = op * dl_dalpha
            gdx = g * dx
            gdy = g * dy
            pair = torch.stack([
                (dl_dg * (-gdx * a - gdy * b)).sum(2),
                (dl_dg * (-gdy * cc - gdx * b)).sum(2),
                (dl_dg * (-0.5 * g * dx * dx)).sum(2),
                (dl_dg * (-g * dx * dy)).sum(2),
                (dl_dg * (-0.5 * g * dy * dy)).sum(2),
                (g * dl_dalpha).sum(2),
                (w * ct[..., 0]).sum(2),
                (w * ct[..., 1]).sum(2),
                (w * ct[..., 2]).sum(2),
            ])  # [9, A, K]
            grads[:, lane[valid]] = pair[:, valid]
            suffix[t] = (suffix[t].double() + wc[:, -1]).float()
            if chunk_carry32:
                log_end[t] = log_start[:, 0].double()
            else:
                log_end[t] = log_end[t] - tot[:, 0]
            if with_applied:
                n_applied[t] += applied.sum(1, dtype=torch.int32)
    return (grads, n_applied) if with_applied else grads


def _probe_outputs(num_tiles, dev):
    return (
        torch.empty((num_tiles, PIX_PER_TILE, 3), dtype=torch.float32, device=dev),
        torch.empty((num_tiles, PIX_PER_TILE), dtype=torch.float32, device=dev),
        torch.empty((num_tiles, PIX_PER_TILE), dtype=torch.float32, device=dev),
        torch.empty((num_tiles,), dtype=torch.int32, device=dev),
    )


def _check_pairs(ranges, payload, num_tiles):
    dev = ranges.device
    kernels.check("ranges", ranges, torch.int32, (num_tiles, 2), dev)
    kernels.check("payload", payload, torch.float32, (PAYLOAD_ROWS, -1), dev)


def blend_probe_fwd(ranges, payload, grid_w: int, grid_h: int, mode: str, chunk: int = 128):
    """Forward probe `mode` over ranges [T, 2] ([start, end) per tile) and
    payload [9, M]: (accum [T,256,3], log_t_eff [T,256], log_t_raw [T,256],
    n_done [T] int32). Replaces `run_fwd_variant` of
    benchmarks/kernel_probe.py."""
    if mode not in FWD_MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {FWD_MODES}")
    _check_chunk(chunk)
    if kernels.runs_plain(ranges):
        return blend_probe_fwd_plain(ranges, payload, grid_w, grid_h, mode, chunk)
    kernels.library()  # builds on first use; raises where it cannot
    num_tiles = grid_w * grid_h
    _check_pairs(ranges, payload, num_tiles)
    out = _probe_outputs(num_tiles, ranges.device)
    kernels.LAUNCHES["blend_probe_fwd"] += 1
    kernels.launch(
        "gsdf_blend_probe_fwd", ranges.data_ptr(), payload.data_ptr(), payload.shape[1],
        num_tiles, grid_w, chunk, _MODE_ID[mode], *(t.data_ptr() for t in out),
    )
    return out


def blend_probe_fwd_pair2(ranges, payload, grid_w: int, grid_h: int, chunk: int = 128):
    """Two tiles in lock step per block: `chunk_exit`'s outputs, with the
    pair's common loop count as n_done. Replaces `run_fwd_pair2` of
    benchmarks/kernel_probe.py."""
    _check_chunk(chunk)
    if kernels.runs_plain(ranges):
        return blend_probe_fwd_pair2_plain(ranges, payload, grid_w, grid_h, chunk)
    kernels.library()  # builds on first use; raises where it cannot
    num_tiles = grid_w * grid_h
    _check_pairs(ranges, payload, num_tiles)
    out = _probe_outputs(num_tiles, ranges.device)
    kernels.LAUNCHES["blend_probe_fwd_pair2"] += 1
    kernels.launch(
        "gsdf_blend_probe_fwd_pair2", ranges.data_ptr(), payload.data_ptr(), payload.shape[1],
        num_tiles, grid_w, chunk, *(t.data_ptr() for t in out),
    )
    return out


def blend_probe_bwd(
    ranges, payload, n_done, log_t_raw, ct_accum, ct_log_t_eff, grid_w: int, grid_h: int,
    chunk: int = 128,
):
    """Backward probe: per-pair gradients [9, M] from `chunk_exit`'s n_done
    and log_t_raw, without the fold. Replaces `run_bwd_variant` of
    benchmarks/kernel_probe.py (body `_bwd_kernel_opt`)."""
    _check_chunk(chunk)
    if kernels.runs_plain(ranges):
        return blend_probe_bwd_plain(
            ranges, payload, n_done, log_t_raw, ct_accum, ct_log_t_eff, grid_w, grid_h, chunk
        )
    kernels.library()  # builds on first use; raises where it cannot
    dev = ranges.device
    num_tiles = grid_w * grid_h
    _check_pairs(ranges, payload, num_tiles)
    kernels.check("n_done", n_done, torch.int32, (num_tiles,), dev)
    kernels.check("log_t_raw", log_t_raw, torch.float32, (num_tiles, PIX_PER_TILE), dev)
    kernels.check("ct_accum", ct_accum, torch.float32, (num_tiles, PIX_PER_TILE, 3), dev)
    kernels.check("ct_log_t_eff", ct_log_t_eff, torch.float32, (num_tiles, PIX_PER_TILE), dev)
    grads = torch.zeros_like(payload)
    kernels.LAUNCHES["blend_probe_bwd"] += 1
    kernels.launch(
        "gsdf_blend_probe_bwd", ranges.data_ptr(), payload.data_ptr(), payload.shape[1],
        num_tiles, grid_w, chunk, n_done.data_ptr(), log_t_raw.data_ptr(), ct_accum.data_ptr(),
        ct_log_t_eff.data_ptr(), grads.data_ptr(),
    )
    return grads


def expand_gather_plain(table, g0, lr):
    """Plain version of `expand_gather`: table[:, rank], with rank = 128 g0
    of the lane's cell + lr."""
    rank = g0.to(torch.int64).repeat_interleave(EXPAND_CELL) * 128 + lr.to(torch.int64)
    return table[:, rank]


def expand_gather(table, g0, lr):
    """out [16, MP] = table[:, rank] for table [16, lanes] float32 (any bit
    patterns), g0 [MP / 512] int32 and lr [MP] int32 in [0, 640): the
    512-lane cell i reads the table window [128 g0[i], 128 g0[i] + 640).
    The kernel writes all-ones bits (a NaN) where lr is outside the window.
    Replaces `make_expand` of benchmarks/expand_probe.py."""
    if kernels.runs_plain(table):
        return expand_gather_plain(table, g0, lr)
    kernels.library()  # builds on first use; raises where it cannot
    dev = table.device
    mp = lr.shape[0]
    if mp % EXPAND_CELL:
        raise ValueError(f"lr: length must be a multiple of {EXPAND_CELL}, got {mp}")
    kernels.check("table", table, torch.float32, (EXPAND_ROWS, -1), dev)
    kernels.check("g0", g0, torch.int32, (mp // EXPAND_CELL,), dev)
    kernels.check("lr", lr, torch.int32, (mp,), dev)
    out = torch.empty((EXPAND_ROWS, mp), dtype=torch.float32, device=dev)
    kernels.LAUNCHES["expand_gather"] += 1
    kernels.launch(
        "gsdf_expand_gather", table.data_ptr(), table.shape[1], g0.data_ptr(), lr.data_ptr(),
        mp, out.data_ptr(),
    )
    return out
