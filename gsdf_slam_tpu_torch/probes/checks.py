"""The probe kernels, and the bucket checkpoints of K1 and K4, against
their plain versions: the bars and the comparisons (and the count of
checkpoint words K1 writes, and the keep bytes K4 writes), shared by
chip_smoke.py and tests/test_torch_cuda.py so that each bar is defined
once.

Bars, with their reasons:

- accum and T = exp(log T), effective and raw, within FWD_SMALL on the
  small scenes (the image bar of tests/test_pallas_blend.py); accum is held
  to the bar times max(1, its largest value), since the `nocarry` stand-in
  sums every pair to ~20, not an image. At the headline the caller gives
  K1's bar;
- n_done exact on the small scenes; at the headline its mismatches are
  counted;
- `floor` holds no image: its log_t_eff is 1e-30 x a sum of mean x, so
  exp() of it is 1 whatever the sum. Its log_t_eff / FLOOR_SCALE is held
  within FLOOR_RTOL of the plain version's, relative to the tile's sum of
  |mean x| (the sum's own size where no term cancels): float32 sums of up
  to 128 terms in another order. accum and log_t_raw are exactly 0;
- gradients within BWD_SMALL scaled per field (the gradient bar of
  tests/test_pallas_blend.py); two launches of the backward bit-equal;
- the kernels that copy 32-bit words or add integers (`expand_gather` and
  the pair-table kernels) bit-equal.

At the headline a pair within rounding of the T = 1e-4 frontier may apply
on one side only (the kernels sum log T pair by pair, the plain versions by
chunks). That moves log T_eff by at least log1p(-1/255) and, for `notrans`,
accum by up to 0.99 |log 1e-4| x colour. Such pixels (|d log T_eff| >
FLIP_LOG_T) are counted, at most MAX_FLIPS (K1 and its plain version
differ on 8 of 825,600), and accum is held on the others.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..ops.blend import checkpoint_slots, checkpoints_read, keep_log_exit
from ..ops.blend_probe import FLOOR_SCALE, pair_n_done

FWD_SMALL = 5e-6
BWD_SMALL = 2e-5
FLOOR_RTOL = 1e-5
FLIP_LOG_T = 1e-3
MAX_FLIPS = 80
FIELDS = {"means2d": slice(0, 2), "conics": slice(2, 5), "opacity": slice(5, 6), "colors": slice(6, 9)}


def bit_equal(got, want) -> bool:
    """Same shape and the same 32-bit words (NaN bits included)."""
    return got.shape == want.shape and torch.equal(got.view(torch.int32), want.view(torch.int32))


def _floor_rel_err(got_teff, want_teff, payload, ranges) -> float:
    """max over pixels of |d log_t_eff| / FLOOR_SCALE over the tile's sum
    of |mean x| (0 where both are 0)."""
    cs = torch.cat([payload.new_zeros(1, dtype=torch.float64), torch.cumsum(payload[0].abs().double(), 0)])
    abs_sum = cs[ranges[:, 1].long()] - cs[ranges[:, 0].long()]
    d = (got_teff.double() - want_teff.double()).abs() / FLOOR_SCALE
    # a NaN stays NaN and fails the bar
    return float(torch.where(d == 0, 0.0, d / abs_sum.clamp_min(1e-300)[:, None]).max())


def fwd_check(name, got, want, payload, ranges, bound, headline=False):
    """A forward probe's (accum, log_t_eff, log_t_raw, n_done) `got` against
    its plain version's `want` on the binning (ranges, payload). `name` is
    the mode, or `pair2`. Returns (errors, failed check names)."""
    acc, teff, traw, nd = got
    w_acc, w_teff, w_traw, w_nd = want
    scale = max(1.0, float(w_acc.abs().max())) if w_acc.numel() else 1.0
    if headline:
        flip = (teff - w_teff).abs() > FLIP_LOG_T
    else:
        flip = torch.zeros_like(teff, dtype=torch.bool)
    d_acc = torch.where(flip[..., None], 0.0, (acc - w_acc).abs())
    errs = dict(
        accum=float(d_acc.max()) / scale,
        t_eff=float((teff.exp() - w_teff.exp()).abs().max()),
        t_raw=float((traw.exp() - w_traw.exp()).abs().max()),
        n_done=int((nd != w_nd).sum()),
        flips=int(flip.sum()),
    )
    failed = []
    if not all(errs[k] <= bound for k in ("accum", "t_eff", "t_raw")):  # False on NaN
        failed.append(name)
    if errs["flips"] > MAX_FLIPS:
        failed.append(f"{name}-flips")
    if errs["n_done"] and not headline:
        failed.append(f"{name}-n_done")
    if name == "floor":
        errs["floor_sum"] = _floor_rel_err(teff, w_teff, payload, ranges)
        if not errs["floor_sum"] <= FLOOR_RTOL:
            failed.append("floor-sum")
        if bool(acc.ne(0).any()) or bool(traw.ne(0).any()):
            failed.append("floor-zeros")
    return errs, failed


def pair2_check(got, want, single, payload, ranges, bound, headline=False):
    """pair2's outputs against its plain version, and against the
    `chunk_exit` kernel's `single`: accum and log T bit-equal, n_done the
    pair's larger. Returns (errors, failed check names)."""
    errs, failed = fwd_check("pair2", got, want, payload, ranges, bound, headline)
    as_single = all(torch.equal(a, b) for a, b in zip(got[:3], single[:3]))
    errs["as_chunk_exit"] = as_single and torch.equal(got[3], pair_n_done(single[3]))
    if not errs["as_chunk_exit"]:
        failed.append("pair2-not-chunk_exit")
    return errs, failed


def scaled_errors(got, want) -> dict:
    """Per field of [9, M] gradients: max |got - want| over max |want|."""
    return {k: float((got[sl] - want[sl]).abs().max()) / max(float(want[sl].abs().max()), 1e-12)
            for k, sl in FIELDS.items()}


def bwd_check(got, again, want, bound):
    """The backward's per-pair gradients `got` (and a second launch's
    `again`) against the plain version's `want`. Returns (errors, failed
    check names)."""
    errs = scaled_errors(got, want)
    failed = [] if all(e <= bound for e in errs.values()) else ["bwd"]
    errs["max_abs"] = float((got - want).abs().max()) if got.numel() else 0.0
    errs["deterministic"] = torch.equal(got, again)
    if not errs["deterministic"]:
        failed.append("bwd-not-deterministic")
    return errs, failed


def checkpoint_check(got, want, ranges, nc_got, nc_want):
    """K1's or K4's bucket checkpoints `got` against `want` (the plain
    version's, or K1's), on the words that K2 reads under both n_contrib.
    Returns (largest |d colour sum|, largest |d T| with T = exp(log T),
    whether those words are bit-equal, words compared). The colour sums and
    T are K1's accum and final T at a shorter render, so they take K1's
    bars."""
    rows, read = checkpoints_read(ranges, torch.minimum(nc_got, nc_want))
    g, w = got[rows][read], want[rows][read]
    if not g.numel():
        return 0.0, 0.0, True, 0
    return (float((g[:, 1:] - w[:, 1:]).abs().max()), float((g[:, 0].exp() - w[:, 0].exp()).abs().max()),
            bit_equal(g, w), int(read.sum()))


def checkpoint_words_written(ranges, payload, grid_w, shape) -> int:
    """K1 launched into a NaN-filled checkpoint buffer of `shape`: the words
    it wrote (a written word holds a finite log T), to hold against the
    words K2 reads. The launch is made outside the wrapper, so it is not
    counted."""
    num_tiles, dev = ranges.shape[0], ranges.device
    ckpt = torch.full(shape, float("nan"), device=dev)
    outs = (torch.empty((num_tiles, 256, 3), device=dev), torch.empty((num_tiles, 256), device=dev),
            torch.empty((num_tiles, 256), dtype=torch.int32, device=dev))
    kernels.launch("gsdf_blend_fwd", ranges.data_ptr(), payload.data_ptr(), payload.shape[1], num_tiles, grid_w,
                   *(o.data_ptr() for o in outs), ckpt.data_ptr())
    return int(torch.isfinite(ckpt[..., 0]).sum())


def keep_bytes(ranges, payload, grid_w, margin) -> torch.Tensor:
    """K4 launched into a keep buffer of 2s: the bytes it left, uint8 [M],
    to hold against the plain keep flags (a byte K4 did not write stays
    2). The launch is made outside the wrapper, so it is not counted."""
    num_tiles, dev, m = ranges.shape[0], ranges.device, payload.shape[1]
    keep = torch.full((m,), 2, dtype=torch.uint8, device=dev)
    outs = (torch.empty((num_tiles, 256, 3), device=dev), torch.empty((num_tiles, 256), device=dev),
            torch.empty((num_tiles, 256), dtype=torch.int32, device=dev),
            torch.empty((checkpoint_slots(num_tiles, m), 256, 4), device=dev))
    kernels.launch("gsdf_blend_fwd_export", ranges.data_ptr(), payload.data_ptr(), m, num_tiles, grid_w,
                   keep_log_exit(margin), *(o.data_ptr() for o in outs), keep.data_ptr())
    return keep


def log1p_live_mismatches() -> int:
    """The float32 alphas in [1/255, 0.99], every one, at which the
    live-range log1p of K4 and the probe kernels (csrc/common.cuh) differs
    in any bit from the CUDA math library's log1pf(-alpha), which K1 and
    blend_probe_fwd call: 0 keeps K4 bit-equal to K1, and pair2 to
    chunk_exit. Needs the card."""
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    kernels.launch("gsdf_log1p_live_mismatches", out.data_ptr())
    return int(out.item())
