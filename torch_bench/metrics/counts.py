"""The benchmark's own arithmetic of peaks, bounds and operation counts.

Copies of `gsdf_slam_tpu_torch/probes/timing.py::bound_ms` and of the blend
kernels' per-pixel-pair counts in `chip_smoke.py` (FWD_WALK_OPS, FWD_OPS,
EXPORT_LIVE_OPS, BWD_OPS), kept here so that a change to the program's
probes does not move the yardstick, and the counts of a whole step written
out from its shapes. Every count is of the work the step needs on its own
inputs, whatever implements it, and is a lower bound: so a share of a peak
or of a bound computed from it is at most the true share.
"""

from __future__ import annotations

# NVIDIA H100 SXM, published dense peaks at the full 700 W limit (NVIDIA's
# data sheet): device memory bytes/s, float32 operations/s outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# Blend kernels, operations per pixel-pair (each special function counted
# as one float32 operation). Forward: on each pixel-pair up to the pixel's
# last applied pair, the two offsets, the nine of the exponent and the live
# test (FWD_WALK_OPS); on each live one also its exp, the opacity product
# and the clamp (FWD_OPS in all). K4 walks on past the frontier to its
# relaxed exit, with EXPORT_LIVE_OPS on each live pixel-pair it walks.
# Backward: the forward's, then on each applied pixel-pair the log1p and
# exp of T and the 40 of dL/dalpha and the nine per-pair gradients.
FWD_WALK_OPS = 12
FWD_OPS = 15
EXPORT_LIVE_OPS = 4
BWD_OPS = 57
# words (16 bytes: log T and the three colour sums) of one bucket checkpoint
BUCKET = 32
# payload floats of a sorted pair: mean x, y, conic a, b, c, opacity, rgb
PAYLOAD_FLOATS = 9

# Per Gaussian and step, float32 operations, from the formulas of the
# step (a lower count: each special function is one operation, and the
# autograd backward of the preprocess is counted once as many as the
# forward, though it is more):
#   activations (exp of 3 scales, quaternion normalise, sigmoid)      ~20
#   covariance R S S^T R^T                                              ~75
#   view transform, projection, NDC to pixels                           ~40
#   EWA Jacobian, 2D covariance, low-pass, determinant, conic, radius   ~85
#   SH degree 3 (direction 9, basis 35, 16 coefficients x 3 x 2, +0.5)  ~140
PREPROCESS_OPS = 360
# backward of the above through autograd, at least as many
PREPROCESS_BWD_OPS = 360
# Adam on the 59 floats of a Gaussian: two moments (3 + 4), the square
# root, the bias corrections, the quotient and the update (5)
ADAM_OPS = 59 * 12
PER_GAUSSIAN_OPS = PREPROCESS_OPS + PREPROCESS_BWD_OPS + ADAM_OPS
# Per pixel and step: L1 (difference, abs, sum: 3 a channel); SSIM's five
# filtered maps of three channels, each an 11-tap separable filter (2 x 11
# products and sums) and its products, and the map's formula (~20 a
# channel); the backward of both at least as many
L1_OPS = 3 * 3
SSIM_OPS = 3 * (5 * 2 * 2 * 11 + 3 + 20)
PER_PIXEL_OPS = 2 * (L1_OPS + SSIM_OPS)


def bound_s(bytes_moved: float, ops: float) -> float:
    """The least time the card could take for work that moves
    `bytes_moved` bytes (each input read once, each output written once)
    and does `ops` float32 operations, in seconds."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def fwd_bytes(num_tiles: int, pairs: int, words: int, export: bool) -> int:
    """K1 (K4 with `export`): ranges, the sorted payload, accum, log T and
    n_contrib of each pixel, the checkpoint words K2 reads; K4 also its
    keep byte a pair."""
    pix = 256 * num_tiles
    return 8 * num_tiles + 4 * PAYLOAD_FLOATS * pairs + 20 * pix + 16 * words + (pairs if export else 0)


def bwd_bytes(num_tiles: int, pairs_read: int, words: int, gaussians: int) -> int:
    """K2: ranges, the live buckets' payload and Gaussian ids, accum,
    n_contrib, both cotangents, the checkpoints it reads; the 9 gradients
    of each Gaussian."""
    pix = 256 * num_tiles
    return 8 * num_tiles + 4 * (PAYLOAD_FLOATS + 1) * pairs_read + 32 * pix + 16 * words + 36 * gaussians


def steps_ops(gaussian_steps: int, pixel_steps: int, walked_fwd: int, walked_bwd: int) -> int:
    """Float32 operations a run of steps needs at least: the per-Gaussian
    work over `gaussian_steps` (the sum of the Gaussians of each step), the
    per-pixel work over `pixel_steps`, and the blend's walk over the pixel-
    pairs up to each pixel's last applied pair in the forward and the
    backward launches."""
    return (PER_GAUSSIAN_OPS * gaussian_steps + PER_PIXEL_OPS * pixel_steps
            + FWD_WALK_OPS * (walked_fwd + walked_bwd))


def share(numerator_s: float, denominator_s: float) -> float | None:
    """100 * numerator / denominator; None where there is nothing to read.
    Raises over 100%: a share of a bound or a peak above it means the work
    is counted too high or the time leaves part of the work out."""
    if not denominator_s or denominator_s <= 0 or numerator_s <= 0:
        return None
    pct = 100.0 * numerator_s / denominator_s
    if pct > 100.0:
        raise ValueError(f"a share of {pct:.4f}% of a bound or a peak: the count or the time is wrong")
    return pct
