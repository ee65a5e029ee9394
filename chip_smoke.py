#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gsdf_slam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device: nvidia-smi's name and power limit, torch and CUDA versions;
2. build: compile the CUDA kernels from gsdf_slam_tpu_torch/csrc/, with
   the registers and spills of K1, K4, the blend probes (the six modes of
   blend_probe_fwd, one template on one skeleton; pair2; the backward) and
   the single-pass xpose_cumsum, and the live-range log1p of K4 and the
   probes against log1pf on every float32 alpha in [1/255, 0.99];
3. kernel checks: each kernel (K3 tile_ranges_pack, K1 blend_fwd, K2
   blend_bwd, K4 blend_fwd_export) against its plain PyTorch version on the
   card, on the small test scene (64x64), the opaque wall (32x32) and the
   headline scene (1200x680, 400k Gaussians): K1's and K4's bucket
   checkpoints against the plain ones where K2 reads them, K4 bit-equal to
   K1 and its keep flags against the plain ones, every keep byte written by
   K4; the cached blend through
   K4's pruned cache against the fresh blend at export parameters; that K1
   writes exactly the checkpoint words K2 reads; K2's live buckets, the
   checkpoint words and buffer, and K2's atomics per step, counted from
   the inputs; then three fresh training
   steps, and the cadence of one export and seven cached steps, on the card
   against the same steps on the CPU;
4. main path, fresh binning: `train_step` at the headline size, 3 warm-up
   and 10 timed steps, with every kernel's launch count taken over exactly
   these steps; then 3 steps under torch.profiler for the device's busy
   and idle share and the kernels that take the device time;
4b. main path, the cached-binning cadence: from one state, 8 fresh steps
   and the cadence (one export step, then 7 cached steps) in turns, twice,
   timed on CUDA events, with the launch counts of each cadence; one fresh,
   one export and one cached step under torch.profiler, and each under
   torch.cuda.set_sync_debug_mode("warn") to count host syncs;
5. kernel times: each kernel and its plain version at the headline shapes,
   K4's walk to its relaxed exit counted beside K1's, and K4/K1 in turns;
6. probes: each probe kernel (blend_probe_fwd in its six modes,
   blend_probe_fwd_pair2, blend_probe_bwd, expand_gather) against its plain
   version on the 64x64 scene and on the opaque wall (32x32, where the
   chunk exit fires) at chunks of 128 and 16, and on the headline; then the
   probe path through its entry points, `probes.kernel_probe.main` and
   `probes.expand_probe.main`, with the launch counts taken over exactly
   that run; then each probe kernel's time beside its plain version's and
   its bound, counted on the work its function needs (`[bound]`: the
   pixel-pairs chunk_exit's walk covers, the live and the applied ones);
7. pair table: each kernel of ops/pair_table.py (realign_copy,
   window_gather_rows, window_gather_cols, xpose_cumsum) bit-equal to its
   plain version on benchmarks/microbench.py's inputs at a tiny size, at
   the microbench's default (P 262,144, MP 393,216) and at the headline
   (P 400,000, MP 1,048,576); then the microbench through its entry point,
   `probes.microbench.main`, with the launch counts taken over exactly that
   run; then each kernel's time at the headline.

Each kernel is timed replayed from a CUDA graph (the device's time) beside
its bound (the least time the card could take, from the bytes it must move,
the float32 operations and, for the blend kernels, the special functions it
must do on this run's inputs), its plain version and,
where one PyTorch call computes the same function, that call. The
next-to-last line is a JSON object with one entry per kernel; the last
is {"ok": true, "device": {...}}, printed only when every phase passed.
The script exits non-zero, printing no result, without a CUDA device or
when the package is not beside it (the script copied out of the repo).
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

import numpy as np

WARMUP, TIMED = 3, 10

# Bounds, each with its reason (PERF.md "Kernel checks").
# K3 moves integers and copies floats: bit-equal.
# K1 small: the images bar of tests/test_pallas_blend.py. The checkpoints of
# K1 and K4 take K1's bars: a checkpoint is the accum and final T of the
# render cut at its bucket's start.
K1_SMALL = 5e-6
# K1 headline: the kernel sums log T sequentially, the plain version by
# chunks, so a pair whose inclusive T lies within rounding of 1e-4 may apply
# on one side only; that moves its pixel by at most 1e-4 x (colour + T).
K1_HEADLINE = 2e-4
# K2 small: the gradient bar of tests/test_pallas_blend.py (scaled per field).
K2_SMALL = 2e-5
# K2 headline: atomics and index_add sum ~1M pair terms in different orders;
# the JAX fold is itself good to ~3e-4 at this size
# (pallas_blend_grouped.py:611-614).
K2_HEADLINE = 3e-4

KERNELS = {
    "tile_ranges_pack": dict(
        source="gsdf_slam_tpu_torch/csrc/tile_ranges_pack.cu",
        replaces="gsdf_slam_tpu/ops/pallas_binning.py:89",
    ),
    "blend_fwd": dict(
        source="gsdf_slam_tpu_torch/csrc/blend_fwd.cu",
        replaces="gsdf_slam_tpu/ops/pallas_blend_grouped.py:89",
    ),
    "blend_bwd": dict(
        source="gsdf_slam_tpu_torch/csrc/blend_bwd.cu",
        replaces="gsdf_slam_tpu/ops/pallas_blend_grouped.py:276",
    ),
    "blend_fwd_export": dict(
        source="gsdf_slam_tpu_torch/csrc/blend_fwd_export.cu",
        replaces="gsdf_slam_tpu/ops/pallas_blend_grouped.py:89 (keep_margin)",
    ),
    # phase 6, the probe path: each replaces the JAX probe's pallas_call
    "blend_probe_fwd": dict(
        source="gsdf_slam_tpu_torch/csrc/blend_probe.cu",
        replaces="benchmarks/kernel_probe.py:738",
    ),
    "blend_probe_fwd_pair2": dict(
        source="gsdf_slam_tpu_torch/csrc/blend_probe_pair2.cu",
        replaces="benchmarks/kernel_probe.py:995",
    ),
    "blend_probe_bwd": dict(
        source="gsdf_slam_tpu_torch/csrc/blend_probe_bwd.cu",
        replaces="benchmarks/kernel_probe.py:567",
    ),
    "expand_gather": dict(
        source="gsdf_slam_tpu_torch/csrc/expand_gather.cu",
        replaces="benchmarks/expand_probe.py:102",
    ),
    # phase 7, the pair table: each replaces a microbench pallas_call
    "realign_copy": dict(
        source="gsdf_slam_tpu_torch/csrc/pair_table.cu",
        replaces="benchmarks/microbench.py:282",
    ),
    "window_gather_rows": dict(
        source="gsdf_slam_tpu_torch/csrc/pair_table.cu",
        replaces="benchmarks/microbench.py:345",
    ),
    "window_gather_cols": dict(
        source="gsdf_slam_tpu_torch/csrc/pair_table.cu",
        replaces="benchmarks/microbench.py:399",
    ),
    "xpose_cumsum": dict(
        source="gsdf_slam_tpu_torch/csrc/pair_table.cu",
        replaces="benchmarks/microbench.py:804",
    ),
}
PROBES = ("blend_probe_fwd", "blend_probe_fwd_pair2", "blend_probe_bwd", "expand_gather")
PAIR_TABLE = ("realign_copy", "window_gather_rows", "window_gather_cols", "xpose_cumsum")
# chunk sizes of the probe checks on the small scenes: at 16 pairs a tile
# spans several chunks, so multi-chunk walks and the lock step are exercised
PROBE_CHUNKS = (128, 16)
# the expansion probe's larger target, ~1M pair lanes as at the headline
EXPAND_MP = 1_048_576
# (P, MP) of the pair-table checks: tiny, the microbench's default, and the
# headline's Gaussians at its pair capacity
PAIR_TABLE_SIZES = {"tiny": (2048, 8192), "default": (262_144, 393_216), "headline": (400_000, EXPAND_MP)}
# Operations per pixel-pair in the float32 term of the blend kernels' bounds,
# each special function counted as one float32 operation, so the term is a
# lower bound; the blend kernels' special functions also have a term of
# their own, on the SFUs' rate (phase 5). Forward: on each pixel-pair up to
# the pixel's last applied pair, the two offsets, the nine of the exponent
# and the live test (FWD_WALK_OPS); on each live one also its exp, the
# opacity product and the clamp (FWD_OPS in all).
FWD_WALK_OPS = 12
FWD_OPS = 15
# K4 walks each pixel on to its relaxed exit (ops/blend.py::
# export_walk_counts): FWD_WALK_OPS on every walked pixel-pair; on each live
# one the exponent's expf, the opacity product, the clamp and log1pf
# (EXPORT_LIVE_OPS); expf of log T on the applied ones.
EXPORT_LIVE_OPS = 4
# Backward: the forward's, then on each applied pixel-pair the log1p and exp
# of T and the 40 of dL/dalpha and the nine per-pair gradients (BWD_OPS in
# all).
BWD_OPS = 57
# The probe backward takes log1p on every live pixel-pair of its walk
# (EXPORT_LIVE_OPS), so on each applied one it adds the exp of T and the 40
# of dL/dalpha and the nine gradients.
PROBE_BWD_APPLIED_OPS = BWD_OPS - FWD_OPS - 1
# RasterizeConfig's default cache_prune_margin, the mapper's setting
MARGIN = 10.0
# the cadence after densify_until_iter (engine/settings.py:97): one export
# step, then rebin_interval_after_densify - 1 cached steps
CACHED_STEPS = 7


def log(msg: str) -> None:
    print(msg, flush=True)


def small_scene(torch, device, p=96, seed=1):
    """tests/test_render.py::make_scene's recipe (64x64), live Gaussians only."""
    from gsdf_slam_tpu_torch.ops import CameraMatrices

    rng = np.random.default_rng(seed)
    means = np.stack(
        [rng.uniform(-2, 2, p), rng.uniform(-2, 2, p), rng.uniform(2.0, 6.0, p)], axis=-1
    ).astype(np.float32)
    means[0, 2] = -1.0
    means[1, 2] = 0.1
    scales = np.exp(rng.uniform(-2.5, -0.5, (p, 3))).astype(np.float32)
    quats = rng.normal(size=(p, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rng.uniform(0.2, 0.95, p).astype(np.float32)
    dc = rng.uniform(-1.0, 1.0, (p, 1, 3)).astype(np.float32)
    sh_rest = (0.1 * rng.normal(size=(p, 15, 3))).astype(np.float32)
    live = slice(0, p - 3)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a[live])).to(device)
    cam = CameraMatrices.from_pose(np.array([1.0, 0, 0, 0]), np.zeros(3), np.pi / 2, np.pi / 2, device=device)
    return (t(means), t(scales), t(quats), t(opac), t(dc), t(sh_rest)), cam


def stage_inputs(torch, args, cam, width, height):
    """Everything the three kernels take for one view, built with plain ops."""
    from gsdf_slam_tpu_torch.ops import binning, preprocess, tile_grid

    gw, gh = tile_grid(width, height)
    with torch.no_grad():
        pre = preprocess(*args, cam, width=width, height=height, sh_degree=3)
        keys, order, pair_gid, total = binning.expand_and_sort(
            pre.depths, pre.rect_min, pre.rect_max, pre.tiles_touched,
            pre.means2d, pre.conics, args[3], grid_w=gw,
        )
        table = binning.payload_table(pre.means2d, pre.conics, args[3], pre.colors)
    return dict(keys=keys, order=order, pair_gid=pair_gid, table=table, total=total,
                gw=gw, gh=gh, p=args[0].shape[0], width=width, height=height)


def cotangents(torch, st, accum, log_t_eff, rng_seed=1):
    """dL/d(accum, log_t_eff) of the mapper loss against a random target,
    composited over a white background (`white_background`), so that the
    cotangent of log T_eff is not zero. Seeded noise at the RMS of the
    colour cotangent is added to it: where T_eff is near 0 the composite
    alone leaves K2's `ct_eff` term too small to see, and a larger noise
    would hide the colour term instead (the loss is a mean over pixels)."""
    from gsdf_slam_tpu_torch.ops.blend import assemble_image
    from gsdf_slam_tpu_torch.ops.losses import mapper_loss

    gen = torch.Generator(device=accum.device).manual_seed(rng_seed)
    gt = torch.rand((st["height"], st["width"], 3), generator=gen, device=accum.device)
    acc = accum.clone().requires_grad_(True)
    lte = log_t_eff.clone().requires_grad_(True)
    bg = torch.ones(3, device=accum.device)
    img, _ = assemble_image(acc, lte, bg, grid_w=st["gw"], grid_h=st["gh"],
                            width=st["width"], height=st["height"])
    ct_a, ct_t = torch.autograd.grad(mapper_loss(img, gt, None, 0.2), (acc, lte))
    rms = float(ct_a.pow(2).mean().sqrt())
    ct_t = ct_t + rms * torch.randn(ct_t.shape, generator=gen, device=ct_t.device)
    return ct_a.contiguous(), ct_t.contiguous()


def check_kernels(torch, name, st, k1_bound, k2_bound, headline=False):
    """Each kernel against its plain version on the same inputs, K1's and
    K4's bucket checkpoints included; K4 against K1; the cached blend
    through K4's pruned cache against the fresh blend at export parameters.
    Returns the max errors, the failed checks and what the inputs make the
    blend kernels do (ops/blend.py::blend_bwd_plain's counts and the
    checkpoint words and buffer)."""
    from gsdf_slam_tpu_torch.ops import binning, blend, tile_blend
    from gsdf_slam_tpu_torch.probes import checks

    num_tiles = st["gw"] * st["gh"]
    args3 = (st["keys"], st["order"], st["pair_gid"], st["table"], num_tiles)
    r_k, g_k, p_k = binning.tile_ranges_pack(*args3)
    r_p, g_p, p_p = binning.tile_ranges_pack_plain(*args3)
    torch.cuda.synchronize()
    k3_ok = torch.equal(r_k, r_p) and torch.equal(g_k, g_p) and torch.equal(p_k, p_p)
    k3_err = float((p_k - p_p).abs().max()) if p_k.numel() else 0.0
    log(f"[check {name}] pairs={p_k.shape[1]} (pre-cull {st['total']}) "
        f"K3 ranges/gid/payload bit-equal={k3_ok} max_abs_err={k3_err:.3g}")

    acc_k, lte_k, nc_k, ck_k = tile_blend.blend_fwd(r_k, p_k, st["gw"], st["gh"])
    # the plain version with a margin is also K4's: its first four outputs
    # are the plain K1's
    acc_p, lte_p, nc_p, ck_p, keep_p = blend.blend_fwd_plain(r_k, p_k, st["gw"], st["gh"], keep_margin=MARGIN)
    torch.cuda.synchronize()

    def fwd_err(acc, lte):
        return max(float((acc - acc_p).abs().max()), float((torch.exp(lte) - torch.exp(lte_p)).abs().max()))

    acc_err = float((acc_k - acc_p).abs().max())
    t_err = float((torch.exp(lte_k) - torch.exp(lte_p)).abs().max())
    lte_err = float((lte_k - lte_p).abs().max())
    over = int(((acc_k - acc_p).abs().amax(-1) > K1_SMALL).sum())
    nc_diff = int((nc_k != nc_p).sum())
    k1_err = max(acc_err, t_err)
    log(f"[check {name}] K1 accum max_abs_err={acc_err:.3g} final_T max_abs_err={t_err:.3g} "
        f"log_t_eff max_abs_err={lte_err:.3g} pixels>{K1_SMALL:g}={over} "
        f"n_contrib mismatches={nc_diff} bound={k1_bound:g}")
    ck1_c, ck1_t, _, compared = checks.checkpoint_check(ck_k, ck_p, r_k, nc_k, nc_p)
    log(f"[check {name}] K1 checkpoints against the plain version's on the {compared} words K2 reads after both: "
        f"colour sums max_abs_err={ck1_c:.3g} T max_abs_err={ck1_t:.3g} bound={k1_bound:g} (K1's: a "
        f"checkpoint is the accum and final T of the render cut at the bucket's start)")

    acc_4, lte_4, nc_4, ck_4, keep_k = tile_blend.blend_fwd_export(r_k, p_k, st["gw"], st["gh"], MARGIN)
    torch.cuda.synchronize()
    ck4_c, ck4_t, _, _ = checks.checkpoint_check(ck_4, ck_p, r_k, nc_4, nc_p)
    ck4_same = checks.checkpoint_check(ck_4, ck_k, r_k, nc_4, nc_k)[2]
    k4_bit_equal = (torch.equal(acc_4, acc_k) and torch.equal(lte_4, lte_k) and torch.equal(nc_4, nc_k)
                    and ck4_same)
    k4_err = max(fwd_err(acc_4, lte_4), ck4_c, ck4_t)
    keep_mismatch = int((keep_k != keep_p).sum())
    # K4 launched into a keep buffer of 2s: every byte of keep is its own
    unwritten = int((checks.keep_bytes(r_k, p_k, st["gw"], MARGIN) != keep_k.to(torch.uint8)).sum())
    kept = int(keep_k.sum())
    pruned_share = 1.0 - kept / max(p_k.shape[1], 1)
    log(f"[check {name}] K4 accum/log_t_eff/n_contrib/checkpoints bit-equal to K1={k4_bit_equal} "
        f"(checkpoints alone {ck4_same}); checkpoints against the plain version's colour "
        f"{ck4_c:.3g} T {ck4_t:.3g}; max_abs_err to the plain version {k4_err:.3g}; keep mismatches "
        f"against the plain version={keep_mismatch} of {p_k.shape[1]} pairs; kept {kept}, pruned share "
        f"{pruned_share:.6f} (1 - kept / post-cull pairs, margin {MARGIN:g}); keep bytes not written by "
        f"the kernel or not its flags: {unwritten}")
    margin_ok = True
    if headline:
        *_, keep_p1 = blend.blend_fwd_plain(r_k, p_k, st["gw"], st["gh"], keep_margin=1.0)
        kept_p1, kept_p10 = int(keep_p1.sum()), int(keep_p.sum())
        margin_ok = kept_p1 < kept_p10
        log(f"[check {name}] margin honoured: the plain version keeps {kept_p1} pairs at margin 1, "
            f"{kept_p10} at margin {MARGIN:g}")

    # the cached blend through K4's pruned cache, at export parameters
    cache = tile_blend.build_pruned_cache(
        binning.Binned(ranges=r_k, gid=g_k, payload=p_k, total_pairs=st["total"]), keep_k,
        num_gaussians=st["p"], image_size=(st["height"], st["width"]),
    )
    payload_c = st["table"].index_select(0, cache.gid).t().contiguous()
    acc_c, lte_c, nc_c, ck_c = tile_blend.blend_fwd(cache.ranges, payload_c, st["gw"], st["gh"])
    torch.cuda.synchronize()
    cached_fwd_err = max(float((acc_c - acc_k).abs().max()),
                         float((torch.exp(lte_c) - torch.exp(lte_k)).abs().max()))

    ct_a, ct_t = cotangents(torch, st, acc_p, lte_p)
    bargs = (r_k, p_k, g_k, acc_p, nc_p, ck_p, ct_a, ct_t, st["p"], st["gw"], st["gh"])
    g_kern = tile_blend.blend_bwd(*bargs)
    g_plain = blend.blend_bwd_plain(*bargs)
    # dL/dalpha = T (c . ct_accum) - (suffix + ct_eff) / (1 - alpha): the
    # plain gradients with either cotangent zeroed show how far a K2 that
    # lost that term would land, which must be beyond the bound
    g_no_eff = blend.blend_bwd_plain(*bargs[:7], torch.zeros_like(ct_t), *bargs[8:])
    g_no_col = blend.blend_bwd_plain(*bargs[:6], torch.zeros_like(ct_a), *bargs[7:])
    g_fresh = tile_blend.blend_bwd(r_k, p_k, g_k, acc_k, nc_k, ck_k, ct_a, ct_t, st["p"], st["gw"], st["gh"])
    g_cached = tile_blend.blend_bwd(cache.ranges, payload_c, cache.gid, acc_c, nc_c, ck_c, ct_a, ct_t,
                                    st["p"], st["gw"], st["gh"])
    torch.cuda.synchronize()

    def scaled_err(g, ref, fields=("means2d", "conics", "opacity", "colors")):
        errs = {}
        for field, sl in (("means2d", slice(0, 2)), ("conics", slice(2, 5)),
                          ("opacity", slice(5, 6)), ("colors", slice(6, 9))):
            if field in fields:
                scale = max(float(ref[:, sl].abs().max()), 1e-12)
                errs[field] = float((g[:, sl] - ref[:, sl]).abs().max()) / scale
        return errs

    errs = scaled_err(g_kern, g_plain)
    k2_err = max(errs.values())
    k2_abs = float((g_kern - g_plain).abs().max())
    # colours take only ct_accum; the geometric fields take both terms
    geometric = ("means2d", "conics", "opacity")
    eff_weight = max(scaled_err(g_no_eff, g_plain, geometric).values())
    col_weight = max(scaled_err(g_no_col, g_plain, geometric).values())
    log(f"[check {name}] K2 scaled errors {' '.join(f'{k}={v:.3g}' for k, v in errs.items())} "
        f"max_abs_err={k2_abs:.3g} bound={k2_bound:g}; ct_log_t_eff max_abs={float(ct_t.abs().max()):.3g}; "
        f"dropping the ct_eff term would move the geometric gradients by {eff_weight:.3g} scaled, "
        f"dropping the colour term by {col_weight:.3g}")
    cached_errs = scaled_err(g_cached, g_fresh)
    cached_bwd_err = max(cached_errs.values())
    log(f"[check {name}] cached blend through the pruned cache ({cache.gid.shape[0]} pairs) against "
        f"the fresh blend at export parameters: K1 max_abs_err={cached_fwd_err:.3g} (bound {k1_bound:g}), "
        f"K2 scaled errors {' '.join(f'{k}={v:.3g}' for k, v in cached_errs.items())} (bound {k2_bound:g})")
    # what K2 does after K1, under K1's own n_contrib (the plain version's
    # differs from it at a few frontier pixels)
    words = int(blend.checkpoints_read(r_k, nc_k)[1].sum())
    counts = blend.bucket_counts(r_k, p_k, nc_k, st["gw"])
    written = checks.checkpoint_words_written(r_k, p_k, st["gw"], ck_k.shape)
    counts.update(words=words, written=written, slots=ck_k.shape[0], buffer_bytes=ck_k.numel() * 4)
    log(f"[buckets {name}] live buckets (32b < the tile's largest n_contrib) {counts['live_buckets']} of "
        f"{int(((r_k[:, 1] - r_k[:, 0] + 31) // 32).sum())}; checkpoint words K1 writes {written}, K2 reads "
        f"(32b < n_contrib) {words}, {16 * words} bytes; checkpoint buffer {ck_k.shape[0]} rows x 256 pixels x "
        f"16 bytes = {ck_k.numel() * 4} bytes; K2 atomics per step {9 * counts['taken']} (9 for each of the "
        f"{counts['taken']} pairs some pixel applied); applied pixel-pairs {counts['applied']}")

    failed = []
    if not k3_ok:
        failed.append("K3")
    if not k1_err <= k1_bound:
        failed.append("K1")
    if not (ck1_c <= k1_bound and ck1_t <= k1_bound):
        failed.append("K1-checkpoints")
    if written != words:
        failed.append("K1-checkpoint-words-written-not-read")
    if not k2_err <= k2_bound:
        failed.append("K2")
    if not eff_weight > k2_bound:
        failed.append("K2-bound-blind-to-ct_eff")
    if not col_weight > k2_bound:
        failed.append("K2-bound-blind-to-colour-term")
    if not k4_bit_equal:
        failed.append("K4-not-bit-equal-to-K1")
    if not (ck4_c <= k1_bound and ck4_t <= k1_bound):
        failed.append("K4-checkpoints")
    if not headline and keep_mismatch != 0:
        failed.append("K4-keep")
    if unwritten:
        failed.append("K4-keep-bytes-unwritten")
    if headline and not pruned_share > 0.0:
        failed.append("K4-pruned-nothing")
    if not margin_ok:
        failed.append("K4-margin-not-honoured")
    if not cached_fwd_err <= k1_bound:
        failed.append("cached-K1")
    if not cached_bwd_err <= k2_bound:
        failed.append("cached-K2")
    errs = dict(tile_ranges_pack=k3_err, blend_fwd=max(k1_err, ck1_c, ck1_t), blend_bwd=k2_abs,
                blend_fwd_export=k4_err)
    return errs, failed, counts


def check_small_training(torch, device, cadence=False):
    """Training steps on the card against the same steps on the CPU (plain
    versions), from the same small scene: three fresh steps, or with
    `cadence` one export step and CACHED_STEPS cached steps."""
    from gsdf_slam_tpu_torch.config import OptimizationParams
    from gsdf_slam_tpu_torch.engine import train_step
    from gsdf_slam_tpu_torch.models import AdamState, GaussianModel
    from gsdf_slam_tpu_torch.ops import RasterizeConfig
    from gsdf_slam_tpu_torch.ops.transforms import inverse_sigmoid

    opt = OptimizationParams()
    cfg = RasterizeConfig(height=64, width=64)
    target = np.random.default_rng(2).uniform(0, 1, (64, 64, 3)).astype(np.float32)
    results = {}
    for dev in ("cpu", device):
        (means, scales, quats, opac, dc, rest), cam = small_scene(torch, dev)
        model = GaussianModel({
            "xyz": means, "f_dc": dc, "f_rest": rest,
            "opacity": inverse_sigmoid(opac)[:, None], "scaling": torch.log(scales),
            "rotation": quats,
        })
        adam = AdamState.init(model.params())
        gt = torch.from_numpy(target).to(dev)
        bg = torch.zeros(3, device=dev)
        step = lambda i, **kw: train_step(model, adam, cam, gt, None, bg, i, 1.0, cfg, opt, **kw)
        if cadence:
            m, cache = step(0, accumulate_stats=False, export_binning_cache=True)
            metrics = [m] + [step(1 + i, accumulate_stats=False, binning_cache=cache)
                             for i in range(CACHED_STEPS)]
        else:
            metrics = [step(i) for i in range(3)]
        losses = [float(m.loss) for m in metrics]
        results[str(dev)] = (losses, {k: p.detach().cpu() for k, p in model.params().items()})
    (l_cpu, p_cpu), (l_gpu, p_gpu) = results["cpu"], results[str(device)]
    loss_err = max(abs(a - b) for a, b in zip(l_cpu, l_gpu))
    # after step 1 Adam moves each element by about lr * sign(g): a gradient
    # that is float noise around 0 may flip sign, so parameters are held in
    # units of the group's learning rate
    lr = {"xyz": opt.position_lr_init, "f_dc": opt.feature_lr, "f_rest": opt.feature_lr / 20,
          "opacity": opt.opacity_lr, "scaling": opt.scaling_lr, "rotation": opt.rotation_lr}
    p_err = max(float((p_cpu[k] - p_gpu[k]).abs().max()) / lr[k] for k in p_cpu)
    what = f"cadence (1 export + {CACHED_STEPS} cached steps)" if cadence else "3 fresh steps"
    log(f"[check train] {what}: losses cpu={l_cpu} gpu={l_gpu} max_loss_err={loss_err:.3g} "
        f"max_param_err={p_err:.3g} lr units")
    return loss_err <= 1e-5 and p_err <= 6.0


def profile_steps(torch, step, steps=3):
    """Run `steps` steps under torch.profiler. Returns (device busy
    ms/step, wall ms/step, table of the top device-time rows)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for it in range(steps):
            step(100 + it)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = prof.key_averages()
    # kernels and copies: the events that ran on the device
    dev_ms = sum(
        e.self_device_time_total for e in events if e.device_type == torch.autograd.DeviceType.CUDA
    ) / 1e3 / steps
    return dev_ms, wall_ms, events.table(sort_by="self_device_time_total", row_limit=15)


def clone_state(model, adam):
    """An independent copy of the map and its Adam state."""
    from gsdf_slam_tpu_torch.models import AdamState, GaussianModel

    m = GaussianModel({k: p.detach().clone() for k, p in model.params().items()})
    for k, buf in m.named_buffers():
        buf.copy_(getattr(model, k))
    a = AdamState(m={k: v.clone() for k, v in adam.m.items()},
                  v={k: v.clone() for k, v in adam.v.items()}, step=adam.step)
    return m, a


def count_syncs(torch, fn):
    """Run fn under torch.cuda.set_sync_debug_mode("warn"): the number of
    synchronizing CUDA operations torch reports, and where they were called."""
    import warnings
    from collections import Counter

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = [w for w in rec if "synchroniz" in str(w.message)]
    here = os.path.dirname(os.path.abspath(__file__))
    where = Counter(f"{os.path.relpath(w.filename, here)}:{w.lineno}" for w in syncs)
    return len(syncs), dict(where)


def drive_cadence(torch, model, adam, cam, gt, bg, cfg, opt, smi):
    """The mapper's post-densify cadence at the headline (one export step,
    then CACHED_STEPS cached steps, accumulate_stats=False as
    engine/mapper.py:796 uses) against as many fresh steps, from the same
    state, in turns: fresh, cadence, cadence, fresh. Returns the launch
    counts of the first cadence and the failed checks."""
    from gsdf_slam_tpu_torch import kernels
    from gsdf_slam_tpu_torch.engine import train_step

    n = 1 + CACHED_STEPS
    it0 = 1000

    def stepper(m, a):
        return lambda i, **kw: train_step(m, a, cam, gt, None, bg, it0 + i, 1.0, cfg, opt,
                                          accumulate_stats=False, **kw)

    def fresh_run(step):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
        ev[0].record()
        metrics = []
        for i in range(n):
            metrics.append(step(i))
            ev[i + 1].record()
        torch.cuda.synchronize()
        return metrics, [a.elapsed_time(b) for a, b in zip(ev[:-1], ev[1:])]

    def cadence_run(step):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
        ev[0].record()
        m, cache = step(0, export_binning_cache=True)
        ev[1].record()
        metrics = [m]
        for i in range(1, n):
            metrics.append(step(i, binning_cache=cache))
            ev[i + 1].record()
        torch.cuda.synchronize()
        return metrics, [a.elapsed_time(b) for a, b in zip(ev[:-1], ev[1:])], cache

    failed = []
    # warm-up on a scratch copy: the first export and cached step allocate
    wm, wa = clone_state(model, adam)
    cadence_run(stepper(wm, wa))
    del wm, wa

    fresh_ms, export_ms, cached_ms, first_launches = [], [], [], None
    med = lambda v: float(np.median(v))
    # the host's speed drifts within a call: each cadence is read against
    # the fresh run next to it
    turn_median = []
    want = {**dict.fromkeys(kernels.LAUNCHES, 0),
            "blend_fwd_export": 1, "tile_ranges_pack": 1, "blend_fwd": CACHED_STEPS, "blend_bwd": n}
    for turn, kind in enumerate(("fresh", "cadence", "cadence", "fresh")):
        m, a = clone_state(model, adam)
        if kind == "fresh":
            metrics, ms = fresh_run(stepper(m, a))
            fresh_ms += ms
            turn_median.append(med(ms))
        else:
            kernels.reset_launch_counts()
            metrics, ms, cache = cadence_run(stepper(m, a))
            launches = dict(kernels.LAUNCHES)
            export_ms.append(ms[0])
            cached_ms += ms[1:]
            turn_median.append(med(ms[1:]))
            first_launches = first_launches or launches
            log(f"[cadence] run {turn}: launches {launches} (want {want}); cache of "
                f"{cache.gid.shape[0]} pairs, {cache.total_pairs} before the cull")
            if launches != want:
                failed.append(f"cadence:launches-{launches}")
        losses = [float(x.loss) for x in metrics]
        log(f"[cadence] run {turn} {kind}: losses {losses}")
        log(f"[cadence] run {turn} {kind}: per-step ms {[round(v, 4) for v in ms]}")
        if not all(math.isfinite(v) for v in losses):
            failed.append(f"cadence:{kind}-loss-not-finite")
        if turn == 0:
            fresh_first = losses[0]
        elif kind == "cadence":
            # K4 is bit-equal to K1, so the export step renders as the fresh step
            log(f"[cadence] run {turn}: export-step loss - fresh-step loss = {losses[0] - fresh_first:.3g}")
            if abs(losses[0] - fresh_first) > 1e-6:
                failed.append("cadence:export-step-loss-differs-from-fresh")
        del m, a
    log(f"[cadence] median per run (fresh steps; cached steps): {[round(v, 4) for v in turn_median]}; "
        f"cached minus the fresh run beside it: {turn_median[1] - turn_median[0]:.4f}, "
        f"{turn_median[2] - turn_median[3]:.4f} ms")
    log(f"[cadence] step medians on CUDA events: fresh {med(fresh_ms):.4f} ms (n={len(fresh_ms)}), "
        f"export {med(export_ms):.4f} ms (n={len(export_ms)}), cached {med(cached_ms):.4f} ms "
        f"(n={len(cached_ms)}); fresh - cached {med(fresh_ms) - med(cached_ms):.4f} ms; "
        f"mean over the cadence {(sum(export_ms) + sum(cached_ms)) / (len(export_ms) + len(cached_ms)):.4f} "
        f"ms/step on {smi}")

    m, a = clone_state(model, adam)
    step = stepper(m, a)
    _, cache = step(0, export_binning_cache=True)
    kinds = {
        "fresh": lambda it: step(it),
        "export": lambda it: step(it, export_binning_cache=True),
        "cached": lambda it: step(it, binning_cache=cache),
    }
    for kind, fn in kinds.items():
        dev_ms, wall_ms, table = profile_steps(torch, fn, steps=1)
        log(f"[cadence] profiled one {kind} step: device busy {dev_ms:.3f} ms of {wall_ms:.3f} ms wall "
            f"(idle share {1 - dev_ms / wall_ms:.3f}, profiler on)")
        if kind == "cached":
            for line in table.splitlines()[:14]:
                log(f"[profile cached] {line}")
    for kind, fn in kinds.items():
        count, where = count_syncs(torch, lambda: fn(2000))
        log(f"[cadence] host syncs torch reports in one {kind} step: {count} at {where}")
    return first_launches or {}, failed


def check_probes(torch, name, st, chunk, fwd_bound, bwd_bound, headline=False):
    """The probe kernels against their plain versions on one binning (K3's),
    by the comparisons of probes/checks.py: every forward mode, pair2 (also
    against the chunk_exit kernel) and the backward (also folded per
    Gaussian against K2). At the headline, also the plain backward with the
    JAX body's float32 carry, rounded once per chunk, against the float64
    carry of the kernel: the gap and the pixels whose applied pairs differ.
    Returns the largest forward error, pair2's error, the backward's max
    abs error, the tiles on which the chunk exit fired, and the failed
    checks."""
    from gsdf_slam_tpu_torch.ops import binning, blend, blend_probe, tile_blend
    from gsdf_slam_tpu_torch.probes import checks

    gw, gh = st["gw"], st["gh"]
    ranges, gid, payload = binning.tile_ranges_pack(
        st["keys"], st["order"], st["pair_gid"], st["table"], gw * gh)
    n_chunks = (ranges[:, 1] - ranges[:, 0] + chunk - 1) // chunk
    tag = f"[probe {name} chunk {chunk}]"
    failed = []

    outs, fwd_err = {}, 0.0
    for mode in blend_probe.FWD_MODES:
        got = blend_probe.blend_probe_fwd(ranges, payload, gw, gh, mode, chunk)
        want = blend_probe.blend_probe_fwd_plain(ranges, payload, gw, gh, mode, chunk)
        torch.cuda.synchronize()
        e, f = checks.fwd_check(mode, got, want, payload, ranges, fwd_bound, headline)
        outs[mode] = got
        fwd_err = max(fwd_err, e["accum"], e["t_eff"], e["t_raw"])
        floor = (f"; log_t_eff / {blend_probe.FLOOR_SCALE:g} err {e['floor_sum']:.3g} of the tile's "
                 f"sum of |mean x| (bound {checks.FLOOR_RTOL:g})" if mode == "floor" else "")
        log(f"{tag} {mode}: accum err {e['accum']:.3g} (scaled), T_eff {e['t_eff']:.3g}, T_raw "
            f"{e['t_raw']:.3g}, n_done differs on {e['n_done']} of {len(got[3])} tiles; pixels whose "
            f"applied set differs {e['flips']}; chunks walked {int(got[3].sum())} of "
            f"{int(n_chunks.sum())}; bound {fwd_bound:g}{floor}")
        failed += [f"probe-{k}" for k in f]
    exits = int((outs["chunk_exit"][3] < n_chunks).sum())
    log(f"{tag} the chunk exit fired on {exits} of {len(n_chunks)} tiles")

    got = blend_probe.blend_probe_fwd_pair2(ranges, payload, gw, gh, chunk)
    want = blend_probe.blend_probe_fwd_pair2_plain(ranges, payload, gw, gh, chunk)
    torch.cuda.synchronize()
    e, f = checks.pair2_check(got, want, outs["chunk_exit"], payload, ranges, fwd_bound, headline)
    pair_err = max(e["accum"], e["t_eff"], e["t_raw"])
    log(f"{tag} pair2: accum err {e['accum']:.3g}, T_eff {e['t_eff']:.3g}, T_raw {e['t_raw']:.3g}, "
        f"n_done differs on {e['n_done']} tiles; pixels whose applied set differs {e['flips']}; "
        f"bit-equal to the chunk_exit kernel with n_done the pair's max: {e['as_chunk_exit']}")
    failed += [f"probe-{k}" for k in f]

    _, _, raw, nd = blend_probe.blend_probe_fwd_plain(ranges, payload, gw, gh, "chunk_exit", chunk)
    gen = torch.Generator(device=raw.device).manual_seed(0)
    ct_a = torch.randn(raw.shape + (3,), generator=gen, device=raw.device)
    ct_t = torch.randn(raw.shape, generator=gen, device=raw.device)
    bargs = (ranges, payload, nd, raw, ct_a, ct_t, gw, gh, chunk)
    g_k = blend_probe.blend_probe_bwd(*bargs)
    g_again = blend_probe.blend_probe_bwd(*bargs)
    g_p, applied = blend_probe.blend_probe_bwd_plain(*bargs, with_applied=True)
    acc, _, nc, ckpt = blend.blend_fwd_plain(ranges, payload, gw, gh)
    k2 = tile_blend.blend_bwd(ranges, payload, gid, acc, nc, ckpt, ct_a, ct_t, st["p"], gw, gh)
    folded = torch.zeros_like(k2).index_add_(0, gid.to(torch.int64), g_k.t())
    torch.cuda.synchronize()
    e, f = checks.bwd_check(g_k, g_again, g_p, bwd_bound)
    fold = checks.scaled_errors(folded.t(), k2.t())
    log(f"{tag} bwd: scaled errors {' '.join(f'{k}={e[k]:.3g}' for k in checks.FIELDS)} max_abs_err="
        f"{e['max_abs']:.3g} bound {bwd_bound:g}; two launches bit-equal: {e['deterministic']}; folded "
        f"per Gaussian against K2: {' '.join(f'{k}={v:.3g}' for k, v in fold.items())}")
    failed += [f"probe-{k}" for k in f]
    # at the headline a pair at the T = 1e-4 frontier may apply in one plain
    # forward and not the other, so the fold is printed there, not bounded
    if not headline and not all(v <= bwd_bound for v in fold.values()):
        failed.append("probe-bwd-fold-not-K2")
    if headline:
        g32, applied32 = blend_probe.blend_probe_bwd_plain(*bargs, chunk_carry32=True, with_applied=True)
        gap = checks.scaled_errors(g32, g_p)
        moved = (applied32 != applied).sum()
        log(f"{tag} bwd with the JAX body's float32 carry (rounded once per chunk) against the float64 "
            f"carry: scaled {' '.join(f'{k}={v:.3g}' for k, v in gap.items())}; applied pairs differ at "
            f"{int(moved)} of {applied.numel()} pixels, by {int((applied32 - applied).abs().sum())} "
            f"pixel-pairs in all, of {int(applied.sum())} applied")
    return dict(fwd=fwd_err, pair2=pair_err, bwd=e["max_abs"], exits=exits), failed


def pair_table_cases(torch, p, mp, device):
    """Each pair-table kernel on benchmarks/microbench.py's inputs at (p,
    mp): its wrapper, its plain version, the one PyTorch call that computes
    the same function (never called by the port), the bytes it must move
    and its shapes."""
    from gsdf_slam_tpu_torch.ops import pair_table as pt
    from gsdf_slam_tpu_torch.probes import microbench

    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    cases = {}
    tbl_np, src_np, mpa = microbench.realign_inputs(mp)
    tbl, src = dev(tbl_np), dev(src_np)
    lanes = src_np.shape[1]
    # the source lane of each output lane; a lane no group covers, or whose
    # source lies past src, reads the zero column `lanes` of src_pad
    lane_src = np.full(mpa, lanes, np.int64)
    for s0, d0, n in tbl_np.T.astype(np.int64):
        s = s0 + np.arange(n * pt.CHUNK)
        lane_src[d0:d0 + len(s)] = np.where(s < lanes, s, lanes)[: mpa - d0]
    src_pad, lane_idx = torch.cat([src, torch.zeros((16, 1), device=device)], 1), dev(lane_src)
    copied = int((lane_src < lanes).sum())
    cases["realign_copy"] = dict(
        kern=lambda: pt.realign_copy(tbl, src, mpa), plain=lambda: pt.realign_copy_plain(tbl, src, mpa),
        library=lambda: src_pad.index_select(1, lane_idx),
        bytes=64 * copied + tbl_np.nbytes + 64 * mpa, shapes=f"{len(tbl_np.T)} groups, mpa {mpa}")
    for name, win, cpc in (("window_gather_rows", pt.WIN_ROWS, pt.CPC_ROWS),
                           ("window_gather_cols", pt.WIN_COLS, pt.CPC_COLS)):
        ws_np, table_np, ranks_np = microbench.window_inputs(p, mp, win, cpc)
        local = ranks_np - np.repeat(ws_np, cpc)
        touched = len(np.unique(ranks_np[(local >= 0) & (local < win)]))
        ws, table, ranks = dev(ws_np), dev(table_np), dev(ranks_np)
        r64 = ranks.to(torch.int64)
        kern, plain = getattr(pt, name), getattr(pt, f"{name}_plain")
        library = ((lambda t=table.t(), r=r64: t[r]) if name == "window_gather_rows"
                   else (lambda t=table, r=r64: t[:, r]))
        cases[name] = dict(
            kern=lambda k=kern, a=(ws, table, ranks): k(*a), plain=lambda k=plain, a=(ws, table, ranks): k(*a),
            library=library, bytes=64 * touched + 4 * mp + ws_np.nbytes + 64 * mp,
            shapes=f"p {p}, mp {mp}, window {win}, chunk {cpc}")
    x = dev(microbench.xpose_inputs(mp))
    cases["xpose_cumsum"] = dict(
        kern=lambda: pt.xpose_cumsum(x), plain=lambda: pt.xpose_cumsum_plain(x),
        library=lambda: torch.cumsum(x, 0, dtype=torch.int32),  # leaves out the transpose
        bytes=2 * 64 * mp, shapes=f"mp {mp}")
    return cases


def check_pair_table(torch, tag, cases):
    """Each pair-table kernel bit-equal to its plain version; returns the
    failed checks."""
    from gsdf_slam_tpu_torch.probes import checks

    failed = []
    for name, c in cases.items():
        got, want = c["kern"](), c["plain"]()
        torch.cuda.synchronize()
        same = checks.bit_equal(got, want)
        log(f"[pair table {tag}] {name} ({c['shapes']}): bit-equal to its plain version={same}")
        if not same:
            failed.append(f"pair-table-{name}@{tag}")
    return failed


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    # the port is the package beside this script; without it (the script
    # copied out of the repo) there is nothing to drive
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from gsdf_slam_tpu_torch import kernels
    except ModuleNotFoundError as e:
        if e.name != "gsdf_slam_tpu_torch":
            raise
        print(f"chip_smoke: {e}; run this script from a checkout of the repo", file=sys.stderr)
        return 2
    from gsdf_slam_tpu_torch.config import OptimizationParams
    from gsdf_slam_tpu_torch.engine import train_step
    from gsdf_slam_tpu_torch.models import AdamState
    from gsdf_slam_tpu_torch.ops import RasterizeConfig, binning, blend, blend_probe, tile_blend
    from gsdf_slam_tpu_torch.probes import checks, expand_probe, kernel_probe, microbench
    from gsdf_slam_tpu_torch.probes.timing import bound_ms, cuda_ms, graph_ms, require_cuda, sfu_per_s
    from gsdf_slam_tpu_torch.probes.scene import (
        HEIGHT, WALL_SIZE, WIDTH, headline_camera, headline_scene, wall_scene,
    )

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failed: list[str] = []

    # ---- 1. device
    smi = require_cuda()
    log("[device] nvidia-smi:")
    log(smi)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")

    # ---- 2. build
    t0 = time.perf_counter()
    kernels.library()
    log(f"[build] {kernels.build_info['path']} built in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {kernels.build_info['seconds']:.2f} s, cached={kernels.build_info['cached']})")
    for line in kernels.build_info.get("log", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")
    usage = kernels.ptxas_usage(kernels.build_info.get("log", ""))
    # probe_fwd_kernel<Li{mode}E>: blend_probe_fwd's modes in FWD_MODES order
    probe_fwd = [f"probe_fwd_kernel<Li{i}E>" for i in range(len(blend_probe.FWD_MODES))]
    for name in ("blend_fwd_kernel", "blend_fwd_export_kernel", *probe_fwd, "probe_fwd_pair2_kernel",
                 "probe_bwd_kernel", "xpose_cumsum_kernel"):
        u = usage.get(name, {})
        log(f"[build] {name}: {u.get('registers')} registers, {u.get('spill_stores')} bytes spill stores, "
            f"{u.get('spill_loads')} bytes spill loads, {u.get('smem')} bytes smem "
            f"({65536 // (256 * u['registers']) if u.get('registers') else '?'} blocks of 256 threads an SM "
            f"by registers)")
    mismatches = checks.log1p_live_mismatches()
    log(f"[build] the live-range log1p of K4 and the probes against log1pf, on every float32 alpha in [1/255, 0.99]: "
        f"{mismatches} bit mismatches")
    if mismatches:
        failed.append("K4-log1p-not-log1pf")

    # ---- 3. kernel checks
    args, cam = small_scene(torch, device)
    st_small = stage_inputs(torch, args, cam, 64, 64)
    _, f, _ = check_kernels(torch, "64x64", st_small, K1_SMALL, K2_SMALL)
    failed += [f"{k}@64x64" for k in f]
    wargs, wcam = wall_scene(device)
    st_wall = stage_inputs(torch, wargs, wcam, WALL_SIZE, WALL_SIZE)
    _, f, _ = check_kernels(torch, f"wall {WALL_SIZE}x{WALL_SIZE}", st_wall, K1_SMALL, K2_SMALL)
    failed += [f"{k}@wall" for k in f]

    t0 = time.perf_counter()
    model = headline_scene(device)
    cam_h = headline_camera(device)
    log(f"[main] headline scene {model.count} Gaussians built in {time.perf_counter() - t0:.2f} s")
    hargs = (model.xyz.detach(), model.scaling_act().detach(), model.rotation_act().detach(),
             model.opacity_act()[:, 0].detach(), model.f_dc.detach(), model.f_rest.detach())
    st_head = stage_inputs(torch, hargs, cam_h, WIDTH, HEIGHT)
    head_err, f, head_counts = check_kernels(torch, f"{WIDTH}x{HEIGHT}", st_head, K1_HEADLINE, K2_HEADLINE,
                                             headline=True)
    failed += [f"{k}@headline" for k in f]
    torch.cuda.synchronize()

    if not check_small_training(torch, device):
        failed.append("train@64x64")
    if not check_small_training(torch, device, cadence=True):
        failed.append("cadence@64x64")
    torch.cuda.synchronize()

    # ---- 4. main path
    opt = OptimizationParams()
    cfg = RasterizeConfig(height=HEIGHT, width=WIDTH)
    adam = AdamState.init(model.params())
    gt = torch.from_numpy(
        np.random.default_rng(1).uniform(0, 1, (HEIGHT, WIDTH, 3)).astype(np.float32)
    ).to(device)
    bg = torch.zeros(3, device=device)
    n0 = model.count
    metrics = []
    kernels.reset_launch_counts()
    for it in range(WARMUP):
        metrics.append(train_step(model, adam, cam_h, gt, None, bg, it, 1.0, cfg, opt))
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED + 1)]
    t_host = time.perf_counter()
    events[0].record()
    for i, it in enumerate(range(WARMUP, WARMUP + TIMED)):
        metrics.append(train_step(model, adam, cam_h, gt, None, bg, it, 1.0, cfg, opt))
        events[i + 1].record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t_host) * 1e3 / TIMED
    launches = dict(kernels.LAUNCHES)
    step_ms = [a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])]
    ms_step = events[0].elapsed_time(events[-1]) / TIMED
    losses = [float(m.loss) for m in metrics]
    pairs = [int(m.total_pairs) for m in metrics]
    log(f"[main] pairs before the cull per step: {pairs}")
    log(f"[main] losses: {losses}")
    log(f"[main] psnr last step: {float(metrics[-1].psnr):.4f} dB")
    log(f"[main] train_step median {float(np.median(step_ms)):.3f} ms, min {min(step_ms):.3f}, "
        f"max {max(step_ms):.3f}, mean {ms_step:.3f} ms/step on CUDA events; mean "
        f"{host_ms:.3f} ms/step on the host clock ({TIMED} steps after {WARMUP} warm-up) on {smi}")
    log(f"[main] per-step ms: {[round(v, 4) for v in step_ms]}")
    log(f"[main] launches over {WARMUP + TIMED} steps: {launches}")
    if not all(math.isfinite(v) for v in losses):
        failed.append("main:loss-not-finite")
    if model.count != n0:
        failed.append("main:count-changed")
    for name in ("tile_ranges_pack", "blend_fwd", "blend_bwd"):
        if launches[name] < WARMUP + TIMED:
            failed.append(f"main:{name}-launched-{launches[name]}")
    if launches["blend_fwd_export"] != 0:
        failed.append("main:fresh-step-launched-K4")

    dev_ms, wall_ms, table = profile_steps(
        torch, lambda it: train_step(model, adam, cam_h, gt, None, bg, it, 1.0, cfg, opt)
    )
    log(f"[main] profiled 3 steps: device busy {dev_ms:.3f} ms/step of {wall_ms:.3f} ms wall "
        f"(idle share {1 - dev_ms / wall_ms:.3f}, profiler on); top rows over the 3 steps:")
    for line in table.splitlines():
        log(f"[profile] {line}")

    # ---- 4b. main path: the cached-binning cadence, against fresh binning
    cad_launches, f = drive_cadence(torch, model, adam, cam_h, gt, bg, cfg, opt, smi)
    failed += f

    # ---- 5. kernel times at the headline shapes
    st = st_head
    num_tiles = st["gw"] * st["gh"]
    a3 = (st["keys"], st["order"], st["pair_gid"], st["table"], num_tiles)
    ranges, gid, payload = binning.tile_ranges_pack(*a3)
    acc, lte, nc, ckpt = tile_blend.blend_fwd(ranges, payload, st["gw"], st["gh"])
    ct_a, ct_t = cotangents(torch, st, acc, lte)
    a2 = (ranges, payload, gid, acc, nc, ckpt, ct_a, ct_t, st["p"], st["gw"], st["gh"])
    pairs_live = payload.shape[1]
    # bytes each kernel must move (inputs read once, outputs written once),
    # the pixel-pairs its work runs over and its special functions, on this
    # run's inputs
    pix = num_tiles * 256
    nc_sum = int(nc.sum())
    counts = head_counts
    n_buckets = (nc.amax(1).to(torch.int64) + 31) // 32
    # the pairs of the live buckets, the only ones K2 reads
    pairs_k2 = int(torch.minimum((ranges[:, 1] - ranges[:, 0]).to(torch.int64), 32 * n_buckets).sum())
    sfu_rate = sfu_per_s()
    log(f"[bound] headline: {pairs_live} pairs, {num_tiles} tiles, {nc_sum} pixel-pairs up to each "
        f"pixel's last applied pair (sum of n_contrib), {counts['applied']} of them applied; {pairs_k2} pairs "
        f"in K2's {counts['live_buckets']} live buckets; {counts['words']} checkpoint words K2 reads; special "
        f"functions at {sfu_rate:.4g}/s (16 a clock on each of 132 SMs at nvidia-smi's clocks.max.sm)")
    # ranges, payload; accum, log_t_eff, n_contrib, the checkpoints K2 reads
    fwd_bytes = 8 * num_tiles + 36 * pairs_live + 20 * pix + 16 * counts["words"]
    # Work on this run's inputs, the least the functions need: the exponent
    # and live test on each pixel-pair up to n_contrib; the rest only on the
    # live ones, which up to n_contrib are exactly the applied ones (a pixel
    # applies every live pair before its last). Special functions: expf of
    # the exponent and of log T on each applied pixel-pair, and K2's
    # reciprocal of 1 - alpha (log1pf, which need not use the SFU, is not
    # counted).
    applied = counts["applied"]
    fwd_ops = FWD_WALK_OPS * nc_sum + (FWD_OPS - FWD_WALK_OPS) * applied
    # K4's walk down to its relaxed exit at MARGIN, and at margin 1, which
    # is K1's walk (the frontier pair included); a warp-step is one pair of
    # a warp's walk, which lasts until its slowest pixel exits
    walk4, live4 = blend.export_walk_counts(ranges, payload, st["gw"], MARGIN)
    walk1, live1 = blend.export_walk_counts(ranges, payload, st["gw"], 1.0)
    walked4, walked_live4, walked1, walked_live1 = (int(x.sum()) for x in (walk4, live4, walk1, live1))
    steps4, steps1 = (int(x.view(-1, 8, 32).amax(-1).sum()) for x in (walk4, walk1))
    walk_ratio = steps4 / steps1
    log(f"[bound] K4 at margin {MARGIN:g} walks {walked4} pixel-pairs, {walked_live4} of them live, in {steps4} "
        f"warp-steps; K1 (margin 1) {walked1}, {walked_live1} live, {steps1} warp-steps: walk ratio "
        f"{walk_ratio:.4f} in warp-steps, {walked4 / walked1:.4f} in pixel-pairs")
    bounds = {
        "tile_ranges_pack": bound_ms(20 * pairs_live + st["table"].numel() * 4  # keys, order, pair_gid, table
                                     + 8 * num_tiles + 40 * pairs_live),  # ranges, gid, payload
        "blend_fwd": bound_ms(fwd_bytes, fwd_ops, 2 * applied, sfu_rate),
        # ranges, the live buckets' payload and gid, accum, n_contrib, both
        # cotangents, the checkpoints it reads; grads [P, 9]
        "blend_bwd": bound_ms(8 * num_tiles + 40 * pairs_k2 + 32 * pix + 16 * counts["words"] + 36 * st["p"],
                              FWD_WALK_OPS * nc_sum + (BWD_OPS - FWD_WALK_OPS) * applied, 3 * applied, sfu_rate),
        # K1's bytes and keep [M]; the walk to the relaxed exit, the
        # exponent's expf on its live pixel-pairs and expf of log T on the
        # applied ones
        "blend_fwd_export": bound_ms(fwd_bytes + pairs_live,
                                     FWD_WALK_OPS * walked4 + EXPORT_LIVE_OPS * walked_live4,
                                     walked_live4 + applied, sfu_rate),
    }
    timings = {
        "tile_ranges_pack": (lambda: binning.tile_ranges_pack(*a3),
                             lambda: binning.tile_ranges_pack_plain(*a3)),
        "blend_fwd": (lambda: tile_blend.blend_fwd(ranges, payload, st["gw"], st["gh"]),
                      lambda: blend.blend_fwd_plain(ranges, payload, st["gw"], st["gh"])),
        "blend_bwd": (lambda: tile_blend.blend_bwd(*a2), lambda: blend.blend_bwd_plain(*a2)),
        "blend_fwd_export": (
            lambda: tile_blend.blend_fwd_export(ranges, payload, st["gw"], st["gh"], MARGIN),
            lambda: blend.blend_fwd_plain(ranges, payload, st["gw"], st["gh"], keep_margin=MARGIN)),
    }
    launches = {**launches, "blend_fwd_export": cad_launches.get("blend_fwd_export", 0)}
    entries = []

    def time_entry(name, kern, plain, shapes, count, err, bound, library=None):
        # in turns: plain, kernel, library, kernel, library, plain; the kernel
        # and the library call replayed from a CUDA graph of 20 calls (the
        # device's time), the plain version on CUDA events
        p0 = cuda_ms(plain, 3)
        k0 = graph_ms(kern)
        l0 = graph_ms(library) if library else None
        k1 = graph_ms(kern)
        l1 = graph_ms(library) if library else None
        p1 = cuda_ms(plain, 3)
        ms, plain_ms = (k0 + k1) / 2, (p0 + p1) / 2
        lib_ms = (l0 + l1) / 2 if library else None
        lib = f"library {lib_ms:.4f} ms (runs {l0:.4f}, {l1:.4f})" if library else "no library call"
        log(f"[time] {name}: kernel {ms:.4f} ms graph (runs {k0:.4f}, {k1:.4f}), bound {bound[0]:.4f} ms "
            f"({bound[2]}; {bound[0] / ms:.3f} of it), {lib}, plain {plain_ms:.4f} ms (runs {p0:.4f}, "
            f"{p1:.4f}) at {shapes} on {smi}")
        entries.append(dict(name=name, route="cuda", **KERNELS[name], launches=count, max_abs_err=err,
                            ms=ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1], library_ms=lib_ms))

    for name, (kern, plain) in timings.items():
        time_entry(name, kern, plain, f"{pairs_live} pairs, {num_tiles} tiles", launches[name], head_err[name],
                   bounds[name])
    k1_fn, k4_fn = timings["blend_fwd"][0], timings["blend_fwd_export"][0]
    turns = [graph_ms(f) for f in (k1_fn, k4_fn, k4_fn, k1_fn)]
    k4_over_k1 = (turns[1] + turns[2]) / (turns[0] + turns[3])
    log(f"[time] K4/K1 in turns (K1, K4, K4, K1: {', '.join(f'{v:.4f}' for v in turns)} ms graph): "
        f"{k4_over_k1:.4f}, against the walk ratio {walk_ratio:.4f} in warp-steps "
        f"({walked4 / walked1:.4f} in pixel-pairs) on {smi}")

    # ---- 6. probes: each probe kernel against its plain version on the
    # 64x64 scene and the opaque wall at two chunk sizes, and at the headline;
    # then the probe path through its two entry points, with the launch
    # counts taken over exactly that run; then each probe kernel's time
    for chunk in PROBE_CHUNKS:
        for nm, stp in (("64x64", st_small), (f"wall {WALL_SIZE}x{WALL_SIZE}", st_wall)):
            res, f = check_probes(torch, nm, stp, chunk, checks.FWD_SMALL, checks.BWD_SMALL)
            failed += [f"{k}@{nm}/chunk{chunk}" for k in f]
            if stp is st_wall and chunk == 16 and res["exits"] == 0:
                failed.append("probe-wall-exit-never-fired")
    probe_err, f = check_probes(torch, f"{WIDTH}x{HEIGHT}", st_head, 128, K1_HEADLINE, K2_HEADLINE,
                                headline=True)
    failed += [f"{k}@headline" for k in f]

    kernels.reset_launch_counts()
    probe_ms = kernel_probe.main([])
    expand = expand_probe.main([])
    probe_launches = dict(kernels.LAUNCHES)
    log(f"[probe] launches over the probe path: {probe_launches}")
    log(f"[probe] kernel_probe ms: {json.dumps(probe_ms)}")
    log(f"[probe] expand_probe: {json.dumps(expand)}")
    for name in PROBES:
        if probe_launches[name] == 0:
            failed.append(f"probe-path:{name}-not-launched")
    if not all(r["bit_equal"] for r in expand.values()):
        failed.append("probe-path:expand_gather-not-bit-equal")

    gw, gh = st["gw"], st["gh"]
    _, _, raw, nd = blend_probe.blend_probe_fwd(ranges, payload, gw, gh, "chunk_exit")
    ct_pa, ct_pt = kernel_probe.cotangents(num_tiles, device)
    pb = (ranges, payload, nd, raw, ct_pa, ct_pt, gw, gh)
    # The work the probes' functions need on this run's inputs, at chunk 128
    # (ops/blend_probe.py::probe_walk_counts over chunk_exit's walk; the
    # applied pixel-pairs from the backward's plain version, which the
    # forward applies too): the offsets, exponent and live test on every
    # walked pixel-pair; expf, the opacity product, the clamp and log1pf on
    # the live ones; the backward's gradient math on the applied ones.
    # Special functions: expf of the exponent on the live ones, expf of T on
    # the applied ones and the backward's reciprocal there. pair2 is bounded
    # on each tile's own chunk_exit walk: the chunks it walks past a tile's
    # exit are not work its function needs.
    walked_p, live_p = (int(x.sum()) for x in blend_probe.probe_walk_counts(ranges, payload, gw, nd))
    applied_p = int(blend_probe.blend_probe_bwd_plain(*pb, with_applied=True)[1].sum())
    nd2 = blend_probe.blend_probe_fwd_pair2(ranges, payload, gw, gh)[3]
    counts = (ranges[:, 1] - ranges[:, 0]).to(torch.int64)
    pair2_walk = 256 * int(torch.minimum(nd2.to(torch.int64) * 128, counts).sum())
    log(f"[bound] probes at chunk 128: chunk_exit walks {walked_p} pixel-pairs, {live_p} of them live, "
        f"{applied_p} applied; pair2's lock step walks {pair2_walk} (x{pair2_walk / walked_p:.4f}); special "
        f"functions at {sfu_rate:.4g}/s")
    # ranges, payload; accum, log_t_eff, log_t_raw, n_done
    probe_fwd_bytes = 8 * num_tiles + 36 * pairs_live + 20 * pix + 4 * num_tiles
    probe_fwd_bound = bound_ms(probe_fwd_bytes, FWD_WALK_OPS * walked_p + EXPORT_LIVE_OPS * live_p,
                               live_p + applied_p, sfu_rate)
    mp = EXPAND_MP
    p = max(mp // 3, 1000) // 128 * 128
    table, rank, g0, lr = (torch.from_numpy(a).to(device) for a in expand_probe.build(mp, p)[:4])
    rank64 = rank.to(torch.int64)
    exp_err = float((blend_probe.expand_gather(table, g0, lr) - table[:, rank64]).abs().max())
    # table lanes the rank touches, lr and g0; out [16, mp]
    exp_bytes = 64 * int(torch.unique(rank).numel()) + 4 * mp + 4 * g0.numel() + 64 * mp
    probe_timings = {
        "blend_probe_fwd": (lambda: blend_probe.blend_probe_fwd(ranges, payload, gw, gh, "chunk_exit"),
                            lambda: blend_probe.blend_probe_fwd_plain(ranges, payload, gw, gh, "chunk_exit"),
                            probe_err["fwd"], probe_fwd_bound),
        "blend_probe_fwd_pair2": (lambda: blend_probe.blend_probe_fwd_pair2(ranges, payload, gw, gh),
                                  lambda: blend_probe.blend_probe_fwd_pair2_plain(ranges, payload, gw, gh),
                                  probe_err["pair2"], probe_fwd_bound),
        # ranges, payload, n_done, log_t_raw, both cotangents; grads [9, M]
        "blend_probe_bwd": (lambda: blend_probe.blend_probe_bwd(*pb),
                            lambda: blend_probe.blend_probe_bwd_plain(*pb), probe_err["bwd"],
                            bound_ms(12 * num_tiles + 72 * pairs_live + 20 * pix,
                                     FWD_WALK_OPS * walked_p + EXPORT_LIVE_OPS * live_p
                                     + PROBE_BWD_APPLIED_OPS * applied_p, live_p + 2 * applied_p, sfu_rate)),
    }
    for name, (kern, plain, err, bound) in probe_timings.items():
        time_entry(name, kern, plain, f"{pairs_live} pairs, {num_tiles} tiles, chunk 128",
                   probe_launches[name], err, bound)
    time_entry("expand_gather", lambda: blend_probe.expand_gather(table, g0, lr),
               lambda: blend_probe.expand_gather_plain(table, g0, lr), f"mp {mp}, p {p}",
               probe_launches["expand_gather"], exp_err, bound_ms(exp_bytes), lambda: table[:, rank64])
    del table, rank, rank64, g0, lr

    # ---- 7. pair table: each kernel bit-equal to its plain version at three
    # sizes; then the microbench through its entry point, with the launch
    # counts taken over exactly that run; then each kernel's time
    for tag, (p, mp) in PAIR_TABLE_SIZES.items():
        failed += check_pair_table(torch, tag, pair_table_cases(torch, p, mp, device))
    kernels.reset_launch_counts()
    bench = microbench.main([])
    bench_launches = dict(kernels.LAUNCHES)
    log(f"[microbench] launches over the microbench: {bench_launches}")
    for name in PAIR_TABLE:
        if bench_launches[name] == 0:
            failed.append(f"microbench:{name}-not-launched")
    if not all(r.get("bit_equal", True) for r in bench.values()):
        failed.append("microbench:kernel-not-bit-equal")
    p, mp = PAIR_TABLE_SIZES["headline"]
    for name, c in pair_table_cases(torch, p, mp, device).items():
        # bit-equal at these inputs above, so the error is 0
        time_entry(name, c["kern"], c["plain"], c["shapes"], bench_launches[name], 0.0, bound_ms(c["bytes"]),
                   c["library"])

    torch.cuda.synchronize()
    if failed:
        log(f"[result] FAILED: {failed}")
        return 1
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
