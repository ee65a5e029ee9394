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
5b. the preprocess kernels (preprocess_fwd, preprocess_bwd) at the cells'
   map sizes (0.63M and 2.0M Gaussians at KITTI's 1226x370, SH 3):
   checked against the plain version and its autograd VJP
   (probes/checks.py::preprocess_check), then each kernel's time beside
   the plain version's and its bound on bytes, in turns;
5c. the loss kernels (loss_fwd, loss_bwd) at 1226x370, 1200x680, 640x480
   and 185x1226, masked and not, and on half of KITTI's rows, against the
   plain version, twice, bit-equal (probes/checks.py::loss_check); then
   each kernel's time beside the plain version's and its bound on bytes,
   in turns, and the torch-op loss's;
5d. the binning's passes (bin_count, bin_write) and the card's binning
   route at the headline and at the cells' loads (street scenes binning
   their steps' pre-cull pairs), against the plain
   route, bit-equal (probes/checks.py::binning_check); then each pass's
   time beside its plain version's and its bound on bytes, the card's
   route's device time beside torch.sort of the plain route's 64-bit keys,
   and both routes whole on CUDA events;
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
   run; then each kernel's time at the headline;
8. densify cycle: the model's life cycle at the headline through the
   entry points a mapper calls, with the launch counts taken over exactly
   this phase: a Scene of four Keyframes (cameras_extent from
   nerfpp_norm), five fresh steps with densification statistics,
   densify_and_prune (clone, split, prune) on the card against the same
   surgery on a CPU copy with the same noise, render_depth_state through
   K1 against the plain blend, increase_pcd of 200,000 seeded points,
   reset_opacity and prune_young; binning caches from before a surgery
   raise; three fresh steps, one export and three cached steps at the new
   count. `[densify]` lines: counts before and after every step and
   surgery, each surgery's host ms and host syncs, the fresh step median
   before and after the cycle, and the phase's wall time;
9. streaming, the mapper's loop through the port's data plane, with the
   launch counts taken over each stream: (9a) the colouriser on the card
   against the same function on a CPU copy, at KITTI's shapes (a 1226x370
   image of the synthetic drive, a 120,000-point 360-degree scan), and the
   host ms of colorize_frame; (9b) a KITTI-mode stream, cfg/kitti.yaml's
   settings (the port's copy): 20 frames along the drive, each colourised,
   ingested and trained once, then 40 polish iterations, with the count of
   fresh, export and cached steps, the launches of K3, K1, K2 and K4, the
   Gaussians at the end, the mapper's host ms per phase and the host syncs
   of one ingest and one step; (9c) the room stream at 1200x680 through
   gsdf_slam_tpu_torch.stream (60 frames and the drain), its JSON line,
   the device's peak memory and the ingest split between the host 3-NN and
   the rest; (9d) a short stream (6 frames at 64x64, rebin 4) on the card
   against the CPU: the same keyframes, iterations, counts and binning
   decisions, losses within 1e-5;
10. the monocular SLAM mode, cfg/tum_mono.yaml's settings (the port's
   copy; the pyramid off, the card's machine has no cv2), with the launch
   counts taken over each run: (10a) 60 room keyframes at 1200x680 fed
   image only with 1,000 seeded tracker points each (probes/mono.py), one
   step each, a small correction (0.5 deg, 1 cm) of an earlier keyframe
   after every 10th keyframe's step and a large one (35 deg) of keyframe
   40, then 60 polish iterations: frames/s, iterations/s, the samples by
   source, host ms per phase, host syncs of a keyframe that fills the depth
   cache, of one that flushes it and of a step, the launches of K3, K1 and
   K2 against the steps and depth renders, the counts around the large
   correction, the Gaussians at the end and the peak device memory; (10b)
   its checkpoint saved, loaded on the card and on the CPU (bit-equal),
   renders of three keyframes bit-equal, one train_step from each within
   1e-5 loss and 6 lr units; (10c) the room stream (60 frames, 1200x680)
   at pipeline depths 0, 2, 2, 0, and the host syncs a step at each depth;
   (10d) probes/mono.py's short mono stream (8 keyframes at 64x64) at
   pipeline depth 2 on the card against the CPU (checks.mono_run_check:
   tracker and prior samples bit-equal, the depth render's within K1's
   bar, the samples that differ at the selection's frontier counted), and
   against the card at depth 0; then 11 keyframes fed an image only, at
   the default settings and at the yaml's depth cache of 10 (nine steps
   on an empty map), card against CPU.

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
    # phase 5b: no Pallas kernel; the JAX package leaves the preprocess to
    # XLA's fusion
    "preprocess_fwd": dict(source="gsdf_slam_tpu_torch/csrc/preprocess.cu", replaces="none"),
    "preprocess_bwd": dict(source="gsdf_slam_tpu_torch/csrc/preprocess.cu", replaces="none"),
    # phase 5c: no Pallas kernel; the JAX package leaves the loss to XLA's
    # fusion
    "loss_fwd": dict(source="gsdf_slam_tpu_torch/csrc/loss.cu", replaces="none"),
    "loss_bwd": dict(source="gsdf_slam_tpu_torch/csrc/loss.cu", replaces="none"),
    # phase 5d: no Pallas kernel; the JAX package leaves the expansion, the
    # cull and the sort to XLA ops
    "bin_count": dict(source="gsdf_slam_tpu_torch/csrc/binning.cu", replaces="none"),
    "bin_write": dict(source="gsdf_slam_tpu_torch/csrc/binning.cu", replaces="none"),
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
# phase 8: fresh steps with statistics before the densify; the keyframes'
# offsets in x and y around the headline camera (at 0.5 m the extent is
# 0.778 m, and so few Gaussians are small enough to clone that none of
# them is in view: phase 8 prints the counts at both offsets); the
# mapper's densify settings; the points of the ingest; prune_young's window
CYCLE_STEPS = 5
KF_OFFSET = 1.0
DENSIFY = dict(max_grad=0.0002, min_opacity=0.005, max_screen_size=20, percent_dense=0.01)
INGEST_POINTS = 200_000
STABLE_NUM_ITER = 3
# phase 9: KITTI's image size, an HDL-64E scan's size, the KITTI-mode drive
# (frames, then polish iterations; the host syncs are counted at one frame),
# the room stream of benchmarks/e2e_stream.py, and the short stream run on
# the card and on the CPU
KITTI_W, KITTI_H = 1226, 370
SCAN_POINTS = 120_000
KITTI_FRAMES, POLISH_ITERS, SYNC_FRAME = 20, 40, 10
ROOM_FRAMES, ROOM_W, ROOM_H = 60, 1200, 680
# phase 5c: the loss kernels' image sizes (width, height): KITTI's, the
# room's, the mono mode's and a tall one
LOSS_SIZES = ((1226, 370), (1200, 680), (640, 480), (185, 1226))
SHORT_FRAMES, SHORT_SIZE, SHORT_REBIN = 6, 64, 4
# phase 10: the mono stream's keyframes (the room at ROOM_W x ROOM_H), its
# polish iterations and tracker points a keyframe; a small correction after
# every SMALL_EVERY-th keyframe's step, of the keyframe SMALL_BACK before
# it; the large one of keyframe LARGE_AT; the keyframes whose host syncs are
# counted (one that fills the depth cache, one that flushes it); the
# keyframes rendered after the checkpoint's load; the pipeline depths of the
# room stream, in turns, and the frames of the stream whose syncs are
# counted; the image-only keyframes of 10d
MONO_FRAMES, MONO_POLISH, TRACKER_POINTS = 60, 60, 1000
SMALL_EVERY, SMALL_BACK, LARGE_AT = 10, 5, 40
MONO_SYNC_FRAMES = (25, 29)
CKPT_RENDER_FIDS = (0, 30, 59)
PIPE_DEPTHS = (0, 2, 2, 0)
SYNC_STREAM_FRAMES = 8
IMAGE_ONLY_FRAMES = 11


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
    # K3 takes the sorted pairs' tile ids, int32 as the step's binning
    tiles = (keys >> 32).to(torch.int32)
    return dict(tiles=tiles, order=order, pair_gid=pair_gid, table=table, total=total,
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
    args3 = (st["tiles"], st["order"], st["pair_gid"], st["table"], num_tiles)
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


def lr_units_err(got: dict, want: dict, opt, spatial_lr_scale: float = 1.0) -> float:
    """The largest parameter difference in units of its group's learning
    rate. After step 1 Adam moves each element by about lr * sign(g): a
    gradient that is float noise around 0 may flip sign, so training on the
    card is held to the CPU's in these units."""
    lr = {"xyz": opt.position_lr_init * spatial_lr_scale, "f_dc": opt.feature_lr, "f_rest": opt.feature_lr / 20,
          "opacity": opt.opacity_lr, "scaling": opt.scaling_lr, "rotation": opt.rotation_lr}
    return max(float((got[k].cpu() - want[k].cpu()).abs().max()) / lr[k] for k in lr)


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
    p_err = lr_units_err(p_cpu, p_gpu, opt)
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
    from gsdf_slam_tpu_torch.convert import copy_state
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
    wm, wa = copy_state(model, adam)
    cadence_run(stepper(wm, wa))
    del wm, wa

    fresh_ms, export_ms, cached_ms, first_launches = [], [], [], None
    med = lambda v: float(np.median(v))
    # the host's speed drifts within a call: each cadence is read against
    # the fresh run next to it
    turn_median = []
    want = {**dict.fromkeys(kernels.LAUNCHES, 0), "blend_fwd_export": 1, "tile_ranges_pack": 1,
            "bin_count": 1, "bin_write": 1, "blend_fwd": CACHED_STEPS, "blend_bwd": n, "preprocess_fwd": n, "preprocess_bwd": n,
            "loss_fwd": n, "loss_bwd": n}
    for turn, kind in enumerate(("fresh", "cadence", "cadence", "fresh")):
        m, a = copy_state(model, adam)
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

    m, a = copy_state(model, adam)
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


def drive_preprocess(torch, device, launches, time_entry) -> list[str]:
    """Phase 5b: preprocess_fwd and preprocess_bwd at each of the cells' map
    sizes, checked against the plain version and its autograd VJP, then
    timed beside them (time_entry) with the bound on the bytes each must
    move. Returns the failed checks."""
    from gsdf_slam_tpu_torch.ops import projection
    from gsdf_slam_tpu_torch.probes import checks
    from gsdf_slam_tpu_torch.probes.scene import (
        KITTI_HEIGHT, KITTI_WIDTH, PREPROCESS_SIZES, headline_scene, kitti_camera, preprocess_args,
    )
    from gsdf_slam_tpu_torch.probes.timing import bound_ms

    failed = []
    cam = kitti_camera(device)
    w, h = KITTI_WIDTH, KITTI_HEIGHT
    st = projection.PreprocessSettings(w, h, 3, 1.0, None)
    for tag, p in PREPROCESS_SIZES.items():
        args = preprocess_args(headline_scene(device, n=p))
        means3d, scales, quats, opac, dc, rest = args
        res = checks.preprocess_check(args, cam, st)
        log(f"[preprocess] {tag}: {p} Gaussians at {w}x{h}: {json.dumps(res)}")
        if not res["ok"]:
            failed.append(f"preprocess@{tag}")
        # bytes at SH degree 3 (16 coefficients of 3 floats): the forward
        # reads means, scales, quaternion, opacity and the coefficients and
        # writes 60 bytes of fields; the backward reads the same but the
        # opacity, the 8 floats of cotangent, and writes the gradients of
        # means, scales, quaternion and coefficients
        coeffs = 16 * 3 * 4
        fwd_bytes = p * (12 + 12 + 16 + 4 + coeffs + 60)
        bwd_bytes = p * (12 + 12 + 16 + coeffs + 32 + 12 + 12 + 16 + coeffs)
        pre = projection.preprocess_plain(*args, cam, width=w, height=h, sh_degree=3)
        cts = checks.preprocess_cotangents(pre)
        leaves = [t.clone().requires_grad_(True) for t in (means3d, scales, quats, dc, rest)]
        with torch.enable_grad():
            g_pre = projection.preprocess_plain(leaves[0], leaves[1], leaves[2], opac, leaves[3], leaves[4], cam,
                                                width=w, height=h, sh_degree=3)
        outs = [g_pre.means2d, g_pre.conics, g_pre.colors]
        outs_cts = [cts[0], cts[2], cts[3]]

        def plain_fwd():
            with torch.no_grad():
                projection.preprocess_plain(*args, cam, width=w, height=h, sh_degree=3)

        shapes = f"{p} Gaussians, SH 3, {w}x{h}"
        grad_err = max(e for errs in res["grads"].values() for e in errs.values())
        time_entry("preprocess_fwd", lambda: projection.preprocess_fwd(*args, cam, st), plain_fwd, shapes,
                   launches["preprocess_fwd"], res["colors"], bound_ms(fwd_bytes))
        time_entry("preprocess_bwd",
                   lambda: projection.preprocess_bwd(means3d, scales, quats, dc, rest, cam, st, *cts),
                   lambda: torch.autograd.grad(outs, leaves, outs_cts, retain_graph=True), shapes,
                   launches["preprocess_bwd"], grad_err, bound_ms(bwd_bytes))
        del args, means3d, scales, quats, opac, dc, rest, pre, cts, leaves, g_pre, outs, outs_cts
        torch.cuda.empty_cache()
    return failed


def drive_loss(torch, device, launches, time_entry) -> list[str]:
    """Phase 5c: loss_fwd and loss_bwd at the images the modes train on,
    masked and not, and on the first half of the rows of KITTI's (the
    check's half-batch fault), against the plain version, twice
    (probes/checks.py::loss_check); then each kernel's time at KITTI's
    1226x370 beside the plain version's and its bound on bytes, in turns,
    and the torch-op loss with its autograd backward on CUDA events.
    Returns the failed checks."""
    from gsdf_slam_tpu_torch.ops import losses
    from gsdf_slam_tpu_torch.probes import checks
    from gsdf_slam_tpu_torch.probes.timing import bound_ms, cuda_ms

    failed, results = [], {}
    for w, h in LOSS_SIZES:
        for masked in (False, True):
            res = results[w, h, masked] = checks.loss_check(*checks.loss_inputs(w, h, masked, device))
            log(f"[loss] {w}x{h}{' masked' if masked else ''}: {json.dumps(res)}")
            if not res["ok"]:
                failed.append(f"loss@{w}x{h}{'/masked' if masked else ''}")
    for masked in (False, True):
        r, g, m = checks.loss_inputs(KITTI_W, KITTI_H, masked, device, seed=1)
        half = KITTI_H // 2
        res = checks.loss_check(r[:half], g[:half], None if m is None else m[:half])
        log(f"[loss] rows 0-{half} of {KITTI_W}x{KITTI_H}{' masked' if masked else ''}: {json.dumps(res)}")
        if not res["ok"]:
            failed.append(f"loss@row-slice{'/masked' if masked else ''}")
    r, g, _ = checks.loss_inputs(KITTI_W, KITTI_H, False, device)
    res = results[KITTI_W, KITTI_H, False]
    one = torch.ones((), device=device)
    _, dmaps = losses.loss_fwd(r, g, None, 0.2)
    image_bytes = KITTI_W * KITTI_H * 3 * 4
    shapes = f"{KITTI_W}x{KITTI_H}x3 float32, no mask"
    # forward: the two images read, the three derivative maps written;
    # backward: the maps and the two images read, the gradient written
    time_entry("loss_fwd", lambda: losses.loss_fwd(r, g, None, 0.2),
               lambda: losses.mapper_loss_plain(r, g, None, 0.2), shapes, launches["loss_fwd"], res["loss_err"],
               bound_ms(5 * image_bytes))
    time_entry("loss_bwd", lambda: losses.loss_bwd(r, g, None, 0.2, dmaps, one),
               lambda: losses.mapper_loss_grad_plain(r, g, None, 0.2, one), shapes, launches["loss_bwd"],
               res["grad_err"], bound_ms(6 * image_bytes))
    leaf = r.detach().clone().requires_grad_(True)

    def torch_ops():
        torch.autograd.grad(losses.mapper_loss_plain(leaf, g, None, 0.2), leaf)

    log(f"[loss] the torch-op loss and its autograd backward (the former step's): {cuda_ms(torch_ops, 3):.4f} ms "
        f"on CUDA events at {shapes}")
    return failed


def drive_binning(torch, device, launches, time_entry) -> list[str]:
    """Phase 5d: the binning at the headline (400k Gaussians at 1200x680)
    and the cells' loads (probes/scene.py::street_scene: 0.63M and 2.0M
    Gaussians at KITTI's 1226x370, binning about the 5.4M and 7.5M pre-cull
    pairs of the polish's and the drive's steps): the card's route against
    the plain route and each pass against its plain version, bit-equal
    (probes/checks.py::binning_check); then `bin_count` and `bin_write`
    timed beside their plain versions with their bounds on bytes and the
    check's largest difference (time_entry); the card's route's device time
    without its read-back (graph ms) beside torch.sort of the plain route's
    64-bit keys, the Gaussians' 32-bit depth keys and the pairs' tile ids;
    and
    each route whole, read-backs included, on CUDA events. Returns the
    failed checks."""
    from gsdf_slam_tpu_torch.ops import binning, preprocess, tile_grid
    from gsdf_slam_tpu_torch.probes import checks
    from gsdf_slam_tpu_torch.probes.scene import (
        HEIGHT, KITTI_HEIGHT, KITTI_WIDTH, N_HEADLINE, STREET_SIZES, WIDTH, headline_camera, headline_scene,
        kitti_camera, preprocess_args, street_scene,
    )
    from gsdf_slam_tpu_torch.probes.timing import bound_ms, cuda_ms, graph_ms

    failed = []
    sizes = {"headline": (N_HEADLINE, WIDTH, HEIGHT, headline_camera(device), None),
             **{tag: (n, KITTI_WIDTH, KITTI_HEIGHT, kitti_camera(device), mult)
                for tag, (n, _, mult) in STREET_SIZES.items()}}
    for tag, (n, w, h, cam, mult) in sizes.items():
        args = preprocess_args(headline_scene(device, n=n)) if mult is None else street_scene(device, n, mult)
        with torch.no_grad():
            pre = preprocess(*args, cam, width=w, height=h, sh_degree=3)
        gw, gh = tile_grid(w, h)
        a = (pre.depths, pre.rect_min, pre.rect_max, pre.tiles_touched, pre.means2d, pre.conics, args[3],
             pre.colors)
        res = checks.binning_check(*a, grid_w=gw, grid_h=gh)
        log(f"[binning] {tag}: {n} Gaussians at {w}x{h}: {json.dumps(res)}")
        if not res["ok"]:
            failed.append(f"binning@{tag}")
        perm = binning.depth_order(pre.depths)
        log_op = torch.log(args[3] * 255.0)
        gauss = (perm, pre.tiles_touched, pre.rect_min, pre.rect_max, pre.means2d, pre.conics, log_op)
        counts, totals = binning.bin_count(*gauss, grid_w=gw)
        warp_end = torch.cumsum(counts, 0)
        kept, total = totals.tolist()
        tiles, pair_gid = binning.bin_write(*gauss, warp_end, kept, grid_w=gw)
        table = binning.payload_table(pre.means2d, pre.conics, args[3], pre.colors)
        sorted_keys, order = binning.expand_and_sort(*a[:7], grid_w=gw)[:2]
        keys = torch.empty_like(sorted_keys)
        keys[order] = sorted_keys  # the plain route's keys before its sort
        depth_keys = pre.depths.view(torch.int32) ^ torch.iinfo(torch.int32).min
        st_tiles, st_order = torch.sort(tiles, stable=True)
        visible = int((pre.tiles_touched > 0).sum())
        # a pass reads perm and tiles_touched of every Gaussian and rect_min,
        # rect_max's x, the mean, conic and log_op of the visible ones (36
        # bytes); bin_count writes its counts and totals, bin_write reads
        # the warp scan and writes a tile id and a Gaussian a kept pair
        reads = 12 * n + 36 * visible
        bounds = {"bin_count": bound_ms(reads + 4 * (n // 32) + 16),
                  "bin_write": bound_ms(reads + 8 * (n // 32) + 8 * kept)}

        def route_device():  # the card's route with its read-back's result known
            p = binning.depth_order(pre.depths)
            lo = torch.log(args[3] * 255.0)
            g = (p, pre.tiles_touched, pre.rect_min, pre.rect_max, pre.means2d, pre.conics, lo)
            c, _ = binning.bin_count(*g, grid_w=gw)
            tl, pg = binning.bin_write(*g, torch.cumsum(c, 0), kept, grid_w=gw)
            st, o = torch.sort(tl, stable=True)
            return binning.tile_ranges_pack(
                st, o, pg, binning.payload_table(pre.means2d, pre.conics, args[3], pre.colors), gw * gh)


        shapes = f"{n} Gaussians ({visible} visible), {total} pairs before the cull, {kept} kept, {gw * gh} tiles"
        time_entry("bin_count", lambda: binning.bin_count(*gauss, grid_w=gw),
                   lambda: binning.bin_count_plain(*gauss, grid_w=gw), shapes, launches["bin_count"],
                   res["count_err"], bounds["bin_count"])
        time_entry("bin_write", lambda: binning.bin_write(*gauss, warp_end, kept, grid_w=gw),
                   lambda: binning.bin_write_plain(*gauss, warp_end, kept, grid_w=gw), shapes,
                   launches["bin_write"], res["write_err"], bounds["bin_write"])
        route = {
            "route_device": graph_ms(route_device),
            "sort64_plain_keys": graph_ms(lambda: torch.sort(keys, stable=True)),
            "sort32_depth_keys": graph_ms(lambda: torch.sort(depth_keys, stable=True)),
            "sort_tile_ids": graph_ms(lambda: torch.sort(tiles, stable=True)),
            "k3": graph_ms(lambda: binning.tile_ranges_pack(st_tiles, st_order, pair_gid, table, gw * gh)),
        }
        turns = [cuda_ms(f, 5) for f in (
            lambda: binning.bin_and_pack_plain(*a, grid_w=gw, grid_h=gh),
            lambda: binning.bin_and_pack_depth_first(*a, grid_w=gw, grid_h=gh),
            lambda: binning.bin_and_pack_depth_first(*a, grid_w=gw, grid_h=gh),
            lambda: binning.bin_and_pack_plain(*a, grid_w=gw, grid_h=gh))]
        route.update(plain_route_events=(turns[0] + turns[3]) / 2, card_route_events=(turns[1] + turns[2]) / 2)
        log(f"[binning] {tag} ms: {json.dumps(route)} (whole routes in turns plain, card, card, plain: "
            f"{[round(v, 4) for v in turns]}) at {shapes}")
        del args, pre, a, gauss, perm, log_op, counts, totals, warp_end, tiles, pair_gid, table, keys, sorted_keys
        del order, depth_keys, st_tiles, st_order
        torch.cuda.empty_cache()
    return failed


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
        st["tiles"], st["order"], st["pair_gid"], st["table"], gw * gh)
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


def run_op(torch, fn):
    """Run fn once under count_syncs: (its result, host ms from the call to
    the device's completion, host syncs, where they were called)."""
    box = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n, where = count_syncs(torch, lambda: box.setdefault("out", fn()))
    return box["out"], (time.perf_counter() - t0) * 1e3, n, where


def drive_densify_cycle(torch, device, smi):
    """Phase 8: one densify cycle at the headline through the port's entry
    points, with every surgery's host ms and syncs. Returns the launch
    counts over the phase and the failed checks."""
    from gsdf_slam_tpu_torch import kernels
    from gsdf_slam_tpu_torch.config import OptimizationParams
    from gsdf_slam_tpu_torch.convert import copy_state
    from gsdf_slam_tpu_torch.engine import Camera, Keyframe, Scene, render_depth_state, render_state, train_step
    from gsdf_slam_tpu_torch.models import AdamState, densify_and_prune, increase_pcd, prune_young, reset_opacity
    from gsdf_slam_tpu_torch.models.gaussian_model import VOXEL_SIZE
    from gsdf_slam_tpu_torch.ops import RasterizeConfig
    from gsdf_slam_tpu_torch.probes import checks
    from gsdf_slam_tpu_torch.probes.scene import HEIGHT, WIDTH, headline_scene

    t_phase = time.perf_counter()
    failed = []
    kernels.reset_launch_counts()
    model = headline_scene(device)
    adam = AdamState.init(model.params())
    rng = np.random.default_rng(8)
    cam = Camera(camera_id=0, fx=600.0, fy=600.0, cx=WIDTH / 2, cy=HEIGHT / 2, width=WIDTH, height=HEIGHT)
    scene = Scene()
    scene.add_camera(cam)
    for fid, (dx, dy) in enumerate(((1, 1), (1, -1), (-1, 1), (-1, -1))):
        t_cw = np.eye(4, dtype=np.float32)
        t_cw[:3, 3] = (-dx * KF_OFFSET, -dy * KF_OFFSET, 0.0)  # camera centre (dx, dy, 0) * offset
        image = rng.uniform(0, 1, (HEIGHT, WIDTH, 3)).astype(np.float32)
        scene.add_keyframe(Keyframe(fid=fid, camera=cam, t_cw=t_cw, image=image))
    _, scene.cameras_extent = scene.nerfpp_norm()
    extent = scene.cameras_extent
    kfs = list(scene.keyframes.values())
    cams = [kf.camera_matrices(device=device) for kf in kfs]
    gts = [torch.from_numpy(kf.image).to(device) for kf in kfs]
    log(f"[densify] scene: {len(kfs)} keyframes at offsets of +-{KF_OFFSET:g} m in x and y around the headline "
        f"camera; nerfpp_norm cameras_extent {extent:.6f} m (spatial_lr_scale)")
    cfg = RasterizeConfig(height=HEIGHT, width=WIDTH)
    opt = OptimizationParams()
    bg = torch.zeros(3, device=device)
    state = {"it": 0}

    def step(kf=None, **kw):
        it = state["it"]
        state["it"] += 1
        kf = it % len(kfs) if kf is None else kf
        return train_step(model, adam, cams[kf], gts[kf], None, bg, it, extent, cfg, opt, **kw)

    def steps(kind, n, kf=None, **kw):
        out, ms = [], []
        for _ in range(n):
            before = model.count
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            m = step(kf, **kw)
            ev[1].record()
            torch.cuda.synchronize()
            out.append(m)
            ms.append(ev[0].elapsed_time(ev[1]))
            log(f"[densify] {kind} step at iteration {state['it'] - 1}: count {before} -> {model.count}, loss "
                f"{float(m.loss):.6f}, {ms[-1]:.3f} ms on CUDA events")
            if not math.isfinite(float(m.loss)):
                failed.append(f"densify:{kind}-loss-not-finite")
        return out, ms

    def export_cache():  # keyframe 0's view
        with torch.no_grad():
            return render_state(model, cams[0], bg, cfg, export_binning_cache=True).binning_cache

    ops = {}
    _, ms_before = steps("fresh", CYCLE_STEPS)
    cache_pre = export_cache()  # built before any surgery

    # the densify: clone, split, prune; each branch must fire
    n0 = model.count
    grads = torch.where(model.denom > 0, model.xyz_grad_accum / model.denom, 0.0)
    max_scale = model.scaling_act().detach().amax(1)
    small = max_scale <= DENSIFY["percent_dense"] * extent
    max_grad = DENSIFY["max_grad"]
    sel = lambda g: (int((small & (grads >= g)).sum()), int((~small & (grads >= g)).sum()))
    n_clone, n_split = sel(max_grad)
    seen = model.denom > 0  # in view in some step
    p90 = float(torch.quantile(grads[seen], 0.9))
    half_offset = 1.1 * math.hypot(0.5, 0.5)  # cameras_extent of keyframes at +-0.5 m
    tiny = max_scale <= DENSIFY["percent_dense"] * half_offset
    log(f"[densify] at max_grad {max_grad:g}: clone selects {n_clone}, split {n_split}; 90th percentile of the "
        f"mean gradient of the {int(seen.sum())} rows in view {p90:.6g}; {int(small.sum())} rows "
        f"small enough to clone (max scale <= {DENSIFY['percent_dense'] * extent:.6g} m), "
        f"{int((small & seen).sum())} of them in view; at +-0.5 m (extent {half_offset:.6f} m) {int(tiny.sum())} "
        f"rows, {int((tiny & seen).sum())} of them in view of these keyframes")
    if n_clone == 0 or n_split == 0:
        max_grad = p90
        log(f"[densify] a branch selects no row at 0.0002: max_grad {max_grad:.6g} (the 90th percentile), clone "
            f"selects {sel(max_grad)[0]}, split {sel(max_grad)[1]}")
    if min(sel(max_grad)) == 0:
        # the largest mean gradient among the rows each branch may take: the
        # least threshold at which both fire
        tops = (float(grads[small].max()) if bool(small.any()) else 0.0,
                float(grads[~small].max()) if bool((~small).any()) else 0.0)
        if min(tops) > 0.0:
            max_grad = min(p90, *tops)
        log(f"[densify] a branch still selects no row: largest mean gradient of the rows small enough to clone "
            f"{tops[0]:.6g}, of the others {tops[1]:.6g}; max_grad {max_grad:.6g}, clone selects "
            f"{sel(max_grad)[0]}, split {sel(max_grad)[1]}")
    kw = dict(DENSIFY, max_grad=max_grad, extent=extent)
    noise = torch.randn((2, n0, 3), generator=torch.Generator(device=device).manual_seed(9), device=device)
    cpu_model, cpu_adam = copy_state(model, adam, "cpu")
    before_xyz = cpu_model.xyz.detach().clone()
    counts, ms, n_sync, where = run_op(torch, lambda: densify_and_prune(model, adam, **kw, noise=noise))
    ops["densify_and_prune"] = (ms, n_sync, where, n0, model.count)
    t0 = time.perf_counter()
    cpu_counts = densify_and_prune(cpu_model, cpu_adam, **kw, noise=noise.cpu())
    cpu_ms = (time.perf_counter() - t0) * 1e3
    children = checks.split_children(model.xyz, before_xyz)
    res = checks.surgery_check(model, adam, cpu_model, cpu_adam, children)
    log(f"[densify] densify_and_prune: cloned {counts.cloned}, split {counts.split} (x2 children), pruned "
        f"{counts.pruned}; count {n0} -> {model.count}; the CPU copy {cpu_counts} -> {cpu_model.count} in "
        f"{cpu_ms:.1f} ms")
    log(f"[densify] card against the CPU: rows {res['counts']}; not bit-equal: {res['not_equal'] or 'none'}; "
        f"split children {res['computed']}: xyz scaled err {res['errs'].get('xyz', 0.0):.3g} ("
        f"{res['rows_differ'].get('xyz', 0)} rows not bit-equal), scaling scaled err "
        f"{res['errs'].get('scaling', 0.0):.3g} ({res['rows_differ'].get('scaling', 0)} rows not bit-equal); "
        f"bar {checks.SURGERY_RTOL:g} of the largest magnitude")
    if min(counts) == 0:
        failed.append(f"densify:branch-did-not-fire-{counts}")
    if tuple(counts) != tuple(cpu_counts) or not res["ok"]:
        failed.append("densify:card-differs-from-cpu")
    del cpu_model, cpu_adam

    # the depth render through K1 against the plain blend
    (depth, cov), ms, n_sync, where = run_op(torch, lambda: render_depth_state(model, cams[0], cfg))
    ops["render_depth_state"] = (ms, n_sync, where, model.count, model.count)
    d = checks.depth_check(model, cams[0], cfg, depth, cov)
    log(f"[densify] render_depth_state through K3 and K1 against the plain blend: blended depth err "
        f"{d['accum']:.3g} of max |z| {d['z_max']:.4f}, coverage err {d['coverage']:.3g}, depth err where "
        f"covered {d['depth']:.3g} of max |z| (bars {K1_HEADLINE:g}, {K1_HEADLINE:g}, {4 * K1_HEADLINE:g}); "
        f"covered pixels (coverage > 0.5) {d['covered']} of {WIDTH * HEIGHT}")
    if not (d["accum"] <= K1_HEADLINE and d["coverage"] <= K1_HEADLINE and d["depth"] <= 4 * K1_HEADLINE):
        failed.append("densify:depth-render-differs-from-plain")
    if d["covered"] == 0:
        failed.append("densify:depth-covers-nothing")

    # the ingest: existing centres jittered under a tenth of a voxel, and
    # points in the headline frustum at depths 2-10 m
    half = INGEST_POINTS // 2
    xyz = model.xyz.detach().cpu().numpy()
    near = xyz[rng.integers(0, len(xyz), half)] + rng.uniform(-VOXEL_SIZE / 10, VOXEL_SIZE / 10, (half, 3))
    z = rng.uniform(2.0, 10.0, INGEST_POINTS - half)
    u, v = rng.uniform(0, WIDTH, len(z)), rng.uniform(0, HEIGHT, len(z))
    far = np.stack([(u - WIDTH / 2) / 600.0 * z, (v - HEIGHT / 2) / 600.0 * z, z], -1)
    pts = np.concatenate([near, far]).astype(np.float32)
    cols = rng.uniform(0, 1, (INGEST_POINTS, 3)).astype(np.float32)
    n1, it_ingest = model.count, state["it"]
    kept, ms, n_sync, where = run_op(torch, lambda: increase_pcd(model, adam, pts, cols, iteration=it_ingest))
    ops["increase_pcd"] = (ms, n_sync, where, n1, model.count)
    log(f"[densify] increase_pcd of {INGEST_POINTS} points at iteration {it_ingest}: kept {kept}, deduped "
        f"{INGEST_POINTS - kept}; count {n1} -> {model.count}")
    if not (0 < kept < INGEST_POINTS and model.count == n1 + kept):
        failed.append(f"densify:increase_pcd-kept-{kept}")

    # reset_opacity keeps the count: a cache built just before it must raise
    cache_reset = export_cache()
    n2 = model.count
    _, ms, n_sync, where = run_op(torch, lambda: reset_opacity(model, adam))
    ops["reset_opacity"] = (ms, n_sync, where, n2, model.count)
    op_max = float(model.opacity_act().detach().max())
    try:
        step(0, binning_cache=cache_reset)
        failed.append("densify:stale-cache-after-reset-accepted")
        log("[densify] a cache built before reset_opacity was accepted after it")
    except ValueError as e:
        log(f"[densify] reset_opacity: count {n2} -> {model.count}, max opacity {op_max:.6f}; a cache built "
            f"before it raises: {e}")
        state["it"] -= 1
        if "generation" not in str(e) or model.count != n2:
            failed.append("densify:stale-cache-after-reset-not-caught-by-its-generation")

    # prune_young at an iteration that makes the ingested rows young
    n3 = model.count
    it_young = it_ingest + STABLE_NUM_ITER - 1
    dropped, ms, n_sync, where = run_op(torch, lambda: prune_young(model, adam, it_young, STABLE_NUM_ITER))
    ops["prune_young"] = (ms, n_sync, where, n3, model.count)
    log(f"[densify] prune_young at iteration {it_young}, stable_num_iter {STABLE_NUM_ITER}: dropped {dropped}; "
        f"count {n3} -> {model.count}")
    if dropped != kept:
        failed.append(f"densify:prune_young-dropped-{dropped}-not-the-{kept}-ingested")
    try:
        step(0, binning_cache=cache_pre)
        failed.append("densify:pre-surgery-cache-accepted")
        log("[densify] the pre-surgery cache was accepted")
    except ValueError as e:
        log(f"[densify] the cache built before the densify ({cache_pre.num_gaussians} Gaussians, generation "
            f"{cache_pre.generation}; now {model.count}, generation {model.generation}) raises: {e}")
        state["it"] -= 1

    # train on at the new count: fresh steps, then the cadence on one view
    _, ms_after = steps("fresh", 3)
    m, cache = step(0, export_binning_cache=True)
    log(f"[densify] export step on keyframe 0: count {model.count}, loss {float(m.loss):.6f}, cache of "
        f"{cache.gid.shape[0]} pairs at generation {cache.generation}")
    if not math.isfinite(float(m.loss)):
        failed.append("densify:export-loss-not-finite")
    steps("cached", 3, 0, binning_cache=cache)
    if not all(bool(torch.isfinite(p).all()) for p in model.params().values()):
        failed.append("densify:parameters-not-finite")

    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    for name, (ms, n_sync, where, a, b) in ops.items():
        log(f"[densify] {name}: {ms:.2f} ms on the host clock (call to device completion), {n_sync} host syncs "
            f"at {where}; count {a} -> {b}; on {smi}")
    med = lambda v: float(np.median(v))
    log(f"[densify] fresh step median before the cycle {med(ms_before):.3f} ms ({n0} Gaussians, {CYCLE_STEPS} "
        f"steps), after {med(ms_after):.3f} ms ({model.count} Gaussians, 3 steps), CUDA events, on {smi}")
    log(f"[densify] launches over phase 8: {launches}")
    for name in ("tile_ranges_pack", "blend_fwd", "blend_bwd", "blend_fwd_export"):
        if launches[name] == 0:
            failed.append(f"densify:{name}-not-launched")
    log(f"[densify] phase 8 wall time {time.perf_counter() - t_phase:.1f} s")
    return launches, failed


def drive_streaming(torch, device, smi):
    """Phase 9: the data plane and the mapper's streaming loop on the card.
    Returns the failed checks."""
    from gsdf_slam_tpu_torch import kernels, stream
    from gsdf_slam_tpu_torch.data import CameraIntrinsics, colorize_frame
    from gsdf_slam_tpu_torch.engine import GaussianMapper, MapperSettings
    from gsdf_slam_tpu_torch.ops.colorize import colorize_pointcloud
    from gsdf_slam_tpu_torch.probes import checks
    from gsdf_slam_tpu_torch.probes.synthetic_outdoor import (
        drive_pose, kitti_calibration, lidar_scan, raycast_outdoor,
    )
    from gsdf_slam_tpu_torch.probes.synthetic_room import make_sequence

    t_phase = time.perf_counter()
    failed = []
    path_kernels = ("tile_ranges_pack", "blend_fwd", "blend_bwd", "blend_fwd_export", "preprocess_fwd",
                    "preprocess_bwd", "loss_fwd", "loss_bwd", "bin_count", "bin_write")
    proj, tr = kitti_calibration(KITTI_W, KITTI_H)

    def frame_inputs(i):
        pose = drive_pose(2.0 * i, sway=0.3 * np.sin(0.4 * i))
        image, _ = raycast_outdoor(pose, KITTI_W, KITTI_H)
        return pose, image, lidar_scan(pose, SCAN_POINTS, seed=i), (pose.astype(np.float64) @ tr).astype(np.float32)

    # ---- 9a. the colouriser at KITTI's shapes, card against CPU
    pose, image, scan, lidar_pose = frame_inputs(3)
    got = colorize_pointcloud(scan, image, proj, tr, lidar_pose, device=device)
    want = colorize_pointcloud(scan, image, proj, tr, lidar_pose, device="cpu")
    res = checks.colorize_check(got, want)
    log(f"[stream] 9a colorize_pointcloud of {res['n']} points ({KITTI_W}x{KITTI_H} image) on the card against "
        f"the CPU: valid {res['valid']}, masks equal {res['valid_equal']}, points bit-equal "
        f"{res['points_bit_equal']} (max err {res['points_err']:.3g}), colours bit-equal {res['colors_bit_equal']} "
        f"({res['moved_pixels']} points on another pixel, max err {res['colors_err']:.3g})")
    if not res["ok"]:
        failed.append("stream:colorize-differs-from-cpu")
    ms = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fr = colorize_frame(image, scan, proj, tr, pose, lidar_pose, device)
        ms.append((time.perf_counter() - t0) * 1e3)
    n_sync, where = count_syncs(torch, lambda: colorize_frame(image, scan, proj, tr, pose, lidar_pose, device))
    log(f"[stream] 9a colorize_frame: median {float(np.median(ms[1:])):.3f} ms on the host clock (5 calls after "
        f"one warm-up, call to the compacted points on the host; runs {[round(v, 3) for v in ms]}), {n_sync} host "
        f"syncs at {where}, {len(fr.points)} points kept; on {smi}")

    # ---- 9b. a KITTI-mode stream: colourise, ingest, train once a frame
    here = os.path.dirname(os.path.abspath(__file__))
    settings = MapperSettings.from_yaml(os.path.join(here, "gsdf_slam_tpu_torch", "cfg", "kitti.yaml"))
    fx = 0.5 * KITTI_W  # raycast_outdoor's pinhole: 90 degrees across
    intr = CameraIntrinsics(fx=fx, fy=fx, cx=(KITTI_W - 1) / 2.0, cy=(KITTI_H - 1) / 2.0, width=KITTI_W,
                            height=KITTI_H)
    mapper = GaussianMapper(settings=settings, device=device)
    col_ms, data_ms, losses, streamed, syncs = [], 0.0, [], [], {}
    kernels.reset_launch_counts()
    t_stream = time.perf_counter()
    for i in range(KITTI_FRAMES):
        t0 = time.perf_counter()
        pose, image, scan, lidar_pose = frame_inputs(i)
        data_ms += (time.perf_counter() - t0) * 1e3
        box = {}

        def ingest():
            t0 = time.perf_counter()
            box["fr"] = colorize_frame(image, scan, proj, tr, pose, lidar_pose, device)
            col_ms.append((time.perf_counter() - t0) * 1e3)
            mapper.ingest_frame(i, box["fr"], intrinsics=intr)

        if i == SYNC_FRAME:
            syncs["ingest"] = count_syncs(torch, ingest)
            syncs["step"] = count_syncs(torch, lambda: box.setdefault("out", mapper.train_for_one_iteration()))
            out = box["out"]
        else:
            ingest()
            out = mapper.train_for_one_iteration()
        losses.append(out["loss"])
        streamed.append(mapper.last_binning)
    polish = []
    for _ in range(POLISH_ITERS):
        losses.append(mapper.train_for_one_iteration()["loss"])
        polish.append(mapper.last_binning)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_stream
    launches = {k: kernels.LAUNCHES[k] for k in path_kernels}
    count = lambda seq: {k: seq.count(k) for k in ("fresh", "export", "cached")}
    log(f"[stream] 9b KITTI mode ({KITTI_W}x{KITTI_H}, cfg/kitti.yaml: densify_until_iter "
        f"{settings.opt.densify_until_iter}, rebin_interval_after_densify {settings.rebin_interval_after_densify}): "
        f"{KITTI_FRAMES} frames, then {POLISH_ITERS} polish iterations; steps while streaming {count(streamed)} "
        f"({streamed}), polish {count(polish)}; export from iteration 3 on in every streamed step: "
        f"{all(b == 'export' for b in streamed[2:])}")
    log(f"[stream] 9b launches over the stream: {launches}; Gaussians at the end {mapper.model.count}; losses "
        f"first {losses[0]:.6f}, after the frames {losses[KITTI_FRAMES - 1]:.6f}, last {losses[-1]:.6f}")
    log(f"[stream] 9b host ms per phase: {json.dumps(mapper.timer.summary())}; colorize_frame total "
        f"{sum(col_ms):.1f} ms (mean {float(np.mean(col_ms)):.3f}); the frames' raycasts and scans (numpy) "
        f"{data_ms:.1f} ms; wall {wall:.2f} s; on {smi}")
    log(f"[stream] 9b host syncs at frame {SYNC_FRAME}: colorize_frame + ingest_frame {syncs['ingest'][0]} at "
        f"{syncs['ingest'][1]}; train_for_one_iteration ({streamed[SYNC_FRAME]} step) {syncs['step'][0]} at "
        f"{syncs['step'][1]}")
    steps = count(streamed + polish)
    if not all(math.isfinite(v) for v in losses):
        failed.append("stream:kitti-loss-not-finite")
    if (launches["tile_ranges_pack"] != steps["fresh"] + steps["export"]
            or not launches["bin_count"] == launches["bin_write"] == launches["tile_ranges_pack"]
            or launches["blend_fwd_export"] != steps["export"]
            or launches["blend_fwd"] != steps["fresh"] + steps["cached"]
            or launches["blend_bwd"] != len(streamed + polish)
            or launches["preprocess_fwd"] != len(streamed + polish)
            or launches["preprocess_bwd"] != len(streamed + polish)
            or launches["loss_fwd"] != len(streamed + polish) or launches["loss_bwd"] != len(streamed + polish)):
        failed.append("stream:kitti-launches-disagree-with-the-binning")
    failed += [f"stream:kitti-{k}-not-launched" for k in path_kernels if launches[k] == 0]
    del mapper

    # ---- 9c. the room stream at 1200x680 (benchmarks/e2e_stream.py's)
    t0 = time.perf_counter()
    frames = make_sequence(ROOM_FRAMES, ROOM_W, ROOM_H)
    log(f"[stream] 9c {ROOM_FRAMES} room frames at {ROOM_W}x{ROOM_H} raycast (numpy) in "
        f"{time.perf_counter() - t0:.2f} s")
    kernels.reset_launch_counts()
    result, room_steps = stream.run_stream(ROOM_FRAMES, ROOM_W, ROOM_H, device, frames=frames)
    launches = {k: kernels.LAUNCHES[k] for k in path_kernels}
    del frames
    log(f"[stream] 9c gsdf_slam_tpu_torch.stream: {json.dumps(result)}")
    ph = result["phases_ms"]
    knn = ph.get("ingest.knn", {}).get("total_ms", 0.0)
    inc = ph.get("ingest.increase_pcd", {}).get("total_ms", 0.0)
    bp = ph.get("ingest.backproject", {}).get("total_ms", 0.0)
    log(f"[stream] 9c launches over the stream: {launches}; peak device memory {result['peak_device_mb']:.1f} MiB "
        f"(the stream's own, beyond what was allocated when it began); "
        f"ingest split: host 3-NN {knn:.1f} ms of increase_pcd's {inc:.1f} ms ({knn / max(inc, 1e-9):.3f}), the "
        f"rest {inc - knn:.1f} ms, backprojection {bp:.1f} ms, over {ROOM_FRAMES} ingests; on {smi}")
    if not all(math.isfinite(r["loss"]) for r in room_steps):
        failed.append("stream:room-loss-not-finite")
    failed += [f"stream:room-{k}-not-launched" for k in ("tile_ranges_pack", "blend_fwd", "blend_bwd")
               if launches[k] == 0]

    # ---- 9d. the short stream on the card against the CPU
    frames = make_sequence(SHORT_FRAMES, SHORT_SIZE, SHORT_SIZE)
    _, want = stream.run_stream(SHORT_FRAMES, SHORT_SIZE, SHORT_SIZE, "cpu", SHORT_REBIN, frames=frames)
    kernels.reset_launch_counts()
    _, got = stream.run_stream(SHORT_FRAMES, SHORT_SIZE, SHORT_SIZE, device, SHORT_REBIN, frames=frames)
    launches = {k: kernels.LAUNCHES[k] for k in path_kernels}
    res = checks.stream_check(got, want)
    log(f"[stream] 9d {SHORT_FRAMES} frames at {SHORT_SIZE}x{SHORT_SIZE}, rebin {SHORT_REBIN}, card against CPU: "
        f"{res['steps']} steps, keyframes, iterations, counts and binning equal {res['sequence_equal']}, loss err "
        f"{res['loss_err']:.3g} (bar {checks.STREAM_LOSS_ATOL:g}); binning {[r['binning'] for r in got]}; launches "
        f"{launches}")
    if not res["ok"]:
        failed.append("stream:short-stream-card-differs-from-cpu")
    failed += [f"stream:short-{k}-not-launched" for k in path_kernels if launches[k] == 0]
    log(f"[stream] phase 9 wall time {time.perf_counter() - t_phase:.1f} s")
    return failed


def drive_mono(torch, device, smi):
    """Phase 10: the monocular SLAM mode (cfg/tum_mono.yaml, the port's
    copy) on the card. Returns the failed checks."""
    from gsdf_slam_tpu_torch import kernels, stream
    from gsdf_slam_tpu_torch.engine import GaussianMapper, MapperSettings, train_step
    from gsdf_slam_tpu_torch.ops import RasterizeConfig
    from gsdf_slam_tpu_torch.probes import checks, mono
    from gsdf_slam_tpu_torch.probes.synthetic_room import make_sequence

    t_phase = time.perf_counter()
    failed = []
    path_kernels = ("tile_ranges_pack", "blend_fwd", "blend_bwd", "blend_fwd_export", "preprocess_fwd",
                    "preprocess_bwd", "loss_fwd", "loss_bwd", "bin_count", "bin_write")
    settings = mono.mono_settings()
    intr = mono.room_intrinsics(ROOM_W, ROOM_H)

    # ---- 10a. the mono stream at 1200x680: image-only keyframes with
    # tracker points, pose corrections, then polish iterations
    t0 = time.perf_counter()
    frames = make_sequence(MONO_FRAMES, ROOM_W, ROOM_H)
    tracker = [mono.tracker_points(p, rgb, d, TRACKER_POINTS, seed=i) for i, (p, rgb, d) in enumerate(frames)]
    log(f"[mono] 10a {MONO_FRAMES} room frames at {ROOM_W}x{ROOM_H} and {TRACKER_POINTS} tracker points each "
        f"(numpy) in {time.perf_counter() - t0:.2f} s")
    kernels.library()
    mapper = GaussianMapper(settings=settings, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    losses, syncs, small, large, box = [], {}, [], {}, {}
    t_stream = time.perf_counter()
    for i, (pose, rgb, _) in enumerate(frames):
        pts, cols = tracker[i]
        feed = lambda: mapper.feed_keyframe(i, pose, rgb, points=pts, colors=cols, intrinsics=intr)
        if i in MONO_SYNC_FRAMES:
            syncs[f"feed_keyframe {i}"] = count_syncs(torch, feed)
        else:
            feed()
        if i == LARGE_AT:  # before the step: this keyframe's points are the young ones
            n0 = mapper.model.count
            mapper.update_keyframe_pose(i, mono.corrected_pose(pose, *mono.LARGE_CORRECTION))
            exist = mapper.model.exist_since_iter
            large = {"before": n0, "after": mapper.model.count, "iteration": mapper.iteration,
                     "stable": bool((exist <= mapper.iteration - settings.stable_num_iter_existence).all())}
        if i == MONO_SYNC_FRAMES[0]:
            syncs["train_for_one_iteration"] = count_syncs(
                torch, lambda: box.update(out=mapper.train_for_one_iteration()))
            out = box["out"]
        else:
            out = mapper.train_for_one_iteration()
        losses.append(out["loss"])
        if i and i % SMALL_EVERY == 0:  # after the step: the caches it left
            fid, n0, caches = i - SMALL_BACK, mapper.model.count, sorted(mapper._bin_cache)
            t_wc = np.linalg.inv(mapper.scene.keyframes[fid].t_cw.astype(np.float64))
            mapper.update_keyframe_pose(fid, mono.corrected_pose(t_wc, *mono.SMALL_CORRECTION))
            small.append({"at": i, "fid": fid, "pruned": n0 - mapper.model.count, "caches": len(caches),
                          "caches_ok": sorted(mapper._bin_cache) == [k for k in caches if k[0] != fid]})
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t_stream
    for _ in range(MONO_POLISH):
        losses.append(mapper.train_for_one_iteration()["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_stream
    launches = {k: kernels.LAUNCHES[k] for k in path_kernels}
    renders = mapper.timer.counts["mono.depth_render"]
    steps = len(losses)
    peak_mb = (torch.cuda.max_memory_allocated() - held) / 2**20
    log(f"[mono] 10a mono SLAM stream ({ROOM_W}x{ROOM_H}, cfg/tum_mono.yaml: depth cache "
        f"{settings.max_depth_cached}, pixel distance {settings.inactive_geo_densify_max_pixel_dist:g}, prior "
        f"{settings.monocular_init_depth:g} m, {settings.new_keyframe_times_of_use} uses, stable_num_iter_existence "
        f"{settings.stable_num_iter_existence}, thresholds {settings.large_rotation_threshold:g} deg / "
        f"{settings.large_translation_threshold:g} m; pyramid off): {MONO_FRAMES} keyframes in {stream_s:.2f} s "
        f"({MONO_FRAMES / stream_s:.3f} frames/s), then {MONO_POLISH} polish iterations; {steps} iterations in "
        f"{wall:.2f} s ({steps / wall:.3f} iterations/s over the whole run); on {smi}")
    log(f"[mono] 10a samples by source over the stream: {dict(mapper.mono_sources)}; depth renders {renders}; "
        f"binning {dict(mapper.binning_counts)}; Gaussians at the end {mapper.model.count}; peak device memory "
        f"{peak_mb:.1f} MiB (the stream's own); losses first {losses[0]:.6f}, after the keyframes "
        f"{losses[MONO_FRAMES - 1]:.6f}, last {losses[-1]:.6f}")
    log(f"[mono] 10a host ms per phase: {json.dumps(mapper.timer.summary())}")
    for k, (n, where) in syncs.items():
        log(f"[mono] 10a host syncs of {k}: {n} at {where}")
    log(f"[mono] 10a launches over the stream: {launches} ({steps} steps, {renders} depth renders)")
    log(f"[mono] 10a small corrections ({mono.SMALL_CORRECTION[0]:g} deg, {mono.SMALL_CORRECTION[1]:g} m): {small}")
    log(f"[mono] 10a large correction ({mono.LARGE_CORRECTION[0]:g} deg) of keyframe {LARGE_AT} at iteration "
        f"{large['iteration']}: Gaussians {large['before']} -> {large['after']} ({large['before'] - large['after']} "
        f"pruned); every survivor has exist_since_iter <= iteration - {settings.stable_num_iter_existence}: "
        f"{large['stable']}")
    if not all(math.isfinite(v) for v in losses):
        failed.append("mono:loss-not-finite")
    if any(s["pruned"] or not s["caches_ok"] for s in small):
        failed.append("mono:small-correction-pruned-or-dropped-other-caches")
    if not large["stable"] or large["after"] >= large["before"]:
        failed.append("mono:large-correction-left-young-gaussians")
    n_bin = mapper.binning_counts
    if (launches["blend_bwd"] != steps or launches["tile_ranges_pack"] != n_bin["fresh"] + renders
            or not launches["bin_count"] == launches["bin_write"] == launches["tile_ranges_pack"]
            or launches["blend_fwd"] != n_bin["fresh"] + renders or renders == 0
            or launches["preprocess_bwd"] != steps or launches["loss_fwd"] != steps
            or launches["loss_bwd"] != steps):
        failed.append("mono:launches-disagree-with-the-steps-and-renders")
    failed += [f"mono:{k}-not-launched" for k in path_kernels[:3] if launches[k] == 0]

    # ---- 10b. the checkpoint: save, load on the card and on the CPU
    ck = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke", "mono.npz")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mapper.save_checkpoint(ck)
    save_ms = (time.perf_counter() - t0) * 1e3
    loaded = GaussianMapper(settings=settings, device=device)
    t0 = time.perf_counter()
    loaded.load_checkpoint(ck)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    on_cpu = GaussianMapper(settings=settings, device="cpu")
    on_cpu.load_checkpoint(ck)
    cpu_equal = all(torch.equal(getattr(on_cpu.model, k), getattr(loaded.model, k).detach().cpu())
                    for k in ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation"))
    del on_cpu
    render_equal = []
    for fid in CKPT_RENDER_FIDS:
        kf = mapper.scene.keyframes[fid]
        a, b = (m.render_from_pose(kf.t_cw, ROOM_W, ROOM_H, kf.camera.fovx, kf.camera.fovy) for m in (mapper, loaded))
        render_equal.append(bool(np.array_equal(a, b)))
    kf = mapper.scene.keyframes[MONO_FRAMES - 1]
    gt = mapper._images[("gt", kf.fid, settings.num_gaus_pyramid_sub_levels)]
    bg = torch.zeros(3, device=device)
    cfg = RasterizeConfig(height=ROOM_H, width=ROOM_W, sh_degree=settings.model.sh_degree)
    res = {}
    for name, m in (("saved", mapper), ("loaded", loaded)):
        met = train_step(m.model, m.adam, kf.camera_matrices(settings.z_near, settings.z_far, device=device), gt,
                         None, bg, m.iteration + 1, m.spatial_lr_scale, cfg, settings.opt)
        res[name] = (float(met.loss), {k: p.detach() for k, p in m.model.params().items()})
    loss_err = abs(res["saved"][0] - res["loaded"][0])
    p_err = lr_units_err(res["saved"][1], res["loaded"][1], settings.opt, mapper.spatial_lr_scale)
    log(f"[mono] 10b checkpoint of {mapper.model.count} Gaussians: {os.path.getsize(ck)} bytes, save "
        f"{save_ms:.1f} ms, load on the card {load_ms:.1f} ms; the CPU port's load bit-equal to the card's: "
        f"{cpu_equal}; render_from_pose of keyframes {list(CKPT_RENDER_FIDS)} bit-equal: {render_equal}; one "
        f"train_step on keyframe {kf.fid} from each: loss err {loss_err:.3g} (bar 1e-5), max param err "
        f"{p_err:.3g} lr units (bar 6)")
    if not (cpu_equal and all(render_equal) and loss_err <= 1e-5 and p_err <= 6.0):
        failed.append("mono:checkpoint-does-not-resume")
    del mapper, loaded, gt, tracker

    # ---- 10c. the room stream at pipeline depths 0 and 2, in turns
    for depth in PIPE_DEPTHS:
        kernels.reset_launch_counts()
        result, room_steps = stream.run_stream(MONO_FRAMES, ROOM_W, ROOM_H, device, frames=frames, pipeline=depth)
        log(f"[mono] 10c room stream at pipeline depth {depth}: {result['frames_per_sec']:.3f} frames/s, "
            f"{result['iters_per_sec']:.3f} iterations/s ({result['iterations']} iterations in "
            f"{result['wall_s']:.2f} s), Gaussians {result['gaussians']}, train_step host ms "
            f"{result['phases_ms']['train_step']['total_ms']:.1f}; launches "
            f"{ {k: kernels.LAUNCHES[k] for k in path_kernels[:3]} }; on {smi}")
        if not all(math.isfinite(r["loss"]) for r in room_steps) or len(room_steps) != result["iterations"]:
            failed.append(f"mono:room-stream-depth-{depth}-failed")
    for depth in sorted(set(PIPE_DEPTHS)):
        n, where = count_syncs(torch, lambda: box.update(r=stream.run_stream(
            SYNC_STREAM_FRAMES, ROOM_W, ROOM_H, device, frames=frames[:SYNC_STREAM_FRAMES], pipeline=depth)))
        its = box["r"][0]["iterations"]
        log(f"[mono] 10c host syncs over a {SYNC_STREAM_FRAMES}-frame room stream at pipeline depth {depth}: {n} in "
            f"{its} iterations ({n / its:.2f} a step, ingests included) at {where}")
    del frames

    # ---- 10d. the short mono stream on the card against the CPU
    c = mono.SHORT
    short = make_sequence(c["frames"], c["size"], c["size"])
    want = mono.short_mono_run("cpu", 2, frames=short)
    kernels.reset_launch_counts()
    got = mono.short_mono_run(device, 2, frames=short)
    launches = {k: kernels.LAUNCHES[k] for k in path_kernels}
    sync0 = mono.short_mono_run(device, 0, frames=short)
    res = checks.mono_run_check(got, want)
    depths = checks.stream_check(got["log"], sync0["log"])
    log(f"[mono] 10d {c['frames']} keyframes at {c['size']}x{c['size']} ({c['points']} tracker points each within "
        f"{c['pixel_dist']:g} px, depth cache {c['depth_cache']}, rebin {c['rebin']}, a small and a large "
        f"correction), pipeline depth 2, card against CPU: samples {res['sources']}, tracker and prior samples "
        f"bit-equal and the render's within K1's bar: {res['samples_ok']} (max depth err {res['depth_err']:.3g}); "
        f"{res['frontier']} samples kept on one side only, at the frontier (coverage within "
        f"{checks.FWD_SMALL:g} of 0.5 or depth within the bar of 0.2); counts equal {res['counts_equal']} over "
        f"{res['compared_keyframes']} keyframes; steps {res['steps']}; large correction {got['large']}, small "
        f"correction caches {got['caches_before']} -> {got['caches_after']}")
    log(f"[mono] 10d card at depth 0 against depth 2: {depths}; launches over the depth-2 run {launches}")
    if not res["ok"]:
        failed.append("mono:short-stream-card-differs-from-cpu")
    if not depths["ok"]:
        failed.append("mono:short-stream-depth-0-differs-from-depth-2")
    if got["caches_after"] != [k for k in got["caches_before"] if k[0] != got["small_fid"]] or got["small_pruned"]:
        failed.append("mono:short-small-correction")
    failed += [f"mono:short-{k}-not-launched" for k in path_kernels if launches[k] == 0]
    # image only, no tracker points: the default settings, and the yaml's
    # depth cache of 10, whose first nine steps train an empty map
    image_frames = make_sequence(IMAGE_ONLY_FRAMES, c["size"], c["size"])
    for name, s in (("default settings", MapperSettings()), ("cfg/tum_mono.yaml", settings)):
        want = mono.image_only_run("cpu", s, image_frames)
        got = mono.image_only_run(device, s, image_frames)
        res = checks.stream_check(got["log"], want["log"])
        log(f"[mono] 10d image only, {name} (depth cache {s.max_depth_cached}), {IMAGE_ONLY_FRAMES} keyframes at "
            f"{c['size']}x{c['size']}, card against CPU: counts after each feed {got['counts']} (equal "
            f"{got['counts'] == want['counts']}); steps {res}; samples {dict(got['mapper'].mono_sources)}")
        if not res["ok"] or got["counts"] != want["counts"] or got["counts"][-1] == 0:
            failed.append(f"mono:image-only-{s.max_depth_cached}-card-differs-from-cpu")
    log(f"[mono] phase 10 wall time {time.perf_counter() - t_phase:.1f} s")
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
    for name in ("tile_ranges_pack", "blend_fwd", "blend_bwd", "preprocess_fwd", "preprocess_bwd", "loss_fwd",
                 "loss_bwd", "bin_count", "bin_write"):
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
    a3 = (st["tiles"], st["order"], st["pair_gid"], st["table"], num_tiles)
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
        "tile_ranges_pack": bound_ms(14 * pairs_live + st["table"].numel() * 4  # tiles, order, pair_gid, table
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
        entries.append(dict(name=name, route="cuda", **KERNELS[name], shapes=shapes, launches=count,
                            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                            library_ms=lib_ms))

    for name, (kern, plain) in timings.items():
        time_entry(name, kern, plain, f"{pairs_live} pairs, {num_tiles} tiles", launches[name], head_err[name],
                   bounds[name])
    k1_fn, k4_fn = timings["blend_fwd"][0], timings["blend_fwd_export"][0]
    turns = [graph_ms(f) for f in (k1_fn, k4_fn, k4_fn, k1_fn)]
    k4_over_k1 = (turns[1] + turns[2]) / (turns[0] + turns[3])
    log(f"[time] K4/K1 in turns (K1, K4, K4, K1: {', '.join(f'{v:.4f}' for v in turns)} ms graph): "
        f"{k4_over_k1:.4f}, against the walk ratio {walk_ratio:.4f} in warp-steps "
        f"({walked4 / walked1:.4f} in pixel-pairs) on {smi}")

    # ---- 5b. the preprocess kernels at the cells' map sizes
    failed += drive_preprocess(torch, device, launches, time_entry)
    # ---- 5c. the loss kernels at the cells' and the modes' image sizes
    failed += drive_loss(torch, device, launches, time_entry)
    # ---- 5d. the binning's passes and route at the cells' map sizes
    failed += drive_binning(torch, device, launches, time_entry)

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

    # ---- 8. the densify cycle at the headline
    _, f = drive_densify_cycle(torch, device, smi)
    failed += f

    # ---- 9. streaming: the data plane and the mapper's loop
    failed += drive_streaming(torch, device, smi)

    # ---- 10. the monocular SLAM mode
    failed += drive_mono(torch, device, smi)

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
