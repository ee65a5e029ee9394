#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gsdf_slam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device: nvidia-smi's name and power limit, torch and CUDA versions;
2. build: compile the CUDA kernels from gsdf_slam_tpu_torch/csrc/;
3. kernel checks: each kernel (K3 tile_ranges_pack, K1 blend_fwd, K2
   blend_bwd) against its plain PyTorch version on the card, on the small
   test scene (64x64) and on the headline scene (1200x680, 400k Gaussians),
   plus three training steps on the card against three on the CPU;
4. main path: `train_step` at the headline size, 3 warm-up and 10 timed
   steps, with every kernel's launch count taken over exactly these steps;
   then 3 steps under torch.profiler for the device's busy and idle share
   and the kernels that take the device time;
5. kernel times: each kernel and its plain version at the headline shapes.

The next-to-last line is a JSON object with one entry per kernel; the last
is {"ok": true, "device": {...}}, printed only when every phase passed.
The script exits non-zero, printing no result, without a CUDA device or
when the package is not beside it (the script copied out of the repo).
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

WIDTH, HEIGHT = 1200, 680
N_HEADLINE = 400_000
# pair-count calibration of the converged scene (bench.py CALIB
# "1200x680/400000"): the scale multiplier that bins ~2.5 pairs per Gaussian
SCALE_MULT = 2.59368
WARMUP, TIMED = 3, 10

# Bounds, each with its reason (PERF.md "Kernel checks").
# K3 moves integers and copies floats: bit-equal.
# K1 small: the images bar of tests/test_pallas_blend.py.
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
}


def log(msg: str) -> None:
    print(msg, flush=True)


def headline_scene(torch, device, n=N_HEADLINE, seed=0):
    """bench.py::build_scene(converged=True) as a numpy + scipy recipe:
    Gaussians on the walls of an 8 m box seen from its centre, opacity 0.5,
    scales from the exact 3-NN times the pair-count calibration."""
    from gsdf_slam_tpu_torch.models import GaussianModel

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    ax = rng.integers(0, 3, n)
    sign = rng.choice([-4.0, 4.0], n)
    pts[np.arange(n), ax] = sign
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    model = GaussianModel.create_from_pcd(pts, cols, device=device)
    with torch.no_grad():
        model.opacity.zero_()  # inverse_sigmoid(0.5)
        model.scaling.add_(float(np.float32(np.log(SCALE_MULT))))
    return model


def headline_camera(device):
    from gsdf_slam_tpu_torch.ops import CameraMatrices

    fovx = 2 * np.arctan(WIDTH / (2 * 600.0))
    fovy = 2 * np.arctan(HEIGHT / (2 * 600.0))
    return CameraMatrices.from_pose(np.array([1.0, 0, 0, 0]), np.zeros(3), fovx, fovy, device=device)


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


def check_kernels(torch, name, st, k1_bound, k2_bound):
    """Each kernel against its plain version on the same inputs."""
    from gsdf_slam_tpu_torch.ops import binning, blend, tile_blend

    num_tiles = st["gw"] * st["gh"]
    args3 = (st["keys"], st["order"], st["pair_gid"], st["table"], num_tiles)
    r_k, g_k, p_k = binning.tile_ranges_pack(*args3)
    r_p, g_p, p_p = binning.tile_ranges_pack_plain(*args3)
    torch.cuda.synchronize()
    k3_ok = torch.equal(r_k, r_p) and torch.equal(g_k, g_p) and torch.equal(p_k, p_p)
    k3_err = float((p_k - p_p).abs().max()) if p_k.numel() else 0.0
    log(f"[check {name}] pairs={p_k.shape[1]} (pre-cull {st['total']}) "
        f"K3 ranges/gid/payload bit-equal={k3_ok} max_abs_err={k3_err:.3g}")

    acc_k, lte_k, nc_k = tile_blend.blend_fwd(r_k, p_k, st["gw"], st["gh"])
    acc_p, lte_p, nc_p = blend.blend_fwd_plain(r_k, p_k, st["gw"], st["gh"])
    torch.cuda.synchronize()
    acc_err = float((acc_k - acc_p).abs().max())
    t_err = float((torch.exp(lte_k) - torch.exp(lte_p)).abs().max())
    lte_err = float((lte_k - lte_p).abs().max())
    over = int(((acc_k - acc_p).abs().amax(-1) > K1_SMALL).sum())
    nc_diff = int((nc_k != nc_p).sum())
    k1_err = max(acc_err, t_err)
    log(f"[check {name}] K1 accum max_abs_err={acc_err:.3g} final_T max_abs_err={t_err:.3g} "
        f"log_t_eff max_abs_err={lte_err:.3g} pixels>{K1_SMALL:g}={over} "
        f"n_contrib mismatches={nc_diff} bound={k1_bound:g}")

    ct_a, ct_t = cotangents(torch, st, acc_p, lte_p)
    bargs = (r_k, p_k, g_k, lte_p, nc_p, ct_a, ct_t, st["p"], st["gw"], st["gh"])
    g_kern = tile_blend.blend_bwd(*bargs)
    g_plain = blend.blend_bwd_plain(*bargs)
    # dL/dalpha = T (c . ct_accum) - (suffix + ct_eff) / (1 - alpha): the
    # plain gradients with either cotangent zeroed show how far a K2 that
    # lost that term would land, which must be beyond the bound
    g_no_eff = blend.blend_bwd_plain(*bargs[:6], torch.zeros_like(ct_t), *bargs[7:])
    g_no_col = blend.blend_bwd_plain(*bargs[:5], torch.zeros_like(ct_a), *bargs[6:])
    torch.cuda.synchronize()

    def scaled_err(g, fields=("means2d", "conics", "opacity", "colors")):
        errs = {}
        for field, sl in (("means2d", slice(0, 2)), ("conics", slice(2, 5)),
                          ("opacity", slice(5, 6)), ("colors", slice(6, 9))):
            if field in fields:
                scale = max(float(g_plain[:, sl].abs().max()), 1e-12)
                errs[field] = float((g[:, sl] - g_plain[:, sl]).abs().max()) / scale
        return errs

    errs = scaled_err(g_kern)
    k2_err = max(errs.values())
    k2_abs = float((g_kern - g_plain).abs().max())
    # colours take only ct_accum; the geometric fields take both terms
    geometric = ("means2d", "conics", "opacity")
    eff_weight = max(scaled_err(g_no_eff, geometric).values())
    col_weight = max(scaled_err(g_no_col, geometric).values())
    log(f"[check {name}] K2 scaled errors {' '.join(f'{k}={v:.3g}' for k, v in errs.items())} "
        f"max_abs_err={k2_abs:.3g} bound={k2_bound:g}; ct_log_t_eff max_abs={float(ct_t.abs().max()):.3g}; "
        f"dropping the ct_eff term would move the geometric gradients by {eff_weight:.3g} scaled, "
        f"dropping the colour term by {col_weight:.3g}")

    failed = []
    if not k3_ok:
        failed.append("K3")
    if not k1_err <= k1_bound:
        failed.append("K1")
    if not k2_err <= k2_bound:
        failed.append("K2")
    if not eff_weight > k2_bound:
        failed.append("K2-bound-blind-to-ct_eff")
    if not col_weight > k2_bound:
        failed.append("K2-bound-blind-to-colour-term")
    return dict(tile_ranges_pack=k3_err, blend_fwd=k1_err, blend_bwd=k2_abs), failed


def check_small_training(torch, device):
    """Three train_steps on the card against three on the CPU (plain
    versions), from the same small scene."""
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
        losses = [float(train_step(model, adam, cam, gt, None, bg, i, 1.0, cfg, opt).loss)
                  for i in range(3)]
        results[str(dev)] = (losses, {k: p.detach().cpu() for k, p in model.params().items()})
    (l_cpu, p_cpu), (l_gpu, p_gpu) = results["cpu"], results[str(device)]
    loss_err = max(abs(a - b) for a, b in zip(l_cpu, l_gpu))
    # after step 1 Adam moves each element by about lr * sign(g): a gradient
    # that is float noise around 0 may flip sign, so parameters are held in
    # units of the group's learning rate (at most 3 steps' worth)
    lr = {"xyz": opt.position_lr_init, "f_dc": opt.feature_lr, "f_rest": opt.feature_lr / 20,
          "opacity": opt.opacity_lr, "scaling": opt.scaling_lr, "rotation": opt.rotation_lr}
    p_err = max(float((p_cpu[k] - p_gpu[k]).abs().max()) / lr[k] for k in p_cpu)
    log(f"[check train] losses cpu={l_cpu} gpu={l_gpu} max_loss_err={loss_err:.3g} "
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


def time_cuda(torch, fn, iters):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


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
    from gsdf_slam_tpu_torch.ops import RasterizeConfig, binning, blend, tile_blend

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failed: list[str] = []

    # ---- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
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

    # ---- 3. kernel checks
    args, cam = small_scene(torch, device)
    st_small = stage_inputs(torch, args, cam, 64, 64)
    _, f = check_kernels(torch, "64x64", st_small, K1_SMALL, K2_SMALL)
    failed += [f"{k}@64x64" for k in f]

    t0 = time.perf_counter()
    model = headline_scene(torch, device)
    cam_h = headline_camera(device)
    log(f"[main] headline scene {model.count} Gaussians built in {time.perf_counter() - t0:.2f} s")
    hargs = (model.xyz.detach(), model.scaling_act().detach(), model.rotation_act().detach(),
             model.opacity_act()[:, 0].detach(), model.f_dc.detach(), model.f_rest.detach())
    st_head = stage_inputs(torch, hargs, cam_h, WIDTH, HEIGHT)
    head_err, f = check_kernels(torch, f"{WIDTH}x{HEIGHT}", st_head, K1_HEADLINE, K2_HEADLINE)
    failed += [f"{k}@headline" for k in f]
    torch.cuda.synchronize()

    if not check_small_training(torch, device):
        failed.append("train@64x64")
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
    for name, n in launches.items():
        if n < WARMUP + TIMED:
            failed.append(f"main:{name}-launched-{n}")

    dev_ms, wall_ms, table = profile_steps(
        torch, lambda it: train_step(model, adam, cam_h, gt, None, bg, it, 1.0, cfg, opt)
    )
    log(f"[main] profiled 3 steps: device busy {dev_ms:.3f} ms/step of {wall_ms:.3f} ms wall "
        f"(idle share {1 - dev_ms / wall_ms:.3f}, profiler on); top rows over the 3 steps:")
    for line in table.splitlines():
        log(f"[profile] {line}")

    # ---- 5. kernel times at the headline shapes
    st = st_head
    num_tiles = st["gw"] * st["gh"]
    a3 = (st["keys"], st["order"], st["pair_gid"], st["table"], num_tiles)
    ranges, gid, payload = binning.tile_ranges_pack(*a3)
    acc, lte, nc = tile_blend.blend_fwd(ranges, payload, st["gw"], st["gh"])
    ct_a, ct_t = cotangents(torch, st, acc, lte)
    a2 = (ranges, payload, gid, lte, nc, ct_a, ct_t, st["p"], st["gw"], st["gh"])
    pairs_live = payload.shape[1]
    timings = {
        "tile_ranges_pack": (lambda: binning.tile_ranges_pack(*a3),
                             lambda: binning.tile_ranges_pack_plain(*a3)),
        "blend_fwd": (lambda: tile_blend.blend_fwd(ranges, payload, st["gw"], st["gh"]),
                      lambda: blend.blend_fwd_plain(ranges, payload, st["gw"], st["gh"])),
        "blend_bwd": (lambda: tile_blend.blend_bwd(*a2), lambda: blend.blend_bwd_plain(*a2)),
    }
    entries = []
    for name, (kern, plain) in timings.items():
        p0 = time_cuda(torch, plain, 3)
        k0 = time_cuda(torch, kern, 20)
        k1 = time_cuda(torch, kern, 20)
        p1 = time_cuda(torch, plain, 3)
        ms, plain_ms = (k0 + k1) / 2, (p0 + p1) / 2
        log(f"[time] {name}: kernel {ms:.4f} ms (runs {k0:.4f}, {k1:.4f}), plain {plain_ms:.4f} ms "
            f"(runs {p0:.4f}, {p1:.4f}) at {pairs_live} pairs, {num_tiles} tiles on {smi}")
        entries.append(dict(name=name, route="cuda", **KERNELS[name], launches=launches[name],
                            max_abs_err=head_err[name], ms=ms, plain_ms=plain_ms))

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
