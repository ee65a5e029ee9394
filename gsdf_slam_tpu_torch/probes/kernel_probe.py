"""Isolated timings of the blend kernels on the card.

    python -m gsdf_slam_tpu_torch.probes.kernel_probe [--n N] [--chunk C] [name ...]

Port of benchmarks/kernel_probe.py. It splits the blend's time into
stages by running the port's production kernels and stripped-down probe
kernels on the binning of the headline scene (probes/scene.py: N
Gaussians, default 400,000, at 1200x680). With no names it runs them all:

  null           the timing harness on a one-element add
  fwd, bwd       K1 blend_fwd and K2 blend_bwd (with its fold)
  fwd_floor      staging, barriers and loop only (mode `floor`)
  fwd_nomxu      the carry replaced by stand-ins (mode `nocarry`)
  fwd_novpu      log1p and exp of the carry replaced by arithmetic (`notrans`)
  fwd_noterm     production math, no exit (`noexit`)
  fwd_opt,       production math with the TPU's chunk-granular exit
  fwd_roll         (`chunk_exit`; one mode, as both compute the production
                   function at one tile per block)
  fwd_unroll2    two chunks per iteration from a 4-deep cp.async ring
  fwd_pair2      two tiles in lock step per block
  bwd_opt        the backward from the raw log T, per-pair gradients
                 without the fold
  fwd_mixed, fwd_high, bwd_mixed, bwd_high
                 swap the MXU pass precision of the TPU kernels' one-hot
                 contractions; K1 and K2 contract nothing, so these print
                 one line each and launch nothing

Each time is the mean of 20 launches after one warm-up, on CUDA events
(`ms`), and the mean of the same 20 launches replayed from a CUDA graph
(`graph ms`, without the host's cost per launch); the table gives each
name's times and their ratios to K1 (forward names) or K2 (backward names)
from the same run. The probe needs a CUDA device and fails without one.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..ops import blend_probe, preprocess, tile_blend, tile_grid
from ..ops.binning import bin_and_pack
from .scene import HEIGHT, N_HEADLINE, WIDTH, headline_camera, headline_scene
from .timing import cuda_ms, graph_ms, require_cuda

FWD_MODE = {
    "fwd_floor": "floor",
    "fwd_nomxu": "nocarry",
    "fwd_novpu": "notrans",
    "fwd_noterm": "noexit",
    "fwd_opt": "chunk_exit",
    "fwd_roll": "chunk_exit",
    "fwd_unroll2": "unroll2",
}
NO_COUNTERPART = ("fwd_mixed", "fwd_high", "bwd_mixed", "bwd_high")
NAMES = ("null", "fwd", *FWD_MODE, "fwd_pair2", "bwd", "bwd_opt", *NO_COUNTERPART)


def build_inputs(n: int, device) -> dict:
    """The headline scene's binning on `device`: ranges, payload and gid
    with the tile grid and the Gaussian count."""
    model = headline_scene(device, n=n)
    gw, gh = tile_grid(WIDTH, HEIGHT)
    with torch.no_grad():
        opac = model.opacity_act()[:, 0]
        pre = preprocess(model.xyz, model.scaling_act(), model.rotation_act(), opac, model.f_dc,
                         model.f_rest, headline_camera(device), width=WIDTH, height=HEIGHT, sh_degree=3)
        b = bin_and_pack(pre.depths, pre.rect_min, pre.rect_max, pre.tiles_touched, pre.means2d,
                         pre.conics, opac, pre.colors, grid_w=gw, grid_h=gh)
    return dict(ranges=b.ranges, payload=b.payload, gid=b.gid, total=b.total_pairs, gw=gw, gh=gh, p=n)


def cotangents(num_tiles: int, device):
    """Seeded standard-normal cotangents of accum and log T_eff (the JAX
    probe's `default_rng(0)`)."""
    rng = np.random.default_rng(0)
    ct_a = rng.standard_normal((num_tiles, 256, 3)).astype(np.float32)
    ct_t = rng.standard_normal((num_tiles, 256)).astype(np.float32)
    return torch.from_numpy(ct_a).to(device), torch.from_numpy(ct_t).to(device)


def main(argv=None) -> dict:
    """Run the named probes (all without names); print one line per probe
    and the table; return {"ms": {name: ms}, "graph_ms": {name: ms}}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", help=f"any of {', '.join(NAMES)}")
    ap.add_argument("--n", type=int, default=N_HEADLINE, help="Gaussians in the headline scene")
    ap.add_argument("--chunk", type=int, default=128, help="pairs per chunk of the probe kernels")
    args = ap.parse_args(argv)
    unknown = set(args.names) - set(NAMES)
    if unknown:
        ap.error(f"unknown probe names {sorted(unknown)}")
    smi = require_cuda()
    dev = torch.device("cuda", 0)
    want = lambda name: not args.names or name in args.names
    chunk = args.chunk

    t0 = time.perf_counter()
    st = build_inputs(args.n, dev)
    ranges, payload, gw, gh = st["ranges"], st["payload"], st["gw"], st["gh"]
    num_tiles = gw * gh
    print(f"scene: {args.n} Gaussians, {st['total']} pairs before the cull, {payload.shape[1]} after, "
          f"grid {gw}x{gh} ({num_tiles} tiles), chunk {chunk}, built in {time.perf_counter() - t0:.2f} s; "
          f"{smi}", flush=True)

    ms, graph = {}, {}

    def timed(name, fn):
        ms[name] = cuda_ms(fn)
        graph[name] = graph_ms(fn)

    if want("null"):
        one = torch.zeros(1, device=dev)
        timed("null", lambda: one.add_(1.0))
    fwd_names = [x for x in (*FWD_MODE, "fwd_pair2") if want(x)]
    bwd_names = [x for x in ("bwd", "bwd_opt") if want(x)]
    if fwd_names or bwd_names:
        k1 = tile_blend.blend_fwd(ranges, payload, gw, gh)
    if want("fwd") or fwd_names:
        timed("fwd", lambda: tile_blend.blend_fwd(ranges, payload, gw, gh))
    for name in fwd_names:
        if name == "fwd_pair2":
            run = lambda: blend_probe.blend_probe_fwd_pair2(ranges, payload, gw, gh, chunk)
        else:
            run = lambda mode=FWD_MODE[name]: blend_probe.blend_probe_fwd(ranges, payload, gw, gh, mode, chunk)
        acc, lte, _, nd = run()
        d_acc = float((acc - k1[0]).abs().max())
        d_t = float((lte.exp() - k1[1].exp()).abs().max())
        print(f"  {name}: against K1, max|d accum| {d_acc:.3e}, max|d T_eff| {d_t:.3e}; "
              f"chunks walked {int(nd.sum())}", flush=True)
        timed(name, run)
    if bwd_names:
        ct_a, ct_t = cotangents(num_tiles, dev)
        k2_args = (ranges, payload, st["gid"], k1[0], k1[2], k1[3], ct_a, ct_t, st["p"], gw, gh)
        k2 = tile_blend.blend_bwd(*k2_args)
        timed("bwd", lambda: tile_blend.blend_bwd(*k2_args))
        if want("bwd_opt"):
            _, _, log_raw, n_done = blend_probe.blend_probe_fwd(ranges, payload, gw, gh, "chunk_exit", chunk)
            b_args = (ranges, payload, n_done, log_raw, ct_a, ct_t, gw, gh, chunk)
            pair = blend_probe.blend_probe_bwd(*b_args)
            folded = torch.zeros_like(k2).index_add_(0, st["gid"].to(torch.int64), pair.t())
            err = float((folded - k2).abs().max()) / max(float(k2.abs().max()), 1e-12)
            print(f"  bwd_opt: per-pair gradients folded by Gaussian against K2, scaled max|d| {err:.3e}",
                  flush=True)
            timed("bwd_opt", lambda: blend_probe.blend_probe_bwd(*b_args))
    for name in NO_COUNTERPART:
        if want(name):
            print(f"  {name}: no counterpart; it swaps the MXU pass precision of the TPU kernels' "
                  f"one-hot contractions (benchmarks/kernel_probe.py:1086-1194), and K1 and K2 "
                  f"contract nothing, so nothing is launched", flush=True)

    print(f"{'probe':14s} {'ms':>10s} {'ratio':>8s} {'graph ms':>10s} {'ratio':>8s}  base  "
          f"({smi}, chunk {chunk})", flush=True)
    for name, t in ms.items():
        base = None if name == "null" else ("bwd" if name.startswith("bwd") else "fwd")
        r = f"{t / ms[base]:8.3f}" if base else f"{'':8s}"
        rg = f"{graph[name] / graph[base]:8.3f}" if base else f"{'':8s}"
        print(f"{name:14s} {t:10.4f} {r} {graph[name]:10.4f} {rg}  {base or '-'}", flush=True)
    return {"ms": ms, "graph_ms": graph}


if __name__ == "__main__":
    main(sys.argv[1:])
