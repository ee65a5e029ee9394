"""End-to-end streaming run of the port's mapper: the number a SLAM system
lives on.

    python -m gsdf_slam_tpu_torch.stream [--frames 60] [--res 1200x680]
        [--pipeline 2] [--device cuda]

The port's counterpart of `benchmarks/e2e_stream.py::run_stream`: the
synthetic RGB-D room (`probes/synthetic_room.py::make_sequence`) streamed
through `GaussianMapper.feed_keyframe` with depth and one
`train_for_one_iteration` a frame (gaussian_mapper.cpp:328-331), then the
drain of the keyframe window's outstanding uses, at the JAX run's
settings: densify every 100 iterations from 50 until 10,000, no opacity
reset, 3 uses a keyframe, no inactive-geometry densify, 65,536 points an
ingest, and `--pipeline` steps in flight before their metrics are read
(metrics_pipeline_depth; 2 by default, as the JAX entry point's, 0 is the
reference's synchronous read). The frames are made, and the kernels
built, before the clock starts.

Prints one JSON line: the pipeline depth, frames/s and iterations/s over
the wall time, the Gaussians at the end, the binning of each step, the
device's peak memory
over the stream beyond what was allocated when it began (on the card),
and the mapper's PhaseTimer host ms per phase
(ingest.backproject, ingest.knn, ingest.increase_pcd, which holds
ingest.knn, train_step and cadence).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from . import kernels
from .config import OptimizationParams
from .data import CameraIntrinsics
from .engine import GaussianMapper, MapperSettings
from .probes.synthetic_room import make_sequence
from .utils.observability import device_memory_stats


def stream_settings(rebin_interval: int = 1, pipeline: int = 0) -> MapperSettings:
    """`benchmarks/e2e_stream.py`'s Replica-RGB-D-style schedule."""
    return MapperSettings(
        opt=OptimizationParams(
            densification_interval=100, densify_from_iter=50, densify_until_iter=10_000, opacity_reset_interval=0,
        ),
        new_keyframe_times_of_use=3,
        do_inactive_geo_densify=False,
        rebin_interval=rebin_interval,
        metrics_pipeline_depth=pipeline,
    )


def run_stream(
    n_frames: int = 60,
    width: int = 1200,
    height: int = 680,
    device: torch.device | str = "cuda",
    rebin_interval: int = 1,
    frames=None,
    pipeline: int = 0,
) -> tuple[dict, list[dict]]:
    """Stream the room through a mapper on `device` (seed 0), with
    `pipeline` steps in flight. Returns (the result line's fields, one
    record a step, in step order: iteration, keyframe, binning, count,
    loss, psnr). `frames` (from `make_sequence`) may be passed in to reuse
    them."""
    import scipy.spatial  # noqa: F401  (its first import, ~1 s, stays off the clock)

    dev = torch.device(device)
    mapper = GaussianMapper(settings=stream_settings(rebin_interval, pipeline), ingest_capacity=1 << 16, device=dev)
    fov = np.pi / 2
    fx = 0.5 * width / np.tan(fov / 2)
    intr = CameraIntrinsics(fx=fx, fy=fx, cx=(width - 1) / 2.0, cy=(height - 1) / 2.0, width=width, height=height)
    if frames is None:
        frames = make_sequence(n_frames, width, height, fov)
    steps: list[dict] = []
    mapper.step_log = steps

    held = 0
    if dev.type == "cuda":
        kernels.library()  # built (or loaded) before the clock
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        held = device_memory_stats(dev)["bytes_in_use"]  # the caller's tensors, not the stream's
    t0 = time.perf_counter()
    for i, (pose, rgb, depth) in enumerate(frames):
        mapper.feed_keyframe(i, pose, rgb, depth=depth, intrinsics=intr)
        mapper.train_for_one_iteration()
    # drain the window's outstanding uses, as the reference's post-stream
    # training does (the sampler refills +1 use to all when exhausted,
    # gaussian_mapper.cpp:548-551, so bound it by the budget left)
    drain = sum(max(kf.remaining_times_of_use, 0) for kf in mapper.scene.keyframes.values())
    for _ in range(drain):
        mapper.train_for_one_iteration()
    mapper.flush_metrics()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    result = {
        "pipeline_depth": pipeline,
        "frames": len(frames),
        "resolution": f"{width}x{height}",
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "iterations": len(steps),
        "wall_s": wall,
        "frames_per_sec": len(frames) / wall,
        "iters_per_sec": len(steps) / wall,
        "gaussians": mapper.model.count,
        "binning": dict(mapper.binning_counts),
        "phases_ms": mapper.timer.summary(),
    }
    if dev.type == "cuda":
        result["peak_device_mb"] = (device_memory_stats(dev)["peak_bytes_in_use"] - held) / 2**20
    return result, steps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--res", default="1200x680")
    ap.add_argument("--pipeline", type=int, default=2,
                    help="metrics_pipeline_depth: steps in flight (0 = the reference's synchronous read)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    w, h = (int(v) for v in args.res.split("x"))
    result, _ = run_stream(args.frames, w, h, args.device, pipeline=args.pipeline)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
