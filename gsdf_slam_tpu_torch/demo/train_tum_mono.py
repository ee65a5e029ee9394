"""TUM monocular SLAM-mode mapping on the port (the reference's
scripts/tum_mono.sh operating mode; the JAX package's
demo/train_tum_mono.py).

The tracker is stood in by the ground-truth poses (the reference got its
poses from ORB-SLAM3). Keyframes are fed image only, so the map grows
through the monocular inactive-geometry densify (the depth cache, the
rendered depth, the flat prior), with the tum_mono schedule: densify every
100 iterations, two uses a keyframe, a depth cache of 10 keyframes, and
existence pruning after a correction over 30 degrees or 1 m.

    python -m gsdf_slam_tpu_torch.demo.train_tum_mono <seq_dir> [--family fr1]
        [--frame-stride 15] [--max-frames N] [--extra-iterations 2000]
        [--output results/tum_mono] [--device cuda]

Reads the images with cv2 (imported here).
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sequence", help="TUM sequence dir (rgb.txt, groundtruth.txt)")
    ap.add_argument("--family", default="fr1", choices=["fr1", "fr2", "fr3"])
    ap.add_argument("--frame-stride", type=int, default=15)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--extra-iterations", type=int, default=2000)
    ap.add_argument("--output", default="results/tum_mono")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np

    from ..config import OptimizationParams
    from ..data.base_parser import load_image_rgb
    from ..data.tum import TUM_INTRINSICS, TumParser
    from ..engine import GaussianMapper, MapperSettings

    fr = TumParser(args.sequence, family=args.family).frames()
    intr = TUM_INTRINSICS[args.family]
    # the tum_mono schedule (cfg/gaussian_mapper/Monocular/TUM/*.yaml)
    settings = MapperSettings(
        opt=OptimizationParams(densification_interval=100, densify_until_iter=15_000, opacity_reset_interval=3_000),
        new_keyframe_times_of_use=2,
        do_inactive_geo_densify=True,
        max_depth_cached=10,
        stable_num_iter_existence=1,
        large_rotation_threshold=30.0,
        large_translation_threshold=1.0,
    )
    mapper = GaussianMapper(settings=settings, result_dir=args.output, device=args.device)

    idx = list(range(0, len(fr.color_files), args.frame_stride))
    if args.max_frames:
        idx = idx[: args.max_frames]
    t0 = time.time()
    for n, i in enumerate(idx):
        image = load_image_rgb(fr.color_files[i])
        mapper.feed_keyframe(i, fr.color_poses[i].astype(np.float32), image, intrinsics=intr)
        out = mapper.train_for_one_iteration()
        if out and n % 20 == 0:
            print(f"kf {n}/{len(idx)}: loss {out['loss']:.4f} points {out['count']}")
    for _ in range(args.extra_iterations):
        out = mapper.train_for_one_iteration()
        if out and mapper.iteration % 500 == 0:
            print(f"iter {mapper.iteration}: loss {out['loss']:.4f} psnr {out['psnr']:.2f} points {out['count']}")
    print(f"done in {time.time() - t0:.1f}s; saving results")
    print("wrote", mapper.save_ply())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
