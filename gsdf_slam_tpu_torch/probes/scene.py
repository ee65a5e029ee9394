"""Scenes of the probe path and of `chip_smoke.py`, built with numpy from
a seed.

- The headline: `bench.py::build_scene(n, converged=True)` (the JAX probe's
  `GSDF_PROBE_N=400000` scene, benchmarks/kernel_probe.py:56-108) with the
  identity camera at 1200x680: Gaussians on the walls of an 8 m box seen
  from its centre, opacity 0.5, scales from the exact 3-NN times the
  pair-count calibration.
- The opaque wall (32x32, 128 Gaussians): every tile's pixels pass
  T = 1e-4 after a few pairs, so the chunk-granular exit of the blend
  probes fires, which the 64x64 test scene never makes it do.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import GaussianModel
from ..ops import CameraMatrices

WIDTH, HEIGHT = 1200, 680
N_HEADLINE = 400_000
# pair-count calibration of the converged scene (bench.py CALIB
# "1200x680/400000"): the scale multiplier that bins ~2.5 pairs per Gaussian
SCALE_MULT = 2.59368
WALL_SIZE = 32


def headline_scene(device, n: int = N_HEADLINE, seed: int = 0) -> GaussianModel:
    """bench.py::build_scene(n, converged=True) as a numpy recipe."""
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


def headline_camera(device) -> CameraMatrices:
    """bench.py's identity camera at WIDTH x HEIGHT, focal 600 px."""
    fovx = 2 * np.arctan(WIDTH / (2 * 600.0))
    fovy = 2 * np.arctan(HEIGHT / (2 * 600.0))
    return CameraMatrices.from_pose(np.array([1.0, 0, 0, 0]), np.zeros(3), fovx, fovy, device=device)


def wall_arrays(p: int = 128, seed: int = 3) -> dict[str, np.ndarray]:
    """The opaque wall: xy uniform in +-0.2, z uniform in 2-6, scales 3.0,
    opacity 0.9, identity rotation, colour from uniform(-0.5, 0.5) DC
    (tests/test_binning_cache.py::_saturating_scene, narrowed). Seen by
    the 90-degree identity camera at WALL_SIZE x WALL_SIZE."""
    rng = np.random.default_rng(seed)
    means = np.stack(
        [rng.uniform(-0.2, 0.2, p), rng.uniform(-0.2, 0.2, p), rng.uniform(2.0, 6.0, p)], -1
    ).astype(np.float32)
    return dict(
        means=means,
        scales=np.full((p, 3), 3.0, np.float32),
        quats=np.tile(np.array([1, 0, 0, 0], np.float32), (p, 1)),
        opac=np.full(p, 0.9, np.float32),
        dc=rng.uniform(-0.5, 0.5, (p, 1, 3)).astype(np.float32),
        sh_rest=np.zeros((p, 15, 3), np.float32),
    )


def wall_scene(device):
    """The wall's preprocess arguments (means, scales, quats, opacity, dc,
    sh_rest) as tensors on `device`, and its camera."""
    w = wall_arrays()
    args = tuple(
        torch.from_numpy(w[k]).to(device) for k in ("means", "scales", "quats", "opac", "dc", "sh_rest")
    )
    cam = CameraMatrices.from_pose(np.array([1.0, 0, 0, 0]), np.zeros(3), np.pi / 2, np.pi / 2, device=device)
    return args, cam
