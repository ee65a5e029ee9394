"""Shared inputs for the port's parity tests (tests/test_torch_*.py).

Scenes are built with numpy from a seed and handed to both packages: the
JAX package (the reference) and `gsdf_slam_tpu_torch` (the port).
"""

import numpy as np
import torch

torch.set_num_threads(2)  # six test workers share the machine


def scene_arrays(p=96, seed=1, opacity_max=0.95, spread=2.0):
    """`tests/test_render.py::make_scene`'s recipe as numpy arrays: a
    64x64 view at the origin looking down +z, 90-degree FoV. The last three
    Gaussians are dead slots for the JAX package; the port gets the live
    prefix only."""
    rng = np.random.default_rng(seed)
    means = np.stack(
        [rng.uniform(-spread, spread, p), rng.uniform(-spread, spread, p), rng.uniform(2.0, 6.0, p)],
        axis=-1,
    ).astype(np.float32)
    means[0, 2] = -1.0
    means[1, 2] = 0.1
    scales = np.exp(rng.uniform(-2.5, -0.5, (p, 3))).astype(np.float32)
    quats = rng.normal(size=(p, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rng.uniform(0.2, opacity_max, p).astype(np.float32)
    dc = rng.uniform(-1.0, 1.0, (p, 1, 3)).astype(np.float32)
    sh_rest = (0.1 * rng.normal(size=(p, 15, 3))).astype(np.float32)
    alive = np.ones(p, bool)
    alive[-3:] = False
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    return dict(means=means, scales=scales, quats=quats, opac=opac, dc=dc, sh_rest=sh_rest, alive=alive, bg=bg)


FOV = np.pi / 2
POSE = (np.array([1.0, 0, 0, 0]), np.zeros(3))


def jax_camera():
    from gsdf_slam_tpu.ops import CameraMatrices

    return CameraMatrices.from_pose(q=POSE[0], t=POSE[1], fovx=FOV, fovy=FOV)


def torch_camera():
    from gsdf_slam_tpu_torch.ops import CameraMatrices

    return CameraMatrices.from_pose(q=POSE[0], t=POSE[1], fovx=FOV, fovy=FOV, device="cpu")


def live(s, key):
    """The port's tensor for a scene field: the live prefix."""
    return torch.from_numpy(s[key][: int(s["alive"].sum())].copy())


def jax_args(s):
    import jax.numpy as jnp

    return tuple(jnp.asarray(s[k]) for k in ("means", "scales", "quats", "opac", "dc", "sh_rest", "alive"))


def torch_args(s):
    return tuple(live(s, k) for k in ("means", "scales", "quats", "opac", "dc", "sh_rest"))


def assert_scaled_close(a, b, atol, name=""):
    """|a - b| / max|a| <= atol (the gradient bar of tests/test_pallas_blend.py)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    scale = max(float(np.abs(a).max()), 1e-4)
    err = float(np.abs(a - b).max()) / scale
    assert err <= atol, f"{name}: scaled error {err:.3g} > {atol}"


def synthetic_binning(counts, grid_w, seed=0, opacity=(0.05, 0.3), sigma=(1.0, 2.5)):
    """A binning built directly, tile by tile, in the port's layout: tile t
    holds counts[t] small Gaussians (standard deviations in `sigma` pixels,
    opacity uniform in `opacity`) centred in or near the tile, with more
    pairs than Gaussians so that several pairs fold into one Gaussian.
    Returns ranges [T, 2] int32, payload [9, M] float32 (mean x, y; conic
    a, b, c; opacity; rgb), gid [M] int32 and the Gaussian count."""
    rng = np.random.default_rng(seed)
    counts = np.asarray(counts, np.int64)
    m = int(counts.sum())
    ends = np.cumsum(counts)
    tile = np.repeat(np.arange(len(counts)), counts)
    mx = (tile % grid_w) * 16 + rng.uniform(-2.0, 18.0, m)
    my = (tile // grid_w) * 16 + rng.uniform(-2.0, 18.0, m)
    s1, s2 = rng.uniform(*sigma, (2, m))
    th = rng.uniform(0.0, np.pi, m)
    cos, sin = np.cos(th), np.sin(th)
    cxx = cos**2 * s1**2 + sin**2 * s2**2
    cyy = sin**2 * s1**2 + cos**2 * s2**2
    cxy = cos * sin * (s1**2 - s2**2)
    det = cxx * cyy - cxy**2
    payload = np.stack([
        mx, my, cyy / det, -cxy / det, cxx / det, rng.uniform(*opacity, m), *rng.uniform(0.0, 1.0, (3, m)),
    ]).astype(np.float32)
    p = max(m // 2, 1)
    ranges = np.stack([ends - counts, ends], 1).astype(np.int32)
    gid = rng.integers(0, p, m).astype(np.int32)
    return torch.from_numpy(ranges), torch.from_numpy(payload), torch.from_numpy(gid), p
