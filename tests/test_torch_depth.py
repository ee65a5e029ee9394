"""Port parity: the expected-depth render (`render_depth_state`, through
`colors_precomp`), `eval_sh` at degrees 0-4, `sh_to_rgb`,
`psnr_gaussian_splatting` and `focal_to_fov` / `fov_to_focal`.

The JAX side runs as its own tests run it: the XLA blend, and the Pallas
blend in interpret mode. Bars: the image bar of tests/test_pallas_blend.py
(5e-6) on coverage, and on the blended depth (the image's channel)
scaled by max |z| of the Gaussians; the depth, a quotient of the two, where
coverage > 0.5, at the bar its two terms give (4 x 5e-6 x max |z|).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import jax_camera, scene_arrays, torch_camera

from gsdf_slam_tpu.engine.train import render_depth_state as j_render_depth
from gsdf_slam_tpu.models import GaussianState
from gsdf_slam_tpu.ops import RasterizeConfig as JCfg
from gsdf_slam_tpu.ops import losses as j_losses
from gsdf_slam_tpu.ops import sh as j_sh
from gsdf_slam_tpu.ops import transforms as j_tf
from gsdf_slam_tpu_torch.convert import from_jax_state
from gsdf_slam_tpu_torch.engine import render_depth_state
from gsdf_slam_tpu_torch.ops import RasterizeConfig
from gsdf_slam_tpu_torch.ops import losses, sh, transforms

IMAGE_BAR = 5e-6


def _wall_fields():
    """tests/test_slam_modes.py::test_render_depth_state's scene: 80
    Gaussians on the plane z = 3 with opacity sigmoid(4)."""
    rng = np.random.default_rng(4)
    n = 80
    pts = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.5, 1.5, n), np.full(n, 3.0)], -1)
    rot = np.zeros((n, 4))
    rot[:, 0] = 1.0
    return {
        "xyz": pts, "f_dc": rng.normal(size=(n, 1, 3)), "f_rest": np.zeros((n, 15, 3)),
        "opacity": np.full((n, 1), 4.0), "scaling": np.full((n, 3), np.log(0.15)), "rotation": rot,
    }, 32


def _random_fields():
    """The 64x64 test scene (depths 2-6, one Gaussian behind the camera and
    one inside the near plane), live prefix."""
    s = scene_arrays()
    n = int(s["alive"].sum())
    opac = s["opac"][:n]
    return {
        "xyz": s["means"][:n], "f_dc": s["dc"][:n], "f_rest": s["sh_rest"][:n],
        "opacity": np.log(opac / (1.0 - opac))[:, None], "scaling": np.log(s["scales"][:n]),
        "rotation": s["quats"][:n],
    }, 64


SCENES = {"wall": _wall_fields, "random": _random_fields}


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("scene", list(SCENES))
def test_render_depth_state_matches_jax(scene, backend):
    fields, size = SCENES[scene]()
    fields = {k: np.asarray(v, np.float32) for k, v in fields.items()}
    n = len(fields["xyz"])
    state = GaussianState(
        **{k: jnp.asarray(v) for k, v in fields.items()}, count=jnp.int32(n),
        exist_since_iter=jnp.zeros(n, jnp.int32), max_radii2d=jnp.zeros(n), xyz_grad_accum=jnp.zeros(n),
        denom=jnp.zeros(n))
    jcfg = JCfg(height=size, width=size, max_pairs=1 << 13, chunk=128, backend=backend)
    j_depth, j_cov = (np.asarray(a) for a in j_render_depth(state, jax_camera(), jcfg))
    model = from_jax_state(fields, n, device="cpu")
    depth, cov = (a.numpy() for a in render_depth_state(model, torch_camera(), RasterizeConfig(height=size,
                                                                                               width=size)))
    z_max = float(np.abs(fields["xyz"][:, 2]).max())
    assert depth.shape == cov.shape == (size, size)
    np.testing.assert_allclose(cov, j_cov, atol=IMAGE_BAR, rtol=0)
    np.testing.assert_allclose(depth * np.maximum(cov, 1e-6), j_depth * np.maximum(j_cov, 1e-6),
                               atol=IMAGE_BAR * z_max, rtol=0)
    covered = cov > 0.5
    assert covered.mean() > 0.2
    np.testing.assert_allclose(depth[covered], j_depth[covered], atol=4 * IMAGE_BAR * z_max, rtol=0)
    if scene == "wall":  # test_slam_modes.py's own check: the plane's depth
        np.testing.assert_allclose(depth[covered], 3.0, atol=0.1)


def test_render_depth_state_leaves_no_gradient():
    fields, size = _wall_fields()
    model = from_jax_state({k: np.asarray(v, np.float32) for k, v in fields.items()}, 80, device="cpu")
    depth, cov = render_depth_state(model, torch_camera(), RasterizeConfig(height=size, width=size))
    assert not depth.requires_grad and not cov.requires_grad


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_matches_jax(deg):
    rng = np.random.default_rng(3 + deg)
    dirs = rng.normal(size=(64, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    coeffs = rng.normal(size=(64, 3, 25)).astype(np.float32)
    want = np.asarray(j_sh.eval_sh(deg, jnp.asarray(coeffs), jnp.asarray(dirs)))
    got = sh.eval_sh(deg, torch.from_numpy(coeffs), torch.from_numpy(dirs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_eval_sh_rejects_bad_degrees():
    with pytest.raises(ValueError, match="deg"):
        sh.eval_sh(5, torch.zeros(2, 3, 36), torch.zeros(2, 3))
    with pytest.raises(ValueError, match="coeffs"):
        sh.eval_sh(4, torch.zeros(2, 3, 16), torch.zeros(2, 3))


def test_sh_to_rgb_inverts_rgb_to_sh():
    rgb = np.random.default_rng(1).uniform(0, 1, (50, 3)).astype(np.float32)
    got = sh.sh_to_rgb(torch.from_numpy(rgb)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_sh.sh_to_rgb(jnp.asarray(rgb))))
    back = sh.sh_to_rgb(sh.rgb_to_sh(torch.from_numpy(rgb))).numpy()
    np.testing.assert_allclose(back, rgb, atol=1e-6)


def test_psnr_gaussian_splatting_matches_jax():
    rng = np.random.default_rng(9)
    a = rng.uniform(0, 1, (3, 8, 8)).astype(np.float32)
    b = rng.uniform(0, 1, (3, 8, 8)).astype(np.float32)
    want = float(j_losses.psnr_gaussian_splatting(jnp.asarray(a), jnp.asarray(b)))
    got = float(losses.psnr_gaussian_splatting(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(got - want) < 1e-5
    mse = ((a - b).reshape(3, -1) ** 2).mean(1)
    assert abs(got - (20 * np.log10(1 / np.sqrt(mse))).mean()) < 1e-4


@pytest.mark.parametrize("focal, pixels", [(600.0, 1200), (525.0, 480), (1.0, 1)])
def test_focal_fov_conversions_match_jax(focal, pixels):
    fov = transforms.focal_to_fov(focal, pixels)
    assert fov == j_tf.focal_to_fov(focal, pixels)
    assert transforms.fov_to_focal(fov, pixels) == j_tf.fov_to_focal(fov, pixels)
    assert math.isclose(transforms.fov_to_focal(fov, pixels), focal, rel_tol=1e-12)
