"""Port parity: transforms, SH and preprocess against the JAX package.

Same numpy inputs through `gsdf_slam_tpu` (reference) and
`gsdf_slam_tpu_torch` (port), on the CPU.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (
    assert_scaled_close, jax_args, jax_camera, scene_arrays, torch_args, torch_camera,
)

from gsdf_slam_tpu.ops import projection as jproj
from gsdf_slam_tpu.ops import sh as jsh
from gsdf_slam_tpu.ops import transforms as jtr
from gsdf_slam_tpu_torch.ops import projection, sh, transforms

FIELDS = ("means2d", "depths", "conics", "colors", "radii", "rect_min", "rect_max", "tiles_touched")


def test_transforms_match():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(17, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    s = np.exp(rng.uniform(-3, 0, (17, 3))).astype(np.float32)
    tol = 1e-6
    np.testing.assert_allclose(
        transforms.quat_to_rotmat(torch.from_numpy(q)).numpy(), np.asarray(jtr.quat_to_rotmat(q)), atol=tol
    )
    np.testing.assert_allclose(
        transforms.build_cov3d(torch.from_numpy(s), torch.from_numpy(q), 1.3).numpy(),
        np.asarray(jtr.build_cov3d(s, q, 1.3)), atol=tol,
    )
    x = rng.uniform(0.05, 0.95, 9).astype(np.float32)
    np.testing.assert_allclose(
        transforms.inverse_sigmoid(torch.from_numpy(x)).numpy(), np.asarray(jtr.inverse_sigmoid(x)), atol=tol
    )
    jc = jtr.CameraMatrices.from_pose(q[0], np.array([0.1, -0.2, 0.3]), 1.1, 0.8)
    tc = transforms.CameraMatrices.from_pose(q[0], np.array([0.1, -0.2, 0.3]), 1.1, 0.8, device="cpu")
    for f in ("view", "full_proj", "campos", "tanfovx", "tanfovy"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)))
    v = rng.uniform(-1, 1, 11).astype(np.float32)
    np.testing.assert_array_equal(
        transforms.ndc_to_pix(torch.from_numpy(v), 64).numpy(), np.asarray(jtr.ndc_to_pix(v, 64))
    )


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_color_matches(degree):
    rng = np.random.default_rng(degree)
    dc = rng.normal(size=(13, 1, 3)).astype(np.float32)
    rest = rng.normal(size=(13, 15, 3)).astype(np.float32)
    means = rng.normal(size=(13, 3)).astype(np.float32)
    campos = np.array([0.1, 0.2, -0.3], np.float32)
    want = np.asarray(jsh.eval_sh_color(dc, rest, means, campos, degree))
    got = sh.eval_sh_color(*(torch.from_numpy(a) for a in (dc, rest, means, campos)), degree).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)
    np.testing.assert_allclose(
        sh.rgb_to_sh(torch.from_numpy(means)).numpy(), np.asarray(jsh.rgb_to_sh(means)), atol=1e-6
    )
    if degree == 3:  # the active-degree ramp zeroes the upper bands
        ramp = np.asarray(jsh.eval_sh_color(dc, rest, means, campos, 3, jnp.int32(1)))
        got = sh.eval_sh_color(*(torch.from_numpy(a) for a in (dc, rest, means, campos)), 3, 1).numpy()
        np.testing.assert_allclose(got, ramp, atol=2e-6)


def _preprocess_both(s):
    jpre = jax.jit(
        lambda *a: jproj.preprocess(*a[:7], a[7], width=64, height=64, sh_degree=3)
    )(*jax_args(s), jax_camera())
    tpre = projection.preprocess(*torch_args(s), torch_camera(), width=64, height=64, sh_degree=3)
    return jpre, tpre


def test_preprocess_fields_match():
    """Every Preprocessed field of the live Gaussians: floats to 1e-5
    relative (projection through a 90-degree FoV), integers exactly, on the
    Gaussians that survive the cull (culled rows carry no data)."""
    s = scene_arrays()
    jpre, tpre = _preprocess_both(s)
    n = int(s["alive"].sum())
    vis = np.asarray(jpre.tiles_touched)[:n] > 0
    assert vis.sum() > 50
    np.testing.assert_array_equal(tpre.tiles_touched.numpy(), np.asarray(jpre.tiles_touched)[:n])
    np.testing.assert_array_equal(tpre.radii.numpy(), np.asarray(jpre.radii)[:n])
    for f in FIELDS:
        want = np.asarray(getattr(jpre, f))[:n][vis]
        got = getattr(tpre, f).detach().numpy()[vis]
        if want.dtype.kind == "i":
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=f)


def test_preprocess_gradients_match():
    """Gradients of a weighted sum of the float fields (visible rows) with
    respect to all six inputs, scaled per input: 2e-5."""
    s = scene_arrays()
    n = int(s["alive"].sum())
    rng = np.random.default_rng(7)
    jpre0 = jproj.preprocess(*jax_args(s), jax_camera(), width=64, height=64, sh_degree=3)
    vis = np.asarray(jpre0.tiles_touched) > 0
    wm = rng.normal(size=(96, 2)).astype(np.float32) * vis[:, None]
    wk = rng.normal(size=(96, 3)).astype(np.float32) * vis[:, None]
    wc = rng.normal(size=(96, 3)).astype(np.float32) * vis[:, None]
    wd = rng.normal(size=(96,)).astype(np.float32) * vis

    def jloss(params):
        pre = jproj.preprocess(*params, jnp.asarray(s["alive"]), jax_camera(), width=64, height=64, sh_degree=3)
        # conics of near-degenerate splats are large; scale them down
        return (jnp.sum(pre.means2d * wm) + jnp.sum(pre.depths * wd)
                + 1e-2 * jnp.sum(pre.conics * wk) + jnp.sum(pre.colors * wc))

    gj = jax.jit(jax.grad(jloss))(jax_args(s)[:6])
    tp = [t.clone().requires_grad_(True) for t in torch_args(s)]
    pre = projection.preprocess(*tp, torch_camera(), width=64, height=64, sh_degree=3)
    t = lambda a: torch.from_numpy(a[:n])
    loss = ((pre.means2d * t(wm)).sum() + (pre.depths * t(wd)).sum()
            + 1e-2 * (pre.conics * t(wk)).sum() + (pre.colors * t(wc)).sum())
    # opacity reaches only the integer rects: no gradient on either side
    gt = torch.autograd.grad(loss, tp, allow_unused=True)
    for name, a, b, x in zip(("means", "scales", "quats", "opac", "dc", "sh_rest"), gj, gt, tp):
        b = torch.zeros_like(x) if b is None else b
        assert_scaled_close(np.asarray(a)[:n], b.numpy(), 2e-5, name)


def test_forward_golden_through_port_render():
    """The committed float64 golden (tests/fixtures/make_forward_golden.py)
    through the port's render, at the bar test_render.py holds JAX to."""
    from gsdf_slam_tpu_torch.ops import CameraMatrices, RasterizeConfig, render

    g = np.load(Path(__file__).parent / "fixtures" / "forward_golden.npz")
    cam = CameraMatrices.from_arrays(g["view"], g["full_proj"], g["campos"], g["tanfovx"], g["tanfovy"], device="cpu")
    t = lambda k: torch.from_numpy(np.asarray(g[k], np.float32))
    out = render(t("xyz"), t("scales"), t("quats"), t("opac"), t("dc"), t("sh_rest"), cam, t("bg"),
                 RasterizeConfig(height=64, width=64))
    np.testing.assert_allclose(out.image.numpy().astype(np.float64), g["image"], atol=3e-5)
    np.testing.assert_allclose(out.final_t.numpy().astype(np.float64), g["final_t"], atol=3e-5)
