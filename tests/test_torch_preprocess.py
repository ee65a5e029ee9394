"""Port parity: transforms, SH and preprocess against the JAX package.

Same numpy inputs through `gsdf_slam_tpu` (reference) and
`gsdf_slam_tpu_torch` (port), on the CPU. Then `Preprocess`, the autograd
Function that runs the preprocess kernels on the card, against the plain
version it takes on the CPU, and its wrappers' checks.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (
    assert_scaled_close, claims_cuda, crafted_preprocess_rows, jax_args, jax_camera, scene_arrays, torch_args,
    torch_camera,
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


# ---- Preprocess on the CPU: today's plain version, bit for bit

# (SH degree, active degree): below the degree where there is one, and at it
DEGREES = [(d, a) for d in range(4) for a in ((d - 1, d) if d else (d,))]


def _fields_and_grads(fn, s, degree, active, offset, precomp):
    """The float fields, integer fields and input gradients of one weighted
    loss of every float field (depths included) through `fn`, with
    gradients asked of all inputs but the camera."""
    n = int(s["alive"].sum())
    rng = np.random.default_rng(11)
    w = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)) for shape in ((n, 2), (n,), (n, 3), (n, 3))]
    leaves = [t.clone().requires_grad_(True) for t in torch_args(s)]
    extra = {}
    if offset:
        extra["means2d_offset"] = torch.zeros((n, 2), requires_grad=True)
    if precomp:
        extra["colors_precomp"] = torch.from_numpy(rng.uniform(0, 2, (n, 3)).astype(np.float32)).requires_grad_(True)
    pre = fn(*leaves, torch_camera(), width=64, height=64, sh_degree=degree, active_sh_degree=active, **extra)
    floats = (pre.means2d, pre.depths, pre.conics, pre.colors)
    loss = sum((f * wf).sum() for f, wf in zip(floats, w))
    wrt = leaves + list(extra.values())
    grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    return [f.detach() for f in floats], [pre.radii, pre.rect_min, pre.rect_max, pre.tiles_touched], grads


def _assert_same(got, want):
    (f_g, i_g, g_g), (f_w, i_w, g_w) = got, want
    for a, b in zip(f_g + i_g, f_w + i_w):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for k, (a, b) in enumerate(zip(g_g, g_w)):
        assert (a is None) == (b is None), k
        assert a is None or torch.equal(a, b), k


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("degree,active", DEGREES)
def test_function_is_the_plain_version_bit_for_bit(degree, active, offset):
    """`preprocess` (the Function, CPU route) against `preprocess_plain`:
    every field and every input's gradient bit-equal; opacities get none."""
    s = scene_arrays()
    got = _fields_and_grads(projection.preprocess, s, degree, active, offset, False)
    want = _fields_and_grads(projection.preprocess_plain, s, degree, active, offset, False)
    _assert_same(got, want)
    assert got[2][3] is None and got[2][0] is not None


@pytest.mark.parametrize("offset", [False, True])
def test_function_with_colors_precomp_is_the_plain_version(offset):
    """The depth render's path: colours taken as given, their gradient the
    cotangent, dc and sh_rest untouched."""
    s = scene_arrays(seed=2)
    got = _fields_and_grads(projection.preprocess, s, 3, None, offset, True)
    want = _fields_and_grads(projection.preprocess_plain, s, 3, None, offset, True)
    _assert_same(got, want)
    assert got[2][4] is None and got[2][5] is None and got[2][-1] is not None


def test_function_under_no_grad_is_the_plain_version():
    s = scene_arrays(seed=3)
    with torch.no_grad():
        got = projection.preprocess(*torch_args(s), torch_camera(), width=64, height=64, sh_degree=3)
        want = projection.preprocess_plain(*torch_args(s), torch_camera(), width=64, height=64, sh_degree=3)
    for a, b in zip(got, want):
        assert torch.equal(a, b) and not a.requires_grad


def _kernel_route_call(case):
    """A preprocess on tensors that claim the card, broken as `case` says,
    so that the wrapper's checks run before it would build the kernels."""
    n = 5
    z = lambda *shape, dt=torch.float32: claims_cuda(torch.zeros(shape, dtype=dt))
    args = [z(n, 3), z(n, 3), z(n, 4), z(n), z(n, 1, 3), z(n, 15, 3)]
    cam = projection.CameraMatrices(z(4, 4), z(4, 4), z(3), z(), z())
    degree = 3
    if case == "dtype":
        args[0] = z(n, 3, dt=torch.float64)
    elif case == "non_contiguous":
        args[2] = claims_cuda(torch.zeros(4, n).t())
    elif case == "device_mix":
        args[1] = torch.zeros(n, 3)
    elif case == "sh_degree_4":
        degree = 4
    if case == "cotangent_device":
        st = projection.PreprocessSettings(64, 64, 3, 1.0, None)
        return lambda: projection.preprocess_bwd(*args[:3], *args[4:], cam, st, torch.zeros(n, 2), None, None, None)
    return lambda: projection.preprocess(*args, cam, width=64, height=64, sh_degree=degree)


@pytest.mark.parametrize("case,error,match", [
    ("dtype", TypeError, "means3d: expected torch.float32"),
    ("non_contiguous", ValueError, "quats: must be contiguous"),
    ("device_mix", ValueError, "scales: expected device cuda:0, got cpu"),
    ("sh_degree_4", ValueError, "SH degree must be in"),
    ("cotangent_device", ValueError, "ct_means2d: expected device cuda:0, got cpu"),
])
def test_kernel_wrappers_raise_on_bad_inputs(case, error, match):
    with pytest.raises(error, match=match):
        _kernel_route_call(case)()


def test_crafted_rows_reach_every_gate():
    """The card test's crafted rows (tests/test_torch_cuda.py) reach the
    gates they are named for, and the plain VJP through them is finite."""
    args, masks = crafted_preprocess_rows()
    t = [torch.from_numpy(a).requires_grad_(True) for a in args]
    cam = torch_camera()
    pre = projection.preprocess_plain(*t, cam, width=64, height=64, sh_degree=3)
    m = t[0].detach()
    cov2d = projection.compute_cov2d(m, transforms.build_cov3d(t[1].detach(), t[2].detach()), cam,
                                     64 / (2.0 * cam.tanfovx), 64 / (2.0 * cam.tanfovy))
    det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] * cov2d[:, 1]
    g = {k: torch.from_numpy(v) for k, v in masks.items()}
    culled = pre.tiles_touched == 0
    assert bool(culled[g["behind"]].all()) and bool((m[g["behind"], 2] < 0).all())
    assert bool(culled[g["near"]].all()) and int((m[g["near"], 2].abs() < 0.1).sum()) >= 2
    past = torch.maximum((m[:, 0] / m[:, 2]).abs(), (m[:, 1] / m[:, 2]).abs()) > 1.3
    assert bool(past[g["past_clamp"]].all()) and not bool(culled[g["past_clamp"]].any())
    assert bool((det[g["det_zero"]] == 0).all()) and bool(culled[g["det_zero"]].all())
    faint = g["faint"]
    assert bool((t[3].detach()[faint] * 255 < 1).all()) and bool((pre.radii[faint] > 0).all())
    assert bool(culled[faint].all())
    assert bool((pre.colors.detach()[g["dark"]] == 0).any(dim=1).all())
    cts = [torch.randn(f.shape, generator=torch.Generator().manual_seed(k))
           for k, f in enumerate((pre.means2d, pre.depths, pre.conics, pre.colors))]
    grads = torch.autograd.grad([pre.means2d, pre.depths, pre.conics, pre.colors], [t[i] for i in (0, 1, 2, 4, 5)],
                                cts)
    assert all(bool(torch.isfinite(x).all()) for x in grads)
