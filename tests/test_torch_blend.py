"""Port parity: the blend (`FreshBlend`: binning, K1/K2 plain versions on
the CPU) against the JAX XLA blend, against the grouped Pallas kernels
(`blend_tiles_grouped_fused`, interpret mode, group 8) and against the
per-tile Pallas kernels (`pallas_blend.py::blend_tiles_pallas`, the path
`render` takes with `pallas_group=1`), forward and gradients. Bars of
tests/test_pallas_blend.py: 5e-6 absolute for the accumulated colour and
log T, 2e-5 for gradients after scaling."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (
    assert_scaled_close, jax_args, jax_camera, scene_arrays, torch_args, torch_camera,
)

from gsdf_slam_tpu.ops import binning as jbin
from gsdf_slam_tpu.ops import blend as jblend
from gsdf_slam_tpu.ops import pallas_blend as jpb
from gsdf_slam_tpu.ops import pallas_blend_grouped as jpbg
from gsdf_slam_tpu.ops import projection as jproj
from gsdf_slam_tpu_torch.ops import binning, blend, projection, tile_blend

GRID = 4


def _jax_blend(path):
    def run(pre, m2, con, op, col):
        pre = pre._replace(means2d=m2, conics=con, colors=col)
        if path in ("xla", "pallas_group1"):
            b = jbin.bin_gaussians(
                jax.lax.stop_gradient(pre), jax.lax.stop_gradient(op),
                grid_w=GRID, grid_h=GRID, max_pairs=4096,
            )
        if path == "xla":
            return jblend.blend_tiles(
                b.pair_tile, b.pair_gauss, m2, con, op, col, b.total_pairs,
                grid_w=GRID, grid_h=GRID, chunk=128,
            )
        if path == "pallas_group1":  # rasterize.py:253-271
            a = jbin.align_pairs(b, m2.shape[0], num_tiles=GRID * GRID, chunk=128)
            return jpb.blend_tiles_pallas(
                a.ranges, a.pair_gauss, m2, con, op, col, grid_w=GRID, grid_h=GRID, chunk=128
            )
        acc, lte, _ = jpbg.blend_tiles_grouped_fused(
            pre, op, grid_w=GRID, grid_h=GRID, max_pairs=4096, chunk=128, group=8
        )
        return acc, lte

    return run


@pytest.mark.parametrize("path", ["xla", "pallas_group8", "pallas_group1"])
def test_fresh_blend_matches_jax(path):
    s = scene_arrays()
    pre = jax.jit(
        lambda *a: jproj.preprocess(*a[:7], a[7], width=64, height=64, sh_degree=3)
    )(*jax_args(s), jax_camera())
    op = jnp.asarray(s["opac"])
    rng = np.random.default_rng(11)
    ct_acc = rng.normal(size=(GRID * GRID, 256, 3)).astype(np.float32)
    ct_lte = (0.1 * rng.normal(size=(GRID * GRID, 256))).astype(np.float32)

    run = _jax_blend(path)
    (acc_j, lte_j), vjp = jax.vjp(
        lambda m2, con, o, col: run(pre, m2, con, o, col), pre.means2d, pre.conics, op, pre.colors
    )
    grads_j = vjp((jnp.asarray(ct_acc), jnp.asarray(ct_lte)))

    t = lambda a: torch.from_numpy(np.asarray(a).copy())
    diff = [t(pre.means2d), t(pre.conics), t(op), t(pre.colors)]
    for x in diff:
        x.requires_grad_(True)
    tpre = projection.Preprocessed(
        means2d=diff[0], depths=t(pre.depths), conics=diff[1], colors=diff[3],
        radii=t(pre.radii), rect_min=t(pre.rect_min), rect_max=t(pre.rect_max),
        tiles_touched=t(pre.tiles_touched),
    )
    acc, lte, total = tile_blend.blend_tiles_fresh(tpre, diff[2], grid_w=GRID, grid_h=GRID)
    assert int(total) == int(jnp.sum(pre.tiles_touched))
    np.testing.assert_allclose(acc.detach().numpy(), np.asarray(acc_j), atol=5e-6)
    np.testing.assert_allclose(lte.detach().numpy(), np.asarray(lte_j), atol=5e-6)

    grads_t = torch.autograd.grad((acc * t(ct_acc)).sum() + (lte * t(ct_lte)).sum(), diff)
    for name, a, b in zip(("means2d", "conics", "opacity", "colors"), grads_j, grads_t):
        assert_scaled_close(np.asarray(a), b.numpy(), 2e-5, name)


def test_n_contrib_marks_last_applied_pair():
    """n_contrib is where the backward walk starts: every live pair before
    it was applied, and log T_eff is the raw log T through it."""
    s = scene_arrays(seed=5, opacity_max=0.99, spread=1.0)
    args = torch_args(s)
    pre = projection.preprocess(*args, torch_camera(), width=64, height=64, sh_degree=3)
    b = binning.bin_and_pack(
        pre.depths.detach(), pre.rect_min, pre.rect_max, pre.tiles_touched, pre.means2d.detach(),
        pre.conics.detach(), args[3], pre.colors.detach(), grid_w=GRID, grid_h=GRID,
    )
    acc, lte, nc, _ = blend.blend_fwd_plain(b.ranges, b.payload, GRID, GRID)
    assert int(nc.max()) > 0 and float(lte.min()) < -5.0  # frontier reached
    # recompute the raw log T per pixel sequentially in float64
    dxl, dyl = blend._pixel_offsets("cpu")
    for tile in (5, 6, 9, 10):
        s0, e0 = (int(v) for v in b.ranges[tile])
        pl = b.payload[:, s0:e0].double()
        tx, ty = (tile % GRID) * 16.0, (tile // GRID) * 16.0
        dx = pl[0][:, None] - (tx + dxl.double())[None]
        dy = pl[1][:, None] - (ty + dyl.double())[None]
        power = -0.5 * (pl[2][:, None] * dx * dx + pl[4][:, None] * dy * dy) - pl[3][:, None] * dx * dy
        alpha = torch.clamp_max(pl[5][:, None] * torch.exp(power), 0.99)
        live = (power <= 0) & (alpha >= 1 / 255)
        k = torch.arange(e0 - s0)[:, None]
        upto = live & (k < nc[tile].long()[None])
        raw = torch.log1p(-torch.where(upto, alpha, 0.0)).sum(0)
        np.testing.assert_allclose(raw.numpy(), lte[tile].double().numpy(), atol=1e-4)


def test_dense_reference_matches_jax_and_tiled_render():
    """The port's brute-force golden renderer against the JAX one, and the
    port's tiled render against it (the bars of test_render.py's
    test_tiled_matches_dense)."""
    from gsdf_slam_tpu.ops import RasterizeConfig as JCfg
    from gsdf_slam_tpu.ops.rasterize import render_dense_reference as j_dense
    from gsdf_slam_tpu_torch.ops import RasterizeConfig, render
    from gsdf_slam_tpu_torch.ops.rasterize import render_dense_reference

    s = scene_arrays()
    cfg = RasterizeConfig(height=64, width=64)
    img_j, ft_j = j_dense(*jax_args(s), jax_camera(), jnp.asarray(s["bg"]),
                          JCfg(height=64, width=64, max_pairs=4096, chunk=128))
    img_d, ft_d = render_dense_reference(*torch_args(s), torch_camera(), torch.from_numpy(s["bg"]), cfg)
    np.testing.assert_allclose(img_d.numpy(), np.asarray(img_j), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(ft_d.numpy(), np.asarray(ft_j), atol=2e-5, rtol=1e-4)
    out = render(*torch_args(s), torch_camera(), torch.from_numpy(s["bg"]), cfg)
    np.testing.assert_allclose(out.image.numpy(), img_d.numpy(), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(out.final_t.numpy(), ft_d.numpy(), atol=2e-5, rtol=1e-4)
