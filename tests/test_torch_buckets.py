"""The bucket checkpoints and K2's bucket form, on the CPU.

K1 and K4 store each pixel's running state (log T and the colour sums) at
every 32nd pair of its tile; K2 starts each 32-pair bucket from them and
takes the suffix of later colour as accum minus the colour through the
pair. Here the plain versions of both are held to what they stand for:

- a checkpoint at bucket b is the render of the tile's first 32b pairs
  (every tile's end cut to start + 32b), where K2 reads it (32b <
  n_contrib), and K4's plain checkpoints are K1's;
- the bucket-form backward against K2's former per-pixel formulation (the
  suffix carried back from each pixel's n_contrib), kept here as
  `_per_pixel_bwd`, and against the JAX production VJP
  (`blend_tiles_grouped_fused`, interpret mode, group 8).

Scenes: the opaque 64x64 test scene, the wall (32x32, every pixel past
T = 1e-4 within one bucket), the saturating scene of
tests/test_binning_cache.py (32x32, up to 256 applied pairs a pixel), and
direct binnings with tiles of 1, 32, 33 and 300 pairs. Bars: 5e-6
absolute for colour and T (the image bar of tests/test_pallas_blend.py),
2e-5 for gradients after scaling per field (its gradient bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_binning_cache import _saturating_scene
from torch_port_helpers import assert_scaled_close, scene_arrays, synthetic_binning, torch_args, torch_camera

from gsdf_slam_tpu.ops import CameraMatrices as JCam
from gsdf_slam_tpu.ops import pallas_blend_grouped as jpbg
from gsdf_slam_tpu.ops import projection as jproj
from gsdf_slam_tpu_torch.ops import CameraMatrices, binning, blend, preprocess, projection, tile_blend
from gsdf_slam_tpu_torch.probes.scene import wall_arrays

BAR = 5e-6
GRAD_BAR = 2e-5
FIELDS = {"means2d": slice(0, 2), "conics": slice(2, 5), "opacity": slice(5, 6), "colors": slice(6, 9)}
KEYS = ("means", "scales", "quats", "opac", "dc", "sh_rest")
TILE_COUNTS = (1, 32, 33, 300)


def _arrays(scene):
    """(preprocess arguments as numpy, image size)."""
    if scene == "render64":
        s = scene_arrays(seed=5, opacity_max=0.99, spread=1.0)
        n = int(s["alive"].sum())
        return [s[k][:n] for k in KEYS], 64
    if scene == "wall":
        w = wall_arrays()
        return [w[k] for k in KEYS], 32
    return list(_saturating_scene()[:6]), 32


def _camera(scene):
    if scene == "render64":
        return torch_camera()
    return CameraMatrices.from_pose(np.array([1.0, 0, 0, 0]), np.zeros(3), np.pi / 2, np.pi / 2, device="cpu")


def _binned(scene):
    """(ranges, payload, gid, Gaussians, grid side) of a scene, K3's
    binning or a direct one."""
    if scene in ("sparse", "dense"):
        kw = {} if scene == "sparse" else dict(opacity=(0.5, 0.99))
        return (*synthetic_binning(TILE_COUNTS, 2, **kw), 2)
    arrays, size = _arrays(scene)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    g = size // 16
    with torch.no_grad():
        pre = preprocess(*args, _camera(scene), width=size, height=size, sh_degree=3)
        b = binning.bin_and_pack(pre.depths, pre.rect_min, pre.rect_max, pre.tiles_touched, pre.means2d,
                                 pre.conics, args[3], pre.colors, grid_w=g, grid_h=g)
    return b.ranges, b.payload, b.gid, args[0].shape[0], g


def _cotangents(nt, seed=0):
    rng = np.random.default_rng(seed)
    ct_a = rng.standard_normal((nt, 256, 3)).astype(np.float32)
    ct_t = rng.standard_normal((nt, 256)).astype(np.float32)
    return torch.from_numpy(ct_a), torch.from_numpy(ct_t)


def _cut(ranges, payload, n):
    """The binning with every tile's end cut to start + n."""
    count = torch.clamp_max(ranges[:, 1] - ranges[:, 0], n)
    _, local = blend.pair_tiles(ranges, payload.shape[1])
    kept = local < n
    end = torch.cumsum(count, 0)
    return torch.stack([end - count, end], 1).to(torch.int32), payload[:, kept]


def _per_pixel_bwd(ranges, payload, gid, log_t_eff, n_contrib, ct_accum, ct_log_t_eff, num_gaussians, grid_w,
                   grid_h):
    """K2's former formulation: each pixel walks back from its n_contrib,
    rebuilds log T backwards from log T_eff and carries the suffix sum of
    w * (c . ct) (chunked, float64 within a chunk)."""
    num_tiles = grid_w * grid_h
    m = payload.shape[1]
    dxl, dyl = blend._pixel_offsets("cpu")
    grads = torch.zeros((num_gaussians, 9))
    tile, local = blend.pair_tiles(ranges, m)
    log_end = log_t_eff.clone()
    suffix = torch.zeros((num_tiles, 256))
    for s in reversed(range(0, m, blend.PLAIN_CHUNK)):
        t = tile[s : s + blend.PLAIN_CHUNK]
        pl = payload[:, s : s + blend.PLAIN_CHUNK]
        alpha, live, g, dx, dy = blend._geometry(pl, t, grid_w, dxl, dyl)
        applied = live & (local[s : s + blend.PLAIN_CHUNK][:, None] < n_contrib[t])
        alpha = torch.where(applied, alpha, 0.0)
        log1m = torch.log1p(-alpha)
        log_start = log_end.index_add(0, t, -log1m)
        seg = blend._segment_starts(t)
        excl, _ = blend._segmented_prefix(log1m, seg)
        t_excl = torch.exp(log_start[t] + excl.to(torch.float32))
        w = torch.where(applied, alpha * t_excl, 0.0)
        col = pl[6:9]
        ct = ct_accum[t]
        dot_c = col[0][:, None] * ct[..., 0] + col[1][:, None] * ct[..., 1] + col[2][:, None] * ct[..., 2]
        wc = w * dot_c
        _, in_seg_incl = blend._segmented_prefix(wc, seg)
        seg_total = torch.zeros((num_tiles, 256), dtype=torch.float64)
        seg_total.index_add_(0, t, wc.to(torch.float64))
        sfx = (seg_total[t] - in_seg_incl).to(torch.float32) + suffix[t]
        dl_dalpha = torch.where(applied, t_excl * dot_c - (sfx + ct_log_t_eff[t]) / (1.0 - alpha), 0.0)
        a, b, c, op = (pl[i][:, None] for i in range(2, 6))
        dl_dg = op * dl_dalpha
        gdx, gdy = g * dx, g * dy
        pair = torch.stack([
            torch.sum(dl_dg * (-gdx * a - gdy * b), 1), torch.sum(dl_dg * (-gdy * c - gdx * b), 1),
            torch.sum(dl_dg * (-0.5 * g * dx * dx), 1), torch.sum(dl_dg * (-g * dx * dy), 1),
            torch.sum(dl_dg * (-0.5 * g * dy * dy), 1), torch.sum(g * dl_dalpha, 1),
            torch.sum(w * ct[..., 0], 1), torch.sum(w * ct[..., 1], 1), torch.sum(w * ct[..., 2], 1),
        ], dim=1)
        grads.index_add_(0, gid[s : s + blend.PLAIN_CHUNK].to(torch.int64), pair)
        suffix.index_add_(0, t, wc)
        log_end = log_start
    return grads


def test_checkpoint_rows_are_distinct_and_fit():
    """Bucket b of tile t lives in row t + start_t // 32 + b: distinct rows
    below T + M // 32 for any counts, empty tiles included (as (0, 0), as
    K3 leaves them)."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        counts = rng.integers(0, 100, 12) * rng.integers(0, 2, 12)
        ends = np.cumsum(counts)
        ranges = np.stack([ends - counts, ends], 1)
        ranges[counts == 0] = 0
        ranges = torch.from_numpy(ranges.astype(np.int32))
        nb = -(-counts // 32)
        rows = np.concatenate([blend.checkpoint_first(ranges)[t].item() + np.arange(n) for t, n in enumerate(nb)])
        assert len(np.unique(rows)) == len(rows)
        assert rows.max(initial=-1) < blend.checkpoint_slots(len(counts), int(counts.sum()))


@pytest.mark.parametrize("scene", ["render64", "wall", "saturating", "sparse"])
def test_checkpoints_are_shorter_renders(scene):
    ranges, payload, _, _, g = _binned(scene)
    acc, lte, nc, ckpt = blend.blend_fwd_plain(ranges, payload, g, g)
    *k4, ckpt4, _ = blend.blend_fwd_plain(ranges, payload, g, g, keep_margin=10.0)
    assert torch.equal(ckpt4, ckpt) and all(torch.equal(a, b) for a, b in zip(k4, (acc, lte, nc)))
    tile, b, rows = blend.live_buckets(ranges, nc)
    inside = 0
    for bb in torch.unique(b).tolist():
        acc_c, lte_c, *_ = blend.blend_fwd_plain(*_cut(ranges, payload, blend.BUCKET * bb), g, g)
        at = b == bb
        t = tile[at]
        read = blend.BUCKET * bb < nc[t]  # the pixels K2 starts here
        got = ckpt[rows[at]][read]
        np.testing.assert_allclose(got[:, 1:].numpy(), acc_c[t][read].numpy(), atol=BAR, rtol=0)
        np.testing.assert_allclose(np.exp(got[:, 0].numpy()), np.exp(lte_c[t][read].numpy()), atol=BAR, rtol=0)
        if bb:
            inside += int((read & (nc[t] < blend.BUCKET * (bb + 1))).sum())
    # a pixel whose applied pairs end inside a later bucket (the wall's
    # pixels all end in the first)
    assert scene == "wall" or inside > 0


@pytest.mark.parametrize("scene", ["render64", "wall", "saturating", "sparse", "dense"])
def test_bucket_bwd_matches_per_pixel(scene):
    ranges, payload, gid, p, g = _binned(scene)
    acc, lte, nc, ckpt = blend.blend_fwd_plain(ranges, payload, g, g)
    ct_a, ct_t = _cotangents(g * g)
    got = blend.blend_bwd_plain(ranges, payload, gid, acc, nc, ckpt, ct_a, ct_t, p, g, g)
    counts = blend.bucket_counts(ranges, payload, nc, g)
    want = _per_pixel_bwd(ranges, payload, gid, lte, nc, ct_a, ct_t, p, g, g)
    for name, rows in FIELDS.items():
        assert_scaled_close(want[:, rows].numpy(), got[:, rows].numpy(), GRAD_BAR, name)
    assert counts["live_buckets"] == int(((nc.amax(1) + 31) // 32).sum())
    assert 0 < counts["taken"] <= payload.shape[1] and counts["applied"] >= counts["taken"]


@pytest.mark.parametrize("scene", ["wall", "saturating"])
def test_bucket_bwd_matches_jax_vjp(scene):
    """FreshBlend's backward (the bucket form) against the VJP of the JAX
    production blend on the scenes that saturate."""
    arrays, size = _arrays(scene)
    g = size // 16
    jcam = JCam.from_pose(np.array([1.0, 0, 0, 0]), np.zeros(3), np.pi / 2, np.pi / 2)
    jargs = [jnp.asarray(a) for a in arrays] + [jnp.ones(arrays[0].shape[0], bool)]
    pre = jax.jit(lambda *a: jproj.preprocess(*a[:7], a[7], width=size, height=size, sh_degree=3))(*jargs, jcam)
    op = jnp.asarray(arrays[3])
    ct_acc, ct_lte = (x.numpy() for x in _cotangents(g * g, seed=11))

    def run(m2, con, o, col):
        acc, lte, _ = jpbg.blend_tiles_grouped_fused(pre._replace(means2d=m2, conics=con, colors=col), o,
                                                     grid_w=g, grid_h=g, max_pairs=4096, chunk=128, group=8)
        return acc, lte

    (acc_j, lte_j), vjp = jax.vjp(run, pre.means2d, pre.conics, op, pre.colors)
    grads_j = vjp((jnp.asarray(ct_acc), jnp.asarray(ct_lte)))

    t = lambda a: torch.from_numpy(np.asarray(a).copy())
    diff = [t(pre.means2d).requires_grad_(True), t(pre.conics).requires_grad_(True), t(op).requires_grad_(True),
            t(pre.colors).requires_grad_(True)]
    tpre = projection.Preprocessed(
        means2d=diff[0], depths=t(pre.depths), conics=diff[1], colors=diff[3], radii=t(pre.radii),
        rect_min=t(pre.rect_min), rect_max=t(pre.rect_max), tiles_touched=t(pre.tiles_touched))
    acc, lte, _ = tile_blend.blend_tiles_fresh(tpre, diff[2], grid_w=g, grid_h=g)
    np.testing.assert_allclose(acc.detach().numpy(), np.asarray(acc_j), atol=BAR)
    np.testing.assert_allclose(np.exp(lte.detach().numpy()), np.exp(np.asarray(lte_j)), atol=BAR)
    grads_t = torch.autograd.grad((acc * t(ct_acc)).sum() + (lte * t(ct_lte)).sum(), diff)
    for name, a, b in zip(FIELDS, grads_j, grads_t):
        assert_scaled_close(np.asarray(a), b.numpy(), GRAD_BAR, name)
