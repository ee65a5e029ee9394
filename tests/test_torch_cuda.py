"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda` and skipped without a GPU. This file imports no jax, so it
also runs where jax is not installed:

    GSDF_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch
from torch_port_helpers import (
    BINNING_CASES, EXPORT_BINNINGS, FOV, POSE, WINDOW_EDGE_CASES, crafted_binning, crafted_preprocess_rows,
    export_binning, new_points,
    pair2_binning, scene_arrays, surgery_extent, surgery_model, synthetic_binning, torch_args, window_edge_case,
)

from gsdf_slam_tpu_torch import kernels
from gsdf_slam_tpu_torch.config import OptimizationParams
from gsdf_slam_tpu_torch.convert import copy_state
from gsdf_slam_tpu_torch.engine import render_depth_state, train_step
from gsdf_slam_tpu_torch.models import gaussian_model as surgery
from gsdf_slam_tpu_torch.models import AdamState, GaussianModel, group_lrs
from gsdf_slam_tpu_torch.ops import (
    CameraMatrices, RasterizeConfig, binning, blend, blend_probe, losses, pair_table, preprocess, projection, render,
    tile_blend,
)
from gsdf_slam_tpu_torch.data import colorize_frame
from gsdf_slam_tpu_torch.ops.colorize import colorize_pointcloud
from gsdf_slam_tpu_torch.probes import checks, expand_probe, microbench
from gsdf_slam_tpu_torch.probes.scene import (
    HEIGHT, KITTI_HEIGHT, KITTI_WIDTH, PREPROCESS_SIZES, STREET_SIZES, WALL_SIZE, WIDTH, headline_camera,
    headline_scene, kitti_camera, preprocess_args, street_scene, wall_scene,
)
from gsdf_slam_tpu_torch.probes.synthetic_outdoor import drive_pose, kitti_calibration, lidar_scan, raycast_outdoor
from gsdf_slam_tpu_torch.probes.synthetic_room import make_sequence
from gsdf_slam_tpu_torch.stream import run_stream

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _camera(device):
    return CameraMatrices.from_pose(*POSE, FOV, FOV, device=device)


@pytest.fixture(scope="module")
def staged(dev):
    s = scene_arrays(seed=5, opacity_max=0.99, spread=1.0)
    args = [a.to(dev) for a in torch_args(s)]
    pre = preprocess(*args, _camera(dev), width=64, height=64, sh_degree=3)
    keys, order, pair_gid, _ = binning.expand_and_sort(
        pre.depths, pre.rect_min, pre.rect_max, pre.tiles_touched, pre.means2d.detach(),
        pre.conics.detach(), args[3], grid_w=4)
    table = binning.payload_table(pre.means2d.detach(), pre.conics.detach(), args[3], pre.colors.detach())
    return (keys >> 32).to(torch.int32), order, pair_gid, table, args[0].shape[0]


def test_k3_bit_equal(staged):
    tiles, order, pair_gid, table, _ = staged
    got = binning.tile_ranges_pack(tiles, order, pair_gid, table, 16)
    want = binning.tile_ranges_pack_plain(tiles, order, pair_gid, table, 16)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _blend_matches_plain(ranges, payload, gid, p, g):
    """K1 (with its checkpoints) and K2 against their plain versions on one
    binning, at the bars of the 64x64 checks (checks.FWD_SMALL for colour
    and T, checks.BWD_SMALL for gradients scaled per field)."""
    acc, lte, nc, ckpt = tile_blend.blend_fwd(ranges, payload, g, g)
    acc_p, lte_p, nc_p, ckpt_p = blend.blend_fwd_plain(ranges, payload, g, g)
    torch.cuda.synchronize()
    assert float((acc - acc_p).abs().max()) <= checks.FWD_SMALL
    assert float((lte.exp() - lte_p.exp()).abs().max()) <= checks.FWD_SMALL
    assert torch.equal(nc, nc_p)
    c_err, t_err, _, words = checks.checkpoint_check(ckpt, ckpt_p, ranges, nc, nc_p)
    assert words > 0 and c_err <= checks.FWD_SMALL and t_err <= checks.FWD_SMALL, (c_err, t_err)
    # K1 writes exactly the words K2 reads: launched into a NaN-filled buffer
    assert checks.checkpoint_words_written(ranges, payload, g, ckpt.shape) == words
    # K4: K1's outputs and checkpoints bit for bit, its keep flags the plain ones
    acc4, lte4, nc4, ckpt4, keep = tile_blend.blend_fwd_export(ranges, payload, g, g, 10.0)
    keep_p = blend.blend_fwd_plain(ranges, payload, g, g, keep_margin=10.0)[-1]
    torch.cuda.synchronize()
    assert torch.equal(acc4, acc) and torch.equal(lte4, lte) and torch.equal(nc4, nc)
    assert checks.checkpoint_check(ckpt4, ckpt, ranges, nc4, nc)[2] and torch.equal(keep, keep_p)
    gen = torch.Generator(device=acc.device).manual_seed(0)
    ct_a = torch.randn(acc.shape, generator=gen, device=acc.device)
    ct_t = 0.1 * torch.randn(lte.shape, generator=gen, device=acc.device)
    a = (ranges, payload, gid, acc_p, nc_p, ckpt_p, ct_a, ct_t, p, g, g)
    got = tile_blend.blend_bwd(*a)
    want = blend.blend_bwd_plain(*a)
    torch.cuda.synchronize()
    errs = checks.scaled_errors(got.t(), want.t())
    assert all(e <= checks.BWD_SMALL for e in errs.values()), errs
    # K2 from the kernel's own forward
    got_k = tile_blend.blend_bwd(ranges, payload, gid, acc, nc, ckpt, ct_a, ct_t, p, g, g)
    torch.cuda.synchronize()
    errs = checks.scaled_errors(got_k.t(), want.t())
    assert all(e <= checks.BWD_SMALL for e in errs.values()), errs


def test_k1_k2_match_plain(staged):
    tiles, order, pair_gid, table, p = staged
    ranges, gid, payload = binning.tile_ranges_pack(tiles, order, pair_gid, table, 16)
    _blend_matches_plain(ranges, payload, gid, p, 4)


@pytest.mark.parametrize("opacity", [(0.05, 0.3), (0.5, 0.99)])
def test_k1_k2_on_tiles_of_1_32_33_300_pairs(dev, opacity):
    """Buckets of one pair, a full bucket, a bucket and one pair, and a tile
    whose pixels run past 256 pairs, so that warps take a second bucket."""
    ranges, payload, gid, p = (x.to(dev) if torch.is_tensor(x) else x
                               for x in synthetic_binning((1, 32, 33, 300), 2, opacity=opacity))
    _blend_matches_plain(ranges, payload, gid, p, 2)


def _wall_binned(dev):
    """K3's binning of the wall (32x32) and its Gaussian count."""
    args, cam = wall_scene(dev)
    g = WALL_SIZE // 16
    with torch.no_grad():
        pre = preprocess(*args, cam, width=WALL_SIZE, height=WALL_SIZE, sh_degree=3)
        b = binning.bin_and_pack(pre.depths, pre.rect_min, pre.rect_max, pre.tiles_touched, pre.means2d,
                                 pre.conics, args[3], pre.colors, grid_w=g, grid_h=g)
    return b, args[0].shape[0]


def test_k1_k2_on_the_wall(dev):
    b, p = _wall_binned(dev)
    _blend_matches_plain(b.ranges, b.payload, b.gid, p, WALL_SIZE // 16)


K4_BINNINGS = ("staged64", "sparse", "dense", "wall", *EXPORT_BINNINGS)


def _k4_binning(name, dev, staged):
    """(ranges, payload, grid_w, grid_h) on the card: K3's binning of the
    opaque 64x64 scene, the tiles of 1/32/33/300 pairs at both opacities,
    the wall, and the one-tile binnings of EXPORT_BINNINGS (the phase
    switch across the batch barrier; the block's exit vote)."""
    if name == "staged64":
        tiles, order, pair_gid, table, _ = staged
        ranges, _, payload = binning.tile_ranges_pack(tiles, order, pair_gid, table, 16)
        return ranges, payload, 4, 4
    if name == "wall":
        b, _ = _wall_binned(dev)
        return b.ranges, b.payload, WALL_SIZE // 16, WALL_SIZE // 16
    if name in EXPORT_BINNINGS:
        ranges, payload, _, _ = export_binning(name)
        return ranges.to(dev), payload.to(dev), 1, 1
    kw = {} if name == "sparse" else dict(opacity=(0.5, 0.99))
    ranges, payload, _, _ = synthetic_binning((1, 32, 33, 300), 2, **kw)
    return ranges.to(dev), payload.to(dev), 2, 2


@pytest.mark.parametrize("margin", [1.0, 10.0, 1e4])
@pytest.mark.parametrize("name", K4_BINNINGS)
def test_k4_bit_equal_to_k1_and_keep_matches_plain(staged, dev, name, margin):
    """K4 bit-equal to K1, checkpoints included, and its keep flags equal
    to the plain ones, with every byte of keep written by the kernel;
    margin 1e4 walks the band to the tile's end."""
    ranges, payload, gw, gh = _k4_binning(name, dev, staged)
    *k1, ckpt1 = tile_blend.blend_fwd(ranges, payload, gw, gh)
    *k4, ckpt4, keep = tile_blend.blend_fwd_export(ranges, payload, gw, gh, margin)
    *_, keep_p = blend.blend_fwd_plain(ranges, payload, gw, gh, keep_margin=margin)
    written = checks.keep_bytes(ranges, payload, gw, margin)
    torch.cuda.synchronize()
    for a, b in zip(k1, k4):
        assert torch.equal(a, b)
    assert checks.checkpoint_check(ckpt4, ckpt1, ranges, k1[2], k4[2])[2]
    assert torch.equal(keep, keep_p)
    assert torch.equal(written, keep_p.to(torch.uint8))


def test_k4_log1p_is_log1pf_on_every_live_alpha(dev):
    """K4's log1p for live alphas equals log1pf(-alpha) bit for bit on all
    float32 alphas in [1/255, 0.99], so K4's log T is K1's."""
    assert checks.log1p_live_mismatches() == 0


def test_render_gradients_match_cpu(dev):
    """The whole render on the card against the CPU (plain versions)."""
    s = scene_arrays()
    outs = {}
    for d in ("cpu", dev):
        params = [a.to(d).requires_grad_(True) for a in torch_args(s)]
        cam = _camera(d)
        kernels.reset_launch_counts()
        out = render(*params, cam, torch.from_numpy(s["bg"]).to(d), RasterizeConfig(64, 64))
        loss = (out.image ** 2).sum() + 0.1 * out.final_t.sum()
        grads = torch.autograd.grad(loss, params)
        outs[str(d)] = (out.image.detach().cpu(), [x.cpu() for x in grads], dict(kernels.LAUNCHES))
    (img_c, g_c, n_c), (img_g, g_g, n_g) = outs["cpu"], outs[str(dev)]
    assert n_c == dict.fromkeys(kernels.LAUNCHES, 0)
    assert n_g == {**dict.fromkeys(kernels.LAUNCHES, 0), "tile_ranges_pack": 1, "blend_fwd": 1, "blend_bwd": 1,
                   "preprocess_fwd": 1, "preprocess_bwd": 1, "bin_count": 1, "bin_write": 1}
    assert float((img_c - img_g).abs().max()) <= 5e-6
    for a, b in zip(g_c, g_g):
        assert float((a - b).abs().max()) / max(float(a.abs().max()), 1e-4) <= 2e-5


# ---- the binning's route on the card (bin_count, bin_write, the tile sort,
# K3) against the plain route (probes/checks.py::binning_check)
def _binning_inputs(pre, opacities):
    return (pre.depths.detach(), pre.rect_min, pre.rect_max, pre.tiles_touched, pre.means2d.detach(),
            pre.conics.detach(), opacities, pre.colors.detach())


@pytest.mark.parametrize("scene", ["headline", "polish", "drive"])
def test_binning_route_bit_equal_at_the_cells_sizes(dev, scene):
    """The headline (400k Gaussians at 1200x680, 3,225 tiles) and the cells'
    loads (probes/scene.py::street_scene: 0.63M and 2.0M Gaussians at
    KITTI's 1226x370, 1,848 tiles, binning about the 5.4M and 7.5M pre-cull
    pairs of the polish's and the drive's steps): `Binned` bit-equal to the
    plain route's, and each pass to its plain version."""
    if scene == "headline":
        args, cam, (w, h) = preprocess_args(headline_scene(dev)), headline_camera(dev), (WIDTH, HEIGHT)
        least = 100_000
    else:
        n, pairs, mult = STREET_SIZES[scene]
        args, cam, (w, h) = street_scene(dev, n, mult), kitti_camera(dev), (KITTI_WIDTH, KITTI_HEIGHT)
        least = int(0.9 * pairs)
    with torch.no_grad():
        pre = preprocess(*args, cam, width=w, height=h, sh_degree=3)
    gw, gh = projection.tile_grid(w, h)
    res = checks.binning_check(*_binning_inputs(pre, args[3]), grid_w=gw, grid_h=gh)
    assert res["ok"] and res["total_pairs"] >= least, res


@pytest.mark.parametrize("grid", [(77, 24), (200, 203)])
@pytest.mark.parametrize("case", BINNING_CASES)
def test_binning_route_bit_equal_on_crafted_rows(dev, case, grid):
    """tests/torch_port_helpers.py::crafted_binning at KITTI's grid and past
    32,767 tiles (3,200x2,600 px, 40,600 tiles: tile ids past 16 bits):
    rects spanning the grid, one tile wide or tall, of zero width; means on
    tile edges; opacity at 1/255 and one ulp below; equal and negative depth
    bits; a 0 / 0 in the cull; no visible Gaussian; every pair culled."""
    arrays, (gw, gh) = crafted_binning(case, grid=grid)
    a = [torch.from_numpy(arrays[k]).to(dev) for k in ("depths", "rect_min", "rect_max", "tiles_touched", "means2d",
                                                        "conics", "opacities", "colors")]
    res = checks.binning_check(*a, grid_w=gw, grid_h=gh)
    assert res["ok"], res
    assert (res["pairs"] > 1848) if case == "crafted" else (res["pairs"] == 0)


def test_binning_kernels_launch_once_a_binning(dev):
    """bin_count and bin_write launch once on every fresh and export step,
    as K3 does, and never on a cached one."""
    model, adam = copy_state(*surgery_model("64x64"), dev)
    cam = _camera(dev)
    cfg = RasterizeConfig(64, 64)
    gt = torch.rand((64, 64, 3), generator=torch.Generator(device=dev).manual_seed(4), device=dev)
    bg = torch.zeros(3, device=dev)
    seen = []
    cache = None
    for it, kind in enumerate(("fresh", "export", "cached", "fresh")):
        kernels.reset_launch_counts()
        if kind == "export":
            _, cache = train_step(model, adam, cam, gt, None, bg, it, 1.0, cfg, OptimizationParams(),
                                  export_binning_cache=True)
        else:
            train_step(model, adam, cam, gt, None, bg, it, 1.0, cfg, OptimizationParams(),
                       binning_cache=cache if kind == "cached" else None)
        torch.cuda.synchronize()
        seen.append((kernels.LAUNCHES["bin_count"], kernels.LAUNCHES["bin_write"],
                     kernels.LAUNCHES["tile_ranges_pack"]))
    assert seen == [(1, 1, 1), (1, 1, 1), (0, 0, 0), (1, 1, 1)], seen


# ------------------------------------------------------------------ probes
@pytest.fixture(scope="module", params=["opaque64", "wall32"])
def probe_binned(dev, request):
    """K3's binning of the opaque 64x64 scene and of the wall (32x32), where
    the chunk exit fires."""
    if request.param == "wall32":
        args, cam = wall_scene(dev)
        size = WALL_SIZE
    else:
        s = scene_arrays(seed=5, opacity_max=0.99, spread=1.0)
        args, cam, size = [a.to(dev) for a in torch_args(s)], _camera(dev), 64
    g = size // 16
    with torch.no_grad():
        pre = preprocess(*args, cam, width=size, height=size, sh_degree=3)
        b = binning.bin_and_pack(pre.depths, pre.rect_min, pre.rect_max, pre.tiles_touched, pre.means2d,
                                 pre.conics, args[3], pre.colors, grid_w=g, grid_h=g)
    return b, g


@pytest.mark.parametrize("chunk", [128, 16])
@pytest.mark.parametrize("mode", blend_probe.FWD_MODES)
def test_probe_fwd_matches_plain(probe_binned, mode, chunk):
    b, g = probe_binned
    got = blend_probe.blend_probe_fwd(b.ranges, b.payload, g, g, mode, chunk)
    want = blend_probe.blend_probe_fwd_plain(b.ranges, b.payload, g, g, mode, chunk)
    torch.cuda.synchronize()
    errs, failed = checks.fwd_check(mode, got, want, b.payload, b.ranges, checks.FWD_SMALL)
    assert not failed, errs


@pytest.mark.parametrize("chunk", [128, 16])
def test_probe_pair2_matches_plain_and_chunk_exit(probe_binned, chunk):
    b, g = probe_binned
    got = blend_probe.blend_probe_fwd_pair2(b.ranges, b.payload, g, g, chunk)
    want = blend_probe.blend_probe_fwd_pair2_plain(b.ranges, b.payload, g, g, chunk)
    single = blend_probe.blend_probe_fwd(b.ranges, b.payload, g, g, "chunk_exit", chunk)
    torch.cuda.synchronize()
    errs, failed = checks.pair2_check(got, want, single, b.payload, b.ranges, checks.FWD_SMALL)
    assert not failed, errs


@pytest.mark.parametrize("chunk", [128, 16])
def test_probe_bwd_matches_plain(probe_binned, chunk):
    b, g = probe_binned
    _, _, raw, nd = blend_probe.blend_probe_fwd_plain(b.ranges, b.payload, g, g, "chunk_exit", chunk)
    gen = torch.Generator(device=raw.device).manual_seed(0)
    ct_a = torch.randn(raw.shape + (3,), generator=gen, device=raw.device)
    ct_t = torch.randn(raw.shape, generator=gen, device=raw.device)
    a = (b.ranges, b.payload, nd, raw, ct_a, ct_t, g, g, chunk)
    got = blend_probe.blend_probe_bwd(*a)
    want = blend_probe.blend_probe_bwd_plain(*a)
    again = blend_probe.blend_probe_bwd(*a)
    torch.cuda.synchronize()
    errs, failed = checks.bwd_check(got, again, want, checks.BWD_SMALL)
    assert not failed, errs


def _direct_binning(name, dev):
    """(ranges, payload, gid, Gaussian count, grid side) on the card: the
    tiles of 1, 32, 33 and 300 pairs at two opacities (2x2), or a one-tile
    binning of EXPORT_BINNINGS (600 faint pairs, whose walk crosses many
    32-pair groups; 800 opaque ones, whose chunk exit fires)."""
    if name in EXPORT_BINNINGS:
        out, g = export_binning(name), 1
    else:
        out, g = synthetic_binning((1, 32, 33, 300), 2, **({} if name == "sparse" else dict(opacity=(0.5, 0.99)))), 2
    ranges, payload, gid, p = out
    return ranges.to(dev), payload.to(dev), gid.to(dev), p, g


@pytest.mark.parametrize("chunk", [128, 16])
@pytest.mark.parametrize("name", ["sparse", "dense", *EXPORT_BINNINGS])
def test_probe_bwd_on_direct_binnings(dev, name, chunk):
    """The pixel ring of blend_probe_bwd on walks of 1, 32, 33 and 300 pairs
    (groups of one pair, a full group, a group and one pair, many groups)
    and on one tile whose walk crosses many groups, at chunks that do not
    line up with the 32-pair groups: within BWD_SMALL of the plain version,
    two launches bit-equal, and folded per Gaussian within K2's bar of K2."""
    ranges, payload, gid, p, g = _direct_binning(name, dev)
    _, _, raw, nd = blend_probe.blend_probe_fwd_plain(ranges, payload, g, g, "chunk_exit", chunk)
    gen = torch.Generator(device=dev).manual_seed(0)
    ct_a = torch.randn(raw.shape + (3,), generator=gen, device=dev)
    ct_t = torch.randn(raw.shape, generator=gen, device=dev)
    a = (ranges, payload, nd, raw, ct_a, ct_t, g, g, chunk)
    got = blend_probe.blend_probe_bwd(*a)
    again = blend_probe.blend_probe_bwd(*a)
    want = blend_probe.blend_probe_bwd_plain(*a)
    acc, _, nc, ckpt = blend.blend_fwd_plain(ranges, payload, g, g)
    k2 = tile_blend.blend_bwd(ranges, payload, gid, acc, nc, ckpt, ct_a, ct_t, p, g, g)
    folded = torch.zeros_like(k2).index_add_(0, gid.to(torch.int64), got.t())
    torch.cuda.synchronize()
    errs, failed = checks.bwd_check(got, again, want, checks.BWD_SMALL)
    assert not failed, errs
    fold = checks.scaled_errors(folded.t(), k2.t())
    assert all(e <= checks.BWD_SMALL for e in fold.values()), fold


@pytest.mark.parametrize("chunk", [128, 16])
@pytest.mark.parametrize("name", ["sparse", "dense", *EXPORT_BINNINGS])
@pytest.mark.parametrize("mode", blend_probe.FWD_MODES)
def test_probe_fwd_on_direct_binnings(dev, mode, name, chunk):
    """Each forward mode on walks of 1, 32, 33 and 300 pairs (a lone pair, a
    full chunk of 16 or 32, a partial last chunk, many chunks), on 600
    faint pairs and on 800 opaque ones whose chunk exit fires: within
    FWD_SMALL of the plain version, n_done exact."""
    ranges, payload, _, _, g = _direct_binning(name, dev)
    got = blend_probe.blend_probe_fwd(ranges, payload, g, g, mode, chunk)
    want = blend_probe.blend_probe_fwd_plain(ranges, payload, g, g, mode, chunk)
    torch.cuda.synchronize()
    errs, failed = checks.fwd_check(mode, got, want, payload, ranges, checks.FWD_SMALL)
    assert not failed, errs


@pytest.mark.parametrize("chunk", [128, 16])
def test_probe_pair2_odd_row_one_tile_exits_first(dev, chunk):
    """pair2 on three tiles: a pair whose first tile exits chunks before its
    partner, and a last tile with no partner; bit-equal to the chunk_exit
    kernel with the pair's n_done, and within FWD_SMALL of the plain
    version."""
    ranges, payload = (x.to(dev) for x in pair2_binning())
    got = blend_probe.blend_probe_fwd_pair2(ranges, payload, 3, 1, chunk)
    want = blend_probe.blend_probe_fwd_pair2_plain(ranges, payload, 3, 1, chunk)
    single = blend_probe.blend_probe_fwd(ranges, payload, 3, 1, "chunk_exit", chunk)
    torch.cuda.synchronize()
    errs, failed = checks.pair2_check(got, want, single, payload, ranges, checks.FWD_SMALL)
    assert not failed, errs
    nd = single[3].tolist()
    assert nd[0] < nd[1]
    assert got[3].tolist() == [nd[1], nd[1], nd[2]]


def test_expand_gather_bit_equal(dev):
    table, rank, g0, lr = (torch.from_numpy(a).to(dev) for a in expand_probe.build(4096, 1500)[:4])
    got = blend_probe.expand_gather(table, g0, lr)
    torch.cuda.synchronize()
    assert checks.bit_equal(got, table[:, rank.to(torch.int64)])


# ------------------------------------------------------------- pair table
@pytest.mark.parametrize("mp", [8192, 393_216])
def test_realign_copy_bit_equal(dev, mp):
    tbl, src, mpa = microbench.realign_inputs(mp)
    tbl, src = torch.from_numpy(tbl).to(dev), torch.from_numpy(src).to(dev)
    got = pair_table.realign_copy(tbl, src, mpa)
    torch.cuda.synchronize()
    assert checks.bit_equal(got, pair_table.realign_copy_plain(tbl, src, mpa))


def test_realign_copy_ragged(dev):
    """The last group's last chunk runs past the end of src (read as 0), the
    output ends inside a 128-lane chunk, an empty group shares the next
    group's dst0, and a group starts past mpa."""
    src = torch.randn((16, 1000), generator=torch.Generator().manual_seed(0)).to(dev)
    tbl = torch.tensor([[5, 300, 300, 900, 10], [0, 256, 256, 512, 1024], [2, 0, 2, 2, 1]],
                       dtype=torch.int32, device=dev)
    for mpa in (900, 1024, 1100):
        got = pair_table.realign_copy(tbl, src, mpa)
        want = pair_table.realign_copy_plain(tbl, src, mpa)
        torch.cuda.synchronize()
        assert checks.bit_equal(got, want), mpa
    assert want[:, 512:612].all() and not want[:, 612:1024].any() and want[:, 1024:].all()


def _window(kind):
    return (pair_table.WIN_ROWS, pair_table.CPC_ROWS) if kind == "rows" else (pair_table.WIN_COLS,
                                                                              pair_table.CPC_COLS)


@pytest.mark.parametrize("kind", ["rows", "cols"])
@pytest.mark.parametrize("p, mp", [(2048, 8192), (262_144, 393_216), (400_000, 1_048_576), (512, None)])
def test_window_gather_bit_equal(dev, kind, p, mp):
    """The bench's inputs at a small, the default and the headline size, and
    (mp None) a single chunk."""
    win, cpc = _window(kind)
    args = [torch.from_numpy(a).to(dev) for a in microbench.window_inputs(p, mp or cpc, win, cpc)]
    args[2][::997] += 5000  # some lanes out of their window
    kern = getattr(pair_table, f"window_gather_{kind}")
    plain = getattr(pair_table, f"window_gather_{kind}_plain")
    got = kern(*args)
    torch.cuda.synchronize()
    assert checks.bit_equal(got, plain(*args))


@pytest.mark.parametrize("kind", ["rows", "cols"])
@pytest.mark.parametrize("case", WINDOW_EDGE_CASES)
def test_window_gather_edge_cases_bit_equal(dev, kind, case):
    """A chunk wholly out of its window, negative ranks and ranks past the
    table, -0.0, infs, NaN payloads and denormals, an odd lane count and a
    ragged last block (torch_port_helpers.WINDOW_EDGE_CASES), each bit-equal
    to the plain version."""
    *arrays, win, cpc = window_edge_case(case)
    ws, table, ranks = (torch.from_numpy(a).to(dev) for a in arrays)
    got = getattr(pair_table, f"window_gather_{kind}")(ws, table, ranks, win, cpc)
    torch.cuda.synchronize()
    assert checks.bit_equal(got, getattr(pair_table, f"window_gather_{kind}_plain")(ws, table, ranks, win, cpc))


@pytest.mark.parametrize("p, mp", [(2048, 8192), (400_000, 1_048_576)])
def test_window_gather_rows_is_cols_transposed(dev, p, mp):
    """The two kernels at the rows layout's window and chunk: the rows
    output is the cols output transposed inside the window, word for word,
    and 0 where the cols output is NaN."""
    win, cpc = _window("rows")
    ws, table, ranks = (torch.from_numpy(a).to(dev) for a in microbench.window_inputs(p, mp, win, cpc))
    ranks[::997] += 5000  # some lanes out of their window
    rows = pair_table.window_gather_rows(ws, table, ranks, win, cpc)
    cols = pair_table.window_gather_cols(ws, table, ranks, win, cpc).t()
    torch.cuda.synchronize()
    local = ranks.long() - ws.long().repeat_interleave(cpc)
    inside = (local >= 0) & (local < win)
    assert 0 < int(inside.sum()) < mp
    assert checks.bit_equal(rows[inside], cols[inside])
    assert (rows[~inside].view(torch.int32) == 0).all()
    assert (cols[~inside].view(torch.int32) == 0x7FC00000).all()


@pytest.mark.parametrize("mp", [1, 511, 2047, 4 * 512, 5 * 512 + 77, 3000, 393_216, 1_048_576 + 77])
def test_xpose_cumsum_bit_equal(dev, mp):
    """A lone partial tile (1, 511), a partial second tile (2047), whole
    tiles, a masked end in scalar stores (rows not 16-byte aligned: 2637,
    1,048,653) and in 16-byte ones (3000), and look-backs across many
    windows of 32 tiles (393,216, 1,048,653)."""
    x = torch.from_numpy(microbench.xpose_inputs(mp)).to(dev)
    got = pair_table.xpose_cumsum(x)
    torch.cuda.synchronize()
    assert torch.equal(got, pair_table.xpose_cumsum_plain(x))


def test_xpose_cumsum_five_launches_agree(dev):
    """Five launches on one input give one output: a look-back that read a
    predecessor's status word before it was published would show here."""
    x = torch.from_numpy(microbench.xpose_inputs(1_048_576 + 77)).to(dev)
    outs = [pair_table.xpose_cumsum(x) for _ in range(5)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    assert torch.equal(outs[0], pair_table.xpose_cumsum_plain(x))


# ---- the preprocess kernels against the plain version on the card
# (probes/checks.py::preprocess_check's bars)

PREPROCESS_DEGREES = [(d, a) for d in range(4) for a in ((d - 1, d) if d else (d,))]


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("degree,active", PREPROCESS_DEGREES)
def test_preprocess_kernels_match_plain_at_64x64(dev, degree, active, offset):
    args = [a.to(dev) for a in torch_args(scene_arrays())]
    st = projection.PreprocessSettings(64, 64, degree, 1.0, active)
    m2d0 = torch.zeros((args[0].shape[0], 2), device=dev) if offset else None
    res = checks.preprocess_check(args, _camera(dev), st, means2d_offset=m2d0)
    assert res["ok"] and res["visible"] > 50, res


def test_preprocess_kernels_with_colors_precomp(dev):
    """The depth render's path: the colours given (strided, as its expand),
    no SH."""
    args = [a.to(dev) for a in torch_args(scene_arrays(seed=2))]
    z = args[0][:, 2].contiguous()
    st = projection.PreprocessSettings(64, 64, 3, 1.0, None)
    res = checks.preprocess_check(args, _camera(dev), st, colors_precomp=z[:, None].expand(-1, 3))
    assert res["ok"] and res["colors"] == 0.0 and "dc" not in res["grads"]["all"], res


@pytest.mark.parametrize("scene", ["headline", "polish", "drive"])
def test_preprocess_kernels_match_plain_at_the_cells_sizes(dev, scene):
    """The headline (400k Gaussians at 1200x680) and the cells' maps (0.63M
    and 2.0M Gaussians at KITTI's 1226x370), SH 3 with every band carrying
    colour; cotangents on the visible rows in K2's strided layout."""
    if scene == "headline":
        model, cam, (w, h) = headline_scene(dev), headline_camera(dev), (WIDTH, HEIGHT)
    else:
        model, cam, (w, h) = headline_scene(dev, n=PREPROCESS_SIZES[scene]), kitti_camera(dev), (KITTI_WIDTH,
                                                                                               KITTI_HEIGHT)
    res = checks.preprocess_check(preprocess_args(model), cam, projection.PreprocessSettings(w, h, 3, 1.0, None))
    assert res["ok"] and res["visible"] > 10_000, res


def test_preprocess_kernels_on_crafted_rows(dev):
    """Rows at every gate (tests/torch_port_helpers.py::crafted_preprocess_rows:
    culled, |tz| < 0.1, past the 1.3 tan fov clamp, det == 0, opacity below
    1/255, clamped colours), every field bit-equal to the plain version on
    every row, culled ones too; cotangents on every row, the depths'
    included, each group's gradients scaled on their own."""
    arrays, masks = crafted_preprocess_rows()
    args = [torch.from_numpy(a).to(dev) for a in arrays]
    groups = {k: torch.from_numpy(v).to(dev) for k, v in masks.items()}
    st = projection.PreprocessSettings(64, 64, 3, 1.0, None)
    plain = projection.preprocess_plain(*args, _camera(dev), width=64, height=64, sh_degree=3)
    cts = checks.preprocess_cotangents(plain, seed=1, visible_only=False, depths=True)
    res = checks.preprocess_check(args, _camera(dev), st, cts=cts, groups=groups)
    assert res["ok"], res


# ---- the loss kernels against the plain version on the card
# (probes/checks.py::loss_check's bars)

LOSS_SIZES = [(1226, 370), (1200, 680), (640, 480), (185, 1226)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("w,h", LOSS_SIZES)
def test_loss_kernels_match_plain(dev, w, h, masked):
    """KITTI's image, the room's, the mono mode's and a tall one; the render
    strided as the blend's; twice, bit-equal."""
    res = checks.loss_check(*checks.loss_inputs(w, h, masked, dev))
    assert res["ok"], res


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("w,h", [(7, 5), (1, 1), (33, 17), (11, 40)])
def test_loss_kernels_on_images_smaller_than_a_tile(dev, w, h, masked):
    """Images smaller than the window or a tile, and not tile multiples."""
    res = checks.loss_check(*checks.loss_inputs(w, h, masked, dev, seed=2))
    assert res["ok"], res


@pytest.mark.parametrize("masked", [False, True])
def test_loss_kernels_on_a_row_slice(dev, masked):
    """The first half of the rows of KITTI's image, as the benchmark's
    half-batch fault feeds the loss."""
    r, g, m = checks.loss_inputs(KITTI_WIDTH, KITTI_HEIGHT, masked, dev, seed=1)
    half = KITTI_HEIGHT // 2
    res = checks.loss_check(r[:half], g[:half], None if m is None else m[:half])
    assert res["ok"], res


@pytest.mark.parametrize("mask_kind", [None, "hw", "hw3"])
def test_mapper_loss_on_the_card_against_the_cpu(dev, mask_kind):
    """The autograd Function through its kernels against its plain path on
    the CPU: one launch each, the loss within 1e-6, the gradient 2e-5
    scaled, with an upstream gradient of 3."""
    r, g, m = checks.loss_inputs(96, 72, mask_kind is not None, dev, seed=4)
    if mask_kind == "hw3":
        m = torch.stack([m, m.flip(0), m.flip(1)], dim=-1)
    outs = {}
    for d in ("cpu", dev):
        leaf = r.to(d).detach().requires_grad_(True)
        kernels.reset_launch_counts()
        loss = losses.mapper_loss(leaf, g.to(d), None if m is None else m.to(d), 0.2)
        (grad,) = torch.autograd.grad(3.0 * loss, leaf)
        outs[str(d)] = (float(loss.detach()), grad.cpu(), dict(kernels.LAUNCHES))
    (l_c, g_c, n_c), (l_g, g_g, n_g) = outs["cpu"], outs[str(dev)]
    assert n_c["loss_fwd"] == n_c["loss_bwd"] == 0 and n_g["loss_fwd"] == n_g["loss_bwd"] == 1
    assert abs(l_c - l_g) <= checks.LOSS_ATOL
    assert float((g_c - g_g).abs().max()) / float(g_c.abs().max()) <= checks.BWD_SMALL


# ---- Adam: the kernel against the plain version on the card, fed the same
# host scalars (probes/checks.py::adam_check)

ADAM_SHAPES = {"xyz": (3,), "f_dc": (1, 3), "f_rest": (15, 3), "opacity": (1,), "scaling": (3,), "rotation": (4,)}


@pytest.mark.parametrize("scene", ["polish", "drive"])
def test_adam_kernel_bit_equal_at_the_cells_sizes(dev, scene):
    """The street scenes of the cells' map sizes (0.63M and 2.0M
    Gaussians), with the gradients one step's render, loss and autograd
    backward return: contiguous, p, m and v bit-equal over two steps, one
    launch a step, a clone taken before unchanged."""
    params, grads, state = checks.adam_street_inputs(dev, scene)
    res = checks.adam_check(params, grads, state, group_lrs(OptimizationParams(), 1.0, state.step))
    assert res["ok"], res
    assert all(layout[2] for layout in res["grad_layouts"].values()), res["grad_layouts"]


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("n", [1, 3, 1_000_003])
def test_adam_kernel_bit_equal_on_ragged_counts(dev, n, misaligned):
    """Counts whose groups end off a multiple of 4 elements, and tensors
    not 16-byte aligned (the kernel's element-wise path), from the first
    step with zero moments and from step 777."""
    shapes = {k: (n, *s) for k, s in ADAM_SHAPES.items()}
    lrs = group_lrs(OptimizationParams(), 2.5, 5)
    for step in (0, 776):
        params, grads, state = checks.adam_inputs(shapes, dev, seed=n, step=step, misaligned=misaligned)
        if step == 0:
            state.m, state.v = ({k: torch.zeros_like(p) for k, p in params.items()} for _ in range(2))
        res = checks.adam_check(params, grads, state, lrs)
        assert res["ok"], res


def test_adam_span_makes_no_blocking_call(dev):
    """Fresh, export and cached steps on the 64x64 scene with the span
    "step.adam" under set_sync_debug_mode("error"): no blocking call, one
    adam_step launch a step."""
    s = scene_arrays(seed=5, opacity_max=0.99, spread=1.0)
    means, scales, quats, opac, dc, rest = (a.to(dev) for a in torch_args(s))
    model = GaussianModel({"xyz": means, "f_dc": dc, "f_rest": rest,
                           "opacity": torch.logit(opac)[:, None], "scaling": torch.log(scales),
                           "rotation": quats})
    gt = torch.rand((64, 64, 3), device=dev)
    res = checks.adam_span_check(model, AdamState.init(model.params()), _camera(dev), gt, torch.zeros(3, device=dev),
                                 RasterizeConfig(height=64, width=64), OptimizationParams())
    assert res["ok"], res


# ---- model surgery on the card against the CPU, the depth render through
# K1, and a training step after each surgery (probes/checks.py's bars)

SURGERY_KINDS = ("densify_and_prune", "increase_pcd", "reset_opacity", "prune_young")


def _surgery(kind, model, adam, noise, extent, points):
    """Run one surgery in place; returns the rows and fields it computes
    (the rest it only moves) as (CPU bool mask, field names)."""
    if kind == "densify_and_prune":
        before = model.xyz.detach().clone()
        counts = surgery.densify_and_prune(model, adam, max_grad=0.0002, min_opacity=0.005, extent=extent,
                                           max_screen_size=20, noise=noise.to(model.xyz.device))
        assert counts.cloned > 0 and counts.split > 0 and counts.pruned > 0, counts
        return checks.split_children(model.xyz, before), ("xyz", "scaling")
    if kind == "increase_pcd":
        n = model.count
        kept = surgery.increase_pcd(model, adam, *points, iteration=60)
        assert 0 < kept < len(points[0])
        return torch.arange(model.count) >= n, ("xyz", "f_dc", "opacity", "scaling")
    if kind == "reset_opacity":
        surgery.reset_opacity(model, adam)
        return torch.ones(model.count, dtype=torch.bool), ("opacity",)
    dropped = surgery.prune_young(model, adam, 45, 10)
    assert 0 < dropped < model.count
    return torch.zeros(model.count, dtype=torch.bool), ()


@pytest.mark.parametrize("kind", SURGERY_KINDS)
@pytest.mark.parametrize("size", ["64x64", "50k"])
def test_surgery_on_the_card_matches_the_cpu(dev, size, kind):
    """One surgery from one state (and one noise draw, from a seeded CUDA
    generator) on the card and on the CPU; then a fresh training step at
    the new count on the card, finite, through K3, K1 and K2."""
    cpu_model, cpu_adam = surgery_model(size)
    model, adam = copy_state(cpu_model, cpu_adam, dev)
    noise = torch.randn((2, model.count, 3), generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    extent = surgery_extent(cpu_model)
    points = new_points(cpu_model)
    gen = model.generation
    computed, fields = _surgery(kind, model, adam, noise, extent, points)
    want, _ = _surgery(kind, cpu_model, cpu_adam, noise.cpu(), extent, points)
    torch.cuda.synchronize()
    assert torch.equal(computed, want)
    res = checks.surgery_check(model, adam, cpu_model, cpu_adam, computed, fields)
    assert res["ok"], res
    assert model.generation > gen

    cam = _camera(dev) if size == "64x64" else headline_camera(dev)
    h, w = (64, 64) if size == "64x64" else (HEIGHT, WIDTH)
    gt = torch.rand((h, w, 3), generator=torch.Generator(device=dev).manual_seed(4), device=dev)
    n = model.count
    kernels.reset_launch_counts()
    m = train_step(model, adam, cam, gt, None, torch.zeros(3, device=dev), 50, 1.0,
                   RasterizeConfig(height=h, width=w), OptimizationParams())
    torch.cuda.synchronize()
    assert np.isfinite(float(m.loss)) and model.count == n == m.count
    assert all(kernels.LAUNCHES[k] == 1
               for k in ("tile_ranges_pack", "blend_fwd", "blend_bwd", "preprocess_fwd", "preprocess_bwd", "loss_fwd",
                         "loss_bwd", "bin_count", "bin_write"))
    assert all(bool(torch.isfinite(p).all()) for p in model.params().values())


@pytest.mark.parametrize("scene", ["64x64", "wall"])
def test_render_depth_state_through_k1_matches_plain(dev, scene):
    """render_depth_state on the card (K3, K1) against the same render
    blended by the plain K1, at the 64x64 bar scaled by max |z|."""
    if scene == "64x64":
        model, cam, size = surgery_model("64x64")[0].to(dev), _camera(dev), 64
    else:
        args, cam = wall_scene(dev)
        means, scales, quats, opac, dc, rest = args
        model = surgery.GaussianModel({"xyz": means, "f_dc": dc, "f_rest": rest,
                                       "opacity": torch.log(opac / (1 - opac))[:, None],
                                       "scaling": torch.log(scales), "rotation": quats})
        size = WALL_SIZE
    cfg = RasterizeConfig(height=size, width=size)
    kernels.reset_launch_counts()
    depth, cov = render_depth_state(model, cam, cfg)
    assert kernels.LAUNCHES["blend_fwd"] == 1 and kernels.LAUNCHES["tile_ranges_pack"] == 1
    res = checks.depth_check(model, cam, cfg, depth, cov)
    assert res["covered"] > 0, res
    assert res["accum"] <= checks.FWD_SMALL and res["coverage"] <= checks.FWD_SMALL, res
    assert res["depth"] <= 4 * checks.FWD_SMALL, res


def test_colorize_on_the_card_matches_the_cpu(dev):
    """A 120,000-point scan over 360 degrees colourised from a 1226x370
    image on the card and on the CPU: the masks, points and colours
    bit-equal; colorize_frame, given no device, runs on the card and
    compacts to the valid points."""
    pose = drive_pose(4.0, sway=0.3)
    proj, tr = kitti_calibration(1226, 370)
    image, _ = raycast_outdoor(pose, 1226, 370)
    scan = lidar_scan(pose, seed=1)
    lidar_pose = (pose.astype(np.float64) @ tr).astype(np.float32)
    got = colorize_pointcloud(scan, image, proj, tr, lidar_pose, device=dev)
    want = colorize_pointcloud(scan, image, proj, tr, lidar_pose, device="cpu")
    assert got.valid.device.type == "cuda"
    res = checks.colorize_check(got, want)
    assert res["ok"] and res["points_bit_equal"] and res["colors_bit_equal"], res
    assert 10_000 < res["valid"] < 60_000, res
    fr = colorize_frame(image, scan, proj, tr, pose, lidar_pose)
    np.testing.assert_array_equal(fr.points, want.points_world[want.valid].numpy())
    np.testing.assert_array_equal(fr.colors, want.colors[want.valid].numpy())


def test_short_stream_on_the_card_matches_the_cpu(dev):
    """chip_smoke.py's 9d: six frames of the room at 64x64 with rebin 4
    through the mapper on the card and on the CPU, one seed: the same
    keyframes, iterations, counts and binning decisions, losses within
    STREAM_LOSS_ATOL; the card's steps go through K3, K4, K1 and K2."""
    frames = make_sequence(6, 64, 64)
    _, want = run_stream(6, 64, 64, device="cpu", rebin_interval=4, frames=frames)
    kernels.reset_launch_counts()
    result, got = run_stream(6, 64, 64, device=dev, rebin_interval=4, frames=frames)
    res = checks.stream_check(got, want)
    assert res["ok"], res
    n = result["binning"]
    assert n.get("export", 0) > 0 and n.get("cached", 0) > 0, n
    assert kernels.LAUNCHES["blend_fwd_export"] == n["export"]
    assert kernels.LAUNCHES["tile_ranges_pack"] == n["export"] + n.get("fresh", 0)
    assert kernels.LAUNCHES["bin_count"] == kernels.LAUNCHES["bin_write"] == kernels.LAUNCHES["tile_ranges_pack"]
    assert kernels.LAUNCHES["blend_fwd"] == n["cached"] + n.get("fresh", 0)
    assert kernels.LAUNCHES["blend_bwd"] == kernels.LAUNCHES["adam_step"] == len(got)


def test_short_mono_stream_on_the_card_matches_the_cpu(dev):
    """chip_smoke.py's 10d: probes/mono.py's short mono stream (64x64, the
    depth cache of 2, one small and one large correction, rebin 4) on the
    card at pipeline depth 2 against the CPU: the samples (tracker and
    prior bit-equal, the depth render's within K1's bar), counts and steps;
    the card's steps and depth renders go through K3, K1, K2 and K4."""
    from gsdf_slam_tpu_torch.probes import mono

    frames = make_sequence(mono.SHORT["frames"], mono.SHORT["size"], mono.SHORT["size"])
    want = mono.short_mono_run("cpu", 2, frames=frames)
    kernels.reset_launch_counts()
    got = mono.short_mono_run(dev, 2, frames=frames)
    res = checks.mono_run_check(got, want)
    assert res["ok"], res
    renders = got["mapper"].timer.counts["mono.depth_render"]
    n = got["mapper"].binning_counts
    assert renders > 0 and kernels.LAUNCHES["blend_fwd"] == n["cached"] + renders
    assert kernels.LAUNCHES["tile_ranges_pack"] == n["export"] + renders
    assert kernels.LAUNCHES["blend_bwd"] == len(got["log"]) and kernels.LAUNCHES["blend_fwd_export"] == n["export"]


@pytest.mark.parametrize("depth_cache", [1, 10])
def test_image_only_keyframes_on_the_card_match_the_cpu(dev, depth_cache):
    """chip_smoke.py's 10d, image only: keyframes with no depth and no
    tracker points; at a depth cache of 10 the first nine steps train an
    empty map on the card."""
    from gsdf_slam_tpu_torch.probes import mono

    frames = make_sequence(11, 64, 64)
    settings = mono.mono_settings(max_depth_cached=depth_cache)
    want = mono.image_only_run("cpu", settings, frames)
    got = mono.image_only_run(dev, settings, frames)
    assert got["counts"] == want["counts"] and got["counts"][-1] > 0
    res = checks.stream_check(got["log"], want["log"])
    assert res["ok"], res
