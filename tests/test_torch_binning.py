"""Port parity: binning (expansion, opacity cull, stable sort, K3's plain
version) against `bin_gaussians` and `sort_expand_pack` (the Pallas realign
in interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import BINNING_CASES, crafted_binning, jax_args, jax_camera, scene_arrays

from gsdf_slam_tpu.ops import binning as jbin
from gsdf_slam_tpu.ops import pallas_binning as jpb
from gsdf_slam_tpu.ops import projection as jproj
from gsdf_slam_tpu_torch.ops import binning

GRID = 4  # 64x64 -> 4x4 tiles
NUM_TILES = GRID * GRID


def _scenes():
    # the parity scene, and a saturating one (opaque, large, overlapping)
    return {
        "parity": scene_arrays(p=96, seed=1),
        "saturating": scene_arrays(p=96, seed=5, opacity_max=0.99, spread=1.0),
    }


def _binned_both(s):
    pre = jax.jit(
        lambda *a: jproj.preprocess(*a[:7], a[7], width=64, height=64, sh_degree=3)
    )(*jax_args(s), jax_camera())
    opac = jnp.asarray(s["opac"])
    t = lambda a: torch.from_numpy(np.asarray(a).copy())
    port = binning.bin_and_pack(
        t(pre.depths), t(pre.rect_min), t(pre.rect_max), t(pre.tiles_touched),
        t(pre.means2d), t(pre.conics), t(opac), t(pre.colors), grid_w=GRID, grid_h=GRID,
    )
    return pre, opac, port


def _port_sequence(port):
    tiles = torch.repeat_interleave(
        torch.arange(NUM_TILES), (port.ranges[:, 1] - port.ranges[:, 0]).long()
    )
    return tiles.numpy(), port.gid.numpy()


@pytest.mark.parametrize("name", ["parity", "saturating"])
def test_binning_matches_bin_gaussians(name):
    """The valid (tile, gid) sequence, per-tile ranges and total_pairs equal
    the XLA binning's."""
    pre, opac, port = _binned_both(_scenes()[name])
    ref = jbin.bin_gaussians(pre, opac, grid_w=GRID, grid_h=GRID, max_pairs=4096)
    rt = np.asarray(ref.pair_tile)
    valid = rt < NUM_TILES
    tiles, gid = _port_sequence(port)
    assert port.total_pairs == int(ref.total_pairs) > 0
    np.testing.assert_array_equal(tiles, rt[valid])
    np.testing.assert_array_equal(gid, np.asarray(ref.pair_gauss)[valid])
    starts = np.searchsorted(rt, np.arange(NUM_TILES), side="left")
    ends = np.searchsorted(rt, np.arange(NUM_TILES), side="right")
    empty = starts == ends
    np.testing.assert_array_equal(port.ranges[:, 0].numpy(), np.where(empty, 0, starts))
    np.testing.assert_array_equal(port.ranges[:, 1].numpy(), np.where(empty, 0, ends))
    # payload rows are the sorted pairs' Gaussian fields, copied exactly
    g = port.gid.long().numpy()
    want = np.concatenate(
        [np.asarray(pre.means2d)[g], np.asarray(pre.conics)[g], np.asarray(opac)[g][:, None],
         np.asarray(pre.colors)[g]], axis=1,
    ).T
    np.testing.assert_array_equal(port.payload.numpy(), want)


@pytest.mark.parametrize("name", ["parity", "saturating"])
def test_binning_matches_sort_expand_pack(name):
    """The same sequence read out of the Pallas realign's packed layout
    (8-tile groups, slot row 9, gid bits row 10)."""
    pre, opac, port = _binned_both(_scenes()[name])
    sp = jpb.sort_expand_pack(
        pre.depths, pre.rect_min, pre.rect_max, pre.tiles_touched, pre.means2d,
        pre.conics, opac, pre.colors, grid_w=GRID, grid_h=GRID, max_pairs=4096,
        chunk=128, group=8,
    )
    pairs = np.asarray(sp.pairs)
    ranges = np.asarray(sp.ranges)
    tiles, gids = [], []
    for g in range(ranges.shape[1]):
        lanes = slice(ranges[0, g], ranges[0, g] + ranges[1, g])
        tiles.append(g * 8 + pairs[9, lanes].astype(np.int64))
        gids.append(pairs[10, lanes].view(np.int32))
    p_tiles, p_gid = _port_sequence(port)
    assert port.total_pairs == int(sp.total_pairs)
    np.testing.assert_array_equal(p_tiles, np.concatenate(tiles))
    np.testing.assert_array_equal(p_gid, np.concatenate(gids))


def test_tile_opacity_keep_matches():
    rng = np.random.default_rng(3)
    n = 500
    mx, my = rng.uniform(-10, 70, n).astype(np.float32), rng.uniform(-10, 70, n).astype(np.float32)
    a = rng.uniform(0.01, 1, n).astype(np.float32)
    c = rng.uniform(0.01, 1, n).astype(np.float32)
    b = (rng.uniform(-0.9, 0.9, n) * np.sqrt(a * c)).astype(np.float32)
    op = rng.uniform(0.004, 1, n).astype(np.float32)
    tx, ty = rng.integers(0, 4, n).astype(np.int32), rng.integers(0, 4, n).astype(np.int32)
    # a mean exactly on a tile boundary exercises the D1 fix
    mx[0], tx[0] = 16.0, 1
    want = np.asarray(jbin._tile_opacity_keep(mx, my, a, b, c, op, tx, ty))
    got = binning.tile_opacity_keep(*(torch.from_numpy(v) for v in (mx, my, a, b, c, op, tx, ty)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < n


def _binning_tensors(arrays):
    return [torch.from_numpy(arrays[k]) for k in ("depths", "rect_min", "rect_max", "tiles_touched", "means2d",
                                                   "conics", "opacities", "colors")]


def _assert_same_binning(got, want):
    assert got.total_pairs == want.total_pairs
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("name", ["parity", "saturating"])
def test_depth_first_route_matches_plain_route(name):
    """The card's route, each kernel taking its plain version on the CPU:
    the Gaussians sorted by depth bits, expanded in that order, the pairs
    sorted by tile id alone, gives the plain route's Binned bit for bit."""
    pre, opac, want = _binned_both(_scenes()[name])
    t = lambda a: torch.from_numpy(np.asarray(a).copy())
    got = binning.bin_and_pack_depth_first(
        t(pre.depths), t(pre.rect_min), t(pre.rect_max), t(pre.tiles_touched), t(pre.means2d), t(pre.conics),
        t(opac), t(pre.colors), grid_w=GRID, grid_h=GRID,
    )
    assert want.gid.shape[0] > 0
    _assert_same_binning(got, want)


@pytest.mark.parametrize("grid", [(77, 24), (200, 203)])
@pytest.mark.parametrize("case", BINNING_CASES)
def test_depth_first_route_on_crafted_rows(case, grid):
    """torch_port_helpers.crafted_binning at KITTI's grid and past 32,767
    tiles (tile ids past 16 bits)."""
    arrays, (gw, gh) = crafted_binning(case, grid=grid)
    a = _binning_tensors(arrays)
    want = binning.bin_and_pack_plain(*a, grid_w=gw, grid_h=gh)
    got = binning.bin_and_pack_depth_first(*a, grid_w=gw, grid_h=gh)
    _assert_same_binning(got, want)
    assert (want.gid.shape[0] > 1848) if case == "crafted" else (want.gid.shape[0] == 0)
    assert (want.total_pairs > 0) == (case != "none_visible")


def test_depth_order_orders_the_bits_unsigned():
    """Ties keep their index order; -0.0 and negative depths, whose sign bit
    is set, come after every positive one, as in the plain route's 64-bit
    key."""
    d = torch.tensor([3.0, -1.0, 2.0, -0.0, 2.0, 0.0, float("inf"), -2.0], dtype=torch.float32)
    want = torch.argsort(d.view(torch.int32).to(torch.int64) & 0xFFFFFFFF, stable=True)
    got = binning.depth_order(d)
    assert torch.equal(got, want)
    assert got.tolist() == [5, 2, 4, 0, 6, 3, 1, 7]


def test_bin_count_and_write_plain_agree():
    """Each 32 Gaussians' kept count sums to the kept total, and the written
    pairs run through the depth order in expansion order."""
    arrays, (gw, gh) = crafted_binning("crafted")
    depths, rmin, rmax, tt, m2, con, opac, _ = _binning_tensors(arrays)
    gauss = (binning.depth_order(depths), tt, rmin, rmax, m2, con, torch.log(opac * 255.0))
    counts, totals = binning.bin_count_plain(*gauss, grid_w=gw)
    kept, total = totals.tolist()
    assert counts.dtype == torch.int32 and counts.shape[0] == (depths.shape[0] + 31) // 32
    assert int(counts.sum()) == kept and total == int(tt.sum())
    tiles, pair_gid = binning.bin_write_plain(*gauss, torch.cumsum(counts, 0), kept, grid_w=gw)
    assert tiles.dtype == torch.int32 and pair_gid.dtype == torch.int32 and tiles.shape[0] == kept
    rank = torch.empty_like(gauss[0])
    rank[gauss[0]] = torch.arange(depths.shape[0])
    r = rank[pair_gid.long()]
    assert bool((r[1:] >= r[:-1]).all())
