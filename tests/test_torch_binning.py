"""Port parity: binning (expansion, opacity cull, stable sort, K3's plain
version) against `bin_gaussians` and `sort_expand_pack` (the Pallas realign
in interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import jax_args, jax_camera, scene_arrays

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
