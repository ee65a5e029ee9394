"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda` and skipped without a GPU. This file imports no jax, so it
also runs where jax is not installed:

    GSDF_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -m cuda
"""

import pytest
import torch
from torch_port_helpers import FOV, POSE, scene_arrays, synthetic_binning, torch_args

from gsdf_slam_tpu_torch import kernels
from gsdf_slam_tpu_torch.ops import (
    CameraMatrices, RasterizeConfig, binning, blend, blend_probe, pair_table, preprocess, render, tile_blend,
)
from gsdf_slam_tpu_torch.probes import checks, expand_probe, microbench
from gsdf_slam_tpu_torch.probes.scene import WALL_SIZE, wall_scene

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
    return keys, order, pair_gid, table, args[0].shape[0]


def test_k3_bit_equal(staged):
    keys, order, pair_gid, table, _ = staged
    got = binning.tile_ranges_pack(keys, order, pair_gid, table, 16)
    want = binning.tile_ranges_pack_plain(keys, order, pair_gid, table, 16)
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
    keys, order, pair_gid, table, p = staged
    ranges, gid, payload = binning.tile_ranges_pack(keys, order, pair_gid, table, 16)
    _blend_matches_plain(ranges, payload, gid, p, 4)


@pytest.mark.parametrize("opacity", [(0.05, 0.3), (0.5, 0.99)])
def test_k1_k2_on_tiles_of_1_32_33_300_pairs(dev, opacity):
    """Buckets of one pair, a full bucket, a bucket and one pair, and a tile
    whose pixels run past 256 pairs, so that warps take a second bucket."""
    ranges, payload, gid, p = (x.to(dev) if torch.is_tensor(x) else x
                               for x in synthetic_binning((1, 32, 33, 300), 2, opacity=opacity))
    _blend_matches_plain(ranges, payload, gid, p, 2)


def test_k1_k2_on_the_wall(dev):
    args, cam = wall_scene(dev)
    g = WALL_SIZE // 16
    with torch.no_grad():
        pre = preprocess(*args, cam, width=WALL_SIZE, height=WALL_SIZE, sh_degree=3)
        b = binning.bin_and_pack(pre.depths, pre.rect_min, pre.rect_max, pre.tiles_touched, pre.means2d,
                                 pre.conics, args[3], pre.colors, grid_w=g, grid_h=g)
    _blend_matches_plain(b.ranges, b.payload, b.gid, args[0].shape[0], g)


def test_k4_bit_equal_to_k1_and_keep_matches_plain(staged):
    keys, order, pair_gid, table, _ = staged
    ranges, _, payload = binning.tile_ranges_pack(keys, order, pair_gid, table, 16)
    *k1, ckpt1 = tile_blend.blend_fwd(ranges, payload, 4, 4)
    for margin in (1.0, 10.0):
        *k4, ckpt4, keep = tile_blend.blend_fwd_export(ranges, payload, 4, 4, margin)
        *_, keep_p = blend.blend_fwd_plain(ranges, payload, 4, 4, keep_margin=margin)
        torch.cuda.synchronize()
        for a, b in zip(k1, k4):
            assert torch.equal(a, b)
        assert torch.equal(keep, keep_p)
        assert checks.checkpoint_check(ckpt4, ckpt1, ranges, k1[2], k4[2])[2]


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
    assert n_g == {**dict.fromkeys(kernels.LAUNCHES, 0), "tile_ranges_pack": 1, "blend_fwd": 1, "blend_bwd": 1}
    assert float((img_c - img_g).abs().max()) <= 5e-6
    for a, b in zip(g_c, g_g):
        assert float((a - b).abs().max()) / max(float(a.abs().max()), 1e-4) <= 2e-5


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


@pytest.mark.parametrize("kind", ["rows", "cols"])
@pytest.mark.parametrize("p, mp", [(2048, 8192), (262_144, 393_216)])
def test_window_gather_bit_equal(dev, kind, p, mp):
    win, cpc = (pair_table.WIN_ROWS, pair_table.CPC_ROWS) if kind == "rows" else (pair_table.WIN_COLS,
                                                                                   pair_table.CPC_COLS)
    args = [torch.from_numpy(a).to(dev) for a in microbench.window_inputs(p, mp, win, cpc)]
    args[2][::997] += 5000  # some lanes out of their window
    kern = getattr(pair_table, f"window_gather_{kind}")
    plain = getattr(pair_table, f"window_gather_{kind}_plain")
    got = kern(*args)
    torch.cuda.synchronize()
    assert checks.bit_equal(got, plain(*args))


@pytest.mark.parametrize("mp", [4 * 512, 5 * 512 + 77, 393_216])
def test_xpose_cumsum_bit_equal(dev, mp):
    x = torch.from_numpy(microbench.xpose_inputs(mp)).to(dev)
    got = pair_table.xpose_cumsum(x)
    torch.cuda.synchronize()
    assert torch.equal(got, pair_table.xpose_cumsum_plain(x))
