"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda` and skipped without a GPU. This file imports no jax, so it
also runs where jax is not installed:

    GSDF_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -m cuda
"""

import pytest
import torch
from torch_port_helpers import (
    EXPORT_BINNINGS, FOV, POSE, WINDOW_EDGE_CASES, export_binning, pair2_binning, scene_arrays,
    synthetic_binning, torch_args, window_edge_case,
)

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
        keys, order, pair_gid, table, _ = staged
        ranges, _, payload = binning.tile_ranges_pack(keys, order, pair_gid, table, 16)
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
