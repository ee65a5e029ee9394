"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda` and skipped without a GPU. This file imports no jax, so it
also runs where jax is not installed:

    GSDF_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -m cuda
"""

import pytest
import torch
from torch_port_helpers import FOV, POSE, scene_arrays, torch_args

from gsdf_slam_tpu_torch import kernels
from gsdf_slam_tpu_torch.ops import (
    CameraMatrices, RasterizeConfig, binning, blend, preprocess, render, tile_blend,
)

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


def test_k1_k2_match_plain(staged):
    keys, order, pair_gid, table, p = staged
    ranges, gid, payload = binning.tile_ranges_pack(keys, order, pair_gid, table, 16)
    acc, lte, nc = tile_blend.blend_fwd(ranges, payload, 4, 4)
    acc_p, lte_p, nc_p = blend.blend_fwd_plain(ranges, payload, 4, 4)
    torch.cuda.synchronize()
    assert float((acc - acc_p).abs().max()) <= 5e-6
    assert float((lte.exp() - lte_p.exp()).abs().max()) <= 5e-6
    gen = torch.Generator(device=acc.device).manual_seed(0)
    ct_a = torch.randn(acc.shape, generator=gen, device=acc.device)
    ct_t = 0.1 * torch.randn(lte.shape, generator=gen, device=acc.device)
    a = (ranges, payload, gid, lte_p, nc_p, ct_a, ct_t, p, 4, 4)
    g = tile_blend.blend_bwd(*a)
    g_p = blend.blend_bwd_plain(*a)
    torch.cuda.synchronize()
    for sl in (slice(0, 2), slice(2, 5), slice(5, 6), slice(6, 9)):
        scale = max(float(g_p[:, sl].abs().max()), 1e-12)
        assert float((g[:, sl] - g_p[:, sl]).abs().max()) / scale <= 2e-5


def test_k4_bit_equal_to_k1_and_keep_matches_plain(staged):
    keys, order, pair_gid, table, _ = staged
    ranges, _, payload = binning.tile_ranges_pack(keys, order, pair_gid, table, 16)
    k1 = tile_blend.blend_fwd(ranges, payload, 4, 4)
    for margin in (1.0, 10.0):
        *k4, keep = tile_blend.blend_fwd_export(ranges, payload, 4, 4, margin)
        *_, keep_p = blend.blend_fwd_plain(ranges, payload, 4, 4, keep_margin=margin)
        torch.cuda.synchronize()
        for a, b in zip(k1, k4):
            assert torch.equal(a, b)
        assert torch.equal(keep, keep_p)


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
    assert n_c == {"tile_ranges_pack": 0, "blend_fwd": 0, "blend_bwd": 0, "blend_fwd_export": 0}
    assert n_g == {"tile_ranges_pack": 1, "blend_fwd": 1, "blend_bwd": 1, "blend_fwd_export": 0}
    assert float((img_c - img_g).abs().max()) <= 5e-6
    for a, b in zip(g_c, g_g):
        assert float((a - b).abs().max()) / max(float(a.abs().max()), 1e-4) <= 2e-5
