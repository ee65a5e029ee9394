"""Port parity: L1, PSNR, SSIM and the mapper loss (with its mask quirk)
against the JAX package, values and gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import assert_scaled_close

from gsdf_slam_tpu.ops import losses as jl
from gsdf_slam_tpu_torch.ops import losses


def _images(seed=0, h=33, w=47):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


def test_l1_psnr_ssim_match():
    a, b = _images()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert abs(float(losses.l1_loss(ta, tb)) - float(jl.l1_loss(a, b))) < 1e-7
    assert abs(float(losses.psnr(ta, tb)) - float(jl.psnr(a, b))) < 1e-5
    assert abs(float(losses.ssim(ta, tb)) - float(jl.ssim(a, b))) < 1e-6


@pytest.mark.parametrize("masked", [False, True])
def test_mapper_loss_and_gradient_match(masked):
    """Value to 1e-6 and gradient w.r.t. the render to 2e-5 scaled. The
    masked case holds the quirk: masked pixels go white for L1, but SSIM
    compares the masked render against the UNMASKED gt."""
    a, b = _images(1, 32, 32)
    mask = None
    if masked:
        mask = np.ones((32, 32), np.float32)
        mask[:8] = 0.0
    want, g_want = jax.jit(jax.value_and_grad(jl.mapper_loss), static_argnums=())(
        jnp.asarray(a), jnp.asarray(b), None if mask is None else jnp.asarray(mask), 0.2
    )
    ta = torch.from_numpy(a).requires_grad_(True)
    got = losses.mapper_loss(ta, torch.from_numpy(b), None if mask is None else torch.from_numpy(mask), 0.2)
    (g_got,) = torch.autograd.grad(got, ta)
    assert abs(float(got.detach()) - float(want)) < 1e-6
    assert_scaled_close(np.asarray(g_want), g_got.numpy(), 2e-5, "d loss / d render")
    if masked:
        mi = torch.where(torch.from_numpy(mask)[..., None] > 0, ta.detach(), 1.0)
        mg = torch.where(torch.from_numpy(mask)[..., None] > 0, torch.from_numpy(b), 1.0)
        quirk = 0.8 * losses.l1_loss(mi, mg) + 0.2 * (1 - losses.ssim(mi, torch.from_numpy(b)))
        assert abs(float(quirk) - float(got.detach())) < 1e-6


# ---- the MapperLoss Function's plain path (the version the card's kernels
# are held to): the value is the plain ops' own, the analytic backward is
# held to autograd of the plain ops and to JAX's value_and_grad

SIZES = {"33x47": (33, 47), "5x7": (5, 7), "row_slice": (20, 37)}
MASKS = (None, "hw", "hw3")


def _case(size, mask_kind, seed=3):
    """(rendered, gt, mask) as numpy, and the render as the torch view the
    Function sees: for "row_slice", the first half of the rows of a strided
    crop of a wider image, as the half-batch check feeds it."""
    h, w = SIZES[size]
    a, b = _images(seed, h, w)
    rng = np.random.default_rng(seed + 1)
    mask = None
    if mask_kind == "hw":
        mask = (rng.uniform(0, 1, (h, w)) > 0.3).astype(np.float32)
    elif mask_kind == "hw3":
        mask = (rng.uniform(0, 1, (h, w, 3)) > 0.3).astype(np.float32)
    if size == "row_slice":
        wide = np.pad(a, ((0, 0), (0, 11), (0, 0)))
        view = torch.from_numpy(wide)[:, :w][: h // 2]
        a, b = a[: h // 2], b[: h // 2]
        mask = None if mask is None else mask[: h // 2]
        assert not view.is_contiguous()
    else:
        view = torch.from_numpy(a)
    return a, b, mask, view


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("size", list(SIZES))
def test_mapper_loss_function_against_autograd_and_jax(size, mask_kind):
    """Value: the plain ops' own, and within 1e-6 of JAX. Gradient
    (the analytic backward): within 2e-5 scaled of autograd through the
    plain ops and of JAX's value_and_grad."""
    a, b, mask, view = _case(size, mask_kind)
    tm = None if mask is None else torch.from_numpy(mask)
    tb = torch.from_numpy(b)
    leaf = view.detach().clone().requires_grad_(True)
    got = losses.mapper_loss(leaf, tb, tm, 0.2)
    (g_got,) = torch.autograd.grad(got, leaf)
    ref_leaf = view.detach().clone().requires_grad_(True)
    ref = losses.mapper_loss_plain(ref_leaf, tb, tm, 0.2)
    (g_ref,) = torch.autograd.grad(ref, ref_leaf)
    assert float(got.detach()) == float(ref.detach())
    assert_scaled_close(g_ref.numpy(), g_got.numpy(), 2e-5, "analytic against autograd")
    want, g_want = jax.value_and_grad(jl.mapper_loss)(
        jnp.asarray(a), jnp.asarray(b), None if mask is None else jnp.asarray(mask), 0.2
    )
    assert abs(float(got.detach()) - float(want)) < 1e-6
    assert_scaled_close(np.asarray(g_want), g_got.numpy(), 2e-5, "analytic against JAX")
    if mask is not None:
        keep = (mask if mask.ndim == 3 else mask[..., None]) > 0
        assert not np.any(np.broadcast_to(~keep, g_got.shape) & (g_got.numpy() != 0))


@pytest.mark.parametrize("upstream", [1.0, -2.5])
def test_mapper_loss_backward_scales_by_the_upstream_gradient(upstream):
    """The upstream gradient multiplies the analytic one, as autograd's, and
    a gradient of the ground truth is not asked for."""
    a, b, mask, view = _case("33x47", "hw")
    leaf = view.detach().clone().requires_grad_(True)
    loss = losses.mapper_loss(leaf, torch.from_numpy(b), torch.from_numpy(mask), 0.3)
    (g,) = torch.autograd.grad(loss * upstream, leaf)
    ref_leaf = view.detach().clone().requires_grad_(True)
    ref = losses.mapper_loss_plain(ref_leaf, torch.from_numpy(b), torch.from_numpy(mask), 0.3)
    (g_ref,) = torch.autograd.grad(ref * upstream, ref_leaf)
    assert_scaled_close(g_ref.numpy(), g.numpy(), 2e-5, "scaled upstream")


def test_ssim_derivative_maps_are_the_partial_derivatives():
    """The maps loss_fwd writes, against autograd of one pixel's SSIM term
    through its moments, with the moments' filters in between: the
    gradient of mean SSIM is F(dmu1) + 2 x F(dsigma1^2) + y F(dsigma12)
    over N."""
    a, b = _images(5, 13, 17)
    x = torch.from_numpy(a).double().requires_grad_(True)
    y = torch.from_numpy(b).double()
    (g,) = torch.autograd.grad(losses.ssim(x, y), x)
    d_mu1, d_s11, d_s12 = losses.ssim_derivative_maps(x.detach(), y)
    f = lambda t: losses._filter(t, 11)
    got = (f(d_mu1) + 2 * x.detach() * f(d_s11) + y * f(d_s12)) / x.numel()
    assert_scaled_close(g.numpy(), got.numpy(), 1e-10, "d mean SSIM / d x")
