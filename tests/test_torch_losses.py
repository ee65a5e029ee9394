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
