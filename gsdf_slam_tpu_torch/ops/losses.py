"""Photometric losses: L1, PSNR, SSIM and the mapper's training loss.

Port of `gsdf_slam_tpu/ops/losses.py` (include/loss_utils.h; loss assembly
of gaussian_mapper.cpp:415-429, including its quirk of comparing the
masked render against the unmasked gt inside SSIM). Images are HWC float32.

The SSIM window is the separable 11-tap sigma=1.5 Gaussian with zero
padding, written as shift-adds as in JAX: a float32 convolution would go to
cuDNN, which runs it in TF32 on the card by default.

`mapper_loss` is one `torch.autograd.Function`, `MapperLoss`: on CUDA
tensors its forward and backward are the kernels `loss_fwd` and `loss_bwd`
(csrc/loss.cu; the forward's two launches counted as one), which raise
where they cannot run; on CPU tensors the forward is `mapper_loss_plain`,
the plain tensor ops, and the backward `mapper_loss_grad_plain`, the
analytic gradient as tensor ops. The gradient reaches the render only.
The kernels replace no Pallas kernel: the JAX package leaves the loss to
XLA's fusion.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import kernels

_C1 = 0.01**2
_C2 = 0.03**2


def _gaussian_taps(window_size: int = 11, sigma: float = 1.5) -> list[float]:
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs**2) / (2.0 * sigma * sigma)).astype(np.float32)
    return [float(v) for v in (g / g.sum()).astype(np.float32)]


def _filter(img: torch.Tensor, window_size: int) -> torch.Tensor:
    """Separable Gaussian filter with zero padding; img [H, W, C]."""
    taps = _gaussian_taps(window_size)
    pad = window_size // 2
    h, w = img.shape[0], img.shape[1]
    x = torch.nn.functional.pad(img, (0, 0, 0, 0, pad, pad))
    out = taps[0] * x[0:h]
    for k in range(1, window_size):
        out = out + taps[k] * x[k : k + h]
    x = torch.nn.functional.pad(out, (0, 0, pad, pad))
    out = taps[0] * x[:, 0:w]
    for k in range(1, window_size):
        out = out + taps[k] * x[:, k : k + w]
    return out


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


def psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """10*log10(1/mse) (loss_utils.h:33-37)."""
    return 10.0 * torch.log10(1.0 / torch.mean((a - b) ** 2))


def psnr_gaussian_splatting(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """20*log10(1/sqrt(mse)) per leading index, then the mean
    (loss_utils.h:43-47)."""
    d = (a - b).reshape(a.shape[0], -1)
    mse = torch.mean(d * d, dim=1)
    return torch.mean(20.0 * torch.log10(1.0 / torch.sqrt(mse)))


def _ssim_parts(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> tuple[torch.Tensor, ...]:
    """mu1, mu2 and the factors a1, a2, b1, b2 of the SSIM map
    (a1 * a2) / (b1 * b2) (loss_utils.h:76-124)."""
    mu1 = _filter(img1, window_size)
    mu2 = _filter(img2, window_size)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = _filter(img1 * img1, window_size) - mu1_sq
    sigma2_sq = _filter(img2 * img2, window_size) - mu2_sq
    sigma12 = _filter(img1 * img2, window_size) - mu1_mu2
    return mu1, mu2, 2 * mu1_mu2 + _C1, 2 * sigma12 + _C2, mu1_sq + mu2_sq + _C1, sigma1_sq + sigma2_sq + _C2


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM map (loss_utils.h:76-124)."""
    _, _, a1, a2, b1, b2 = _ssim_parts(img1, img2, window_size)
    return torch.mean((a1 * a2) / (b1 * b2))


def _masked(rendered: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor | None):
    """(keep, masked render, masked gt): masked-out pixels go white."""
    if mask is None:
        return None, rendered, gt
    m = mask[..., None] > 0 if mask.dim() == 2 else mask > 0
    return m, torch.where(m, rendered, 1.0), torch.where(m, gt, 1.0)


def mapper_loss_plain(
    rendered: torch.Tensor,
    gt: torch.Tensor,
    mask: torch.Tensor | None,
    lambda_dssim: float = 0.2,
) -> torch.Tensor:
    """(1-l)*L1 + l*(1-SSIM) (gaussian_mapper.cpp:415-429). Masked-out
    pixels go white in both images for L1, but SSIM compares the masked
    render against the UNMASKED gt (:429), kept for parity."""
    _, masked_img, masked_gt = _masked(rendered, gt, mask)
    ll1 = l1_loss(masked_img, masked_gt)
    return (1.0 - lambda_dssim) * ll1 + lambda_dssim * (1.0 - ssim(masked_img, gt))


def ssim_derivative_maps(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Each pixel's SSIM term's partial derivatives in its own window's
    moments: dS/dmu1 (through sigma1^2 and sigma12 too), dS/dsigma1^2 and
    dS/dsigma12, [H, W, C] each; the maps loss_fwd writes."""
    mu1, mu2, a1, a2, b1, b2 = _ssim_parts(x, y)
    den = b1 * b2
    s = (a1 * a2) / den
    return 2 * (mu2 * (a2 - a1) + mu1 * s * (b1 - b2)) / den, -s / b2, 2 * a1 / den


def mapper_loss_grad_plain(
    rendered: torch.Tensor,
    gt: torch.Tensor,
    mask: torch.Tensor | None,
    lambda_dssim: float,
    grad_out: torch.Tensor,
) -> torch.Tensor:
    """d mapper_loss / d rendered, times the upstream gradient `grad_out`,
    as tensor ops: where(keep, (1-l)/N sgn(m - g) - l/N [F(dmu1) +
    2 m F(dsigma1^2) + gt F(dsigma12)], 0), F the window (symmetric, so its
    own adjoint). The plain version of loss_bwd."""
    keep, x, g = _masked(rendered, gt, mask)
    n = x.numel()
    d_mu1, d_s11, d_s12 = ssim_derivative_maps(x, gt)
    f_mu1, f_s11, f_s12 = (_filter(d, 11) for d in (d_mu1, d_s11, d_s12))
    a, b = (1.0 - lambda_dssim) / n, lambda_dssim / n
    grad = (a * torch.sgn(x - g) - b * (f_mu1 + 2 * x * f_s11 + gt * f_s12)) * grad_out
    return grad if keep is None else torch.where(keep, grad, 0.0)


def _image_args(rendered: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor | None) -> tuple:
    """The kernels' image arguments: each tensor and its strides, the mask
    broadcast to [H, W, 3] (float32; a null pointer for none)."""
    h, w = rendered.shape[0], rendered.shape[1]
    dev = rendered.device
    kernels.check("rendered", rendered, torch.float32, (h, w, 3), dev, contiguous=False)
    kernels.check("gt", gt, torch.float32, (h, w, 3), dev, contiguous=False)
    if h == 0 or w == 0:
        raise ValueError("mapper_loss: empty image")
    out = [rendered.data_ptr(), *rendered.stride(), gt.data_ptr(), *gt.stride()]
    if mask is None:
        return (*out, None, 0, 0, 0)
    m = (mask[..., None] if mask.dim() == 2 else mask).to(torch.float32).expand(h, w, 3)
    kernels.check("mask", m, torch.float32, (h, w, 3), dev, contiguous=False)
    return (*out, m.data_ptr(), *m.stride())


@functools.lru_cache(maxsize=1)
def _taps_host() -> ctypes.Array:
    return (ctypes.c_float * 11)(*_gaussian_taps())


def loss_fwd(rendered: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor | None,
             lambda_dssim: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel `loss_fwd` (and its final sum): the loss as a float32 scalar
    on the device, and the derivative maps [3, 3, H, W] (dS/dmu1,
    dS/dsigma1^2, dS/dsigma12, each per channel) that loss_bwd reads. The
    images are read through their strides. A CUDA tensor only (no plain
    fallback)."""
    args = _image_args(rendered, gt, mask)
    kernels.library()  # builds on first use; raises where it cannot
    h, w = rendered.shape[0], rendered.shape[1]
    dev = rendered.device
    dmaps = torch.empty((3, 3, h, w), dtype=torch.float32, device=dev)
    partials = torch.empty((2 * ((w + 31) // 32) * ((h + 15) // 16),), dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    kernels.LAUNCHES["loss_fwd"] += 1
    kernels.launch("gsdf_loss_fwd", *args, h, w, ctypes.addressof(_taps_host()), _C1, _C2, float(lambda_dssim),
                   dmaps.data_ptr(), partials.data_ptr(), loss.data_ptr())
    return loss, dmaps


def loss_bwd(rendered: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor | None, lambda_dssim: float,
             dmaps: torch.Tensor, grad_out: torch.Tensor) -> torch.Tensor:
    """Kernel `loss_bwd`: d loss / d rendered [H, W, 3] (contiguous) times
    the upstream gradient, a float32 scalar read on the device. A CUDA
    tensor only (no plain fallback)."""
    args = _image_args(rendered, gt, mask)
    h, w = rendered.shape[0], rendered.shape[1]
    dev = rendered.device
    kernels.check("dmaps", dmaps, torch.float32, (3, 3, h, w), dev)
    kernels.check("grad_out", grad_out, torch.float32, (), dev)
    kernels.library()
    n = 3 * h * w
    grad = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
    kernels.LAUNCHES["loss_bwd"] += 1
    kernels.launch("gsdf_loss_bwd", *args, h, w, ctypes.addressof(_taps_host()), dmaps.data_ptr(),
                   grad_out.data_ptr(), (1.0 - lambda_dssim) / n, lambda_dssim / n, grad.data_ptr())
    return grad


class MapperLoss(torch.autograd.Function):
    """`mapper_loss` with its backward. Inputs: rendered, gt, mask (or
    None), lambda_dssim; the gradient reaches `rendered` only."""

    @staticmethod
    def forward(ctx, rendered, gt, mask, lambda_dssim):
        lam = float(lambda_dssim)
        if kernels.runs_plain(rendered):
            loss, dmaps = mapper_loss_plain(rendered, gt, mask, lam), None
        else:
            loss, dmaps = loss_fwd(rendered, gt, mask, lam)
        ctx.save_for_backward(rendered, gt, mask)
        ctx.lam, ctx.dmaps = lam, dmaps
        return loss

    @staticmethod
    def backward(ctx, grad_out):
        rendered, gt, mask = ctx.saved_tensors
        if kernels.runs_plain(rendered):
            grad = mapper_loss_grad_plain(rendered, gt, mask, ctx.lam, grad_out)
        else:
            grad = loss_bwd(rendered, gt, mask, ctx.lam, ctx.dmaps, grad_out)
        return grad, None, None, None


def mapper_loss(
    rendered: torch.Tensor,
    gt: torch.Tensor,
    mask: torch.Tensor | None,
    lambda_dssim: float = 0.2,
) -> torch.Tensor:
    """(1-l)*L1 + l*(1-SSIM) (gaussian_mapper.cpp:415-429), with the mask
    quirk of `mapper_loss_plain`; the kernels on CUDA tensors, the plain
    version on CPU tensors. Differentiable in `rendered`."""
    return MapperLoss.apply(rendered, gt, mask, lambda_dssim)
