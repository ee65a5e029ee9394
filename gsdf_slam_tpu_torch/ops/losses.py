"""Photometric losses: L1, PSNR, SSIM and the mapper's training loss.

Port of `gsdf_slam_tpu/ops/losses.py` (include/loss_utils.h; loss assembly
of gaussian_mapper.cpp:415-429, including its quirk of comparing the
masked render against the unmasked gt inside SSIM). Images are HWC float32.

The SSIM window is the separable 11-tap sigma=1.5 Gaussian with zero
padding, written as shift-adds as in JAX: a float32 convolution would go to
cuDNN, which runs it in TF32 on the card by default.
"""

from __future__ import annotations

import numpy as np
import torch

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


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM map (loss_utils.h:76-124)."""
    mu1 = _filter(img1, window_size)
    mu2 = _filter(img2, window_size)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = _filter(img1 * img1, window_size) - mu1_sq
    sigma2_sq = _filter(img2 * img2, window_size) - mu2_sq
    sigma12 = _filter(img1 * img2, window_size) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + _C1) * (2 * sigma12 + _C2)) / (
        (mu1_sq + mu2_sq + _C1) * (sigma1_sq + sigma2_sq + _C2)
    )
    return torch.mean(ssim_map)


def mapper_loss(
    rendered: torch.Tensor,
    gt: torch.Tensor,
    mask: torch.Tensor | None,
    lambda_dssim: float = 0.2,
) -> torch.Tensor:
    """(1-l)*L1 + l*(1-SSIM) (gaussian_mapper.cpp:415-429). Masked-out
    pixels go white in both images for L1, but SSIM compares the masked
    render against the UNMASKED gt (:429), kept for parity."""
    if mask is not None:
        m = mask[..., None] > 0 if mask.dim() == 2 else mask > 0
        masked_img = torch.where(m, rendered, 1.0)
        masked_gt = torch.where(m, gt, 1.0)
    else:
        masked_img, masked_gt = rendered, gt
    ll1 = l1_loss(masked_img, masked_gt)
    return (1.0 - lambda_dssim) * ll1 + lambda_dssim * (1.0 - ssim(masked_img, gt))
