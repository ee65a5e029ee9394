"""Spherical-harmonics colour evaluation, degrees 0-3.

Port of `gsdf_slam_tpu/ops/sh.py` (computeColorFromSH, forward.cu:32-101):
DC term plus degree-1..3 terms from the "rest" coefficients, +0.5 offset,
clamped at 0. Autograd supplies the backward, as it does in JAX.
"""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
MAX_SH_DEGREE = 3


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    """RGB2SH = (rgb - 0.5) / C0 (include/sh_utils.h:138)."""
    return (rgb - 0.5) / SH_C0


def sh_basis(dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """Real SH basis [..., (degree+1)**2] for unit directions, in the
    reference's coefficient order (forward.cu:64-85)."""
    if not 0 <= degree <= MAX_SH_DEGREE:
        raise ValueError(f"degree must be in [0, {MAX_SH_DEGREE}], got {degree}")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    terms = [SH_C0 * torch.ones_like(x)]
    if degree > 0:
        terms += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        terms += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if degree > 2:
        terms += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    return torch.stack(terms, dim=-1)


def eval_sh_color(
    dc: torch.Tensor,
    sh_rest: torch.Tensor,
    means: torch.Tensor,
    campos: torch.Tensor,
    degree: int,
    active_degree: int | None = None,
) -> torch.Tensor:
    """SH -> clamped RGB [N, 3] (forward.cu:32-101).

    dc [N, 1, 3], sh_rest [N, R, 3], means [N, 3], campos [3]. Bands above
    `active_degree` are zeroed (setShDegree, gaussian_model.cpp:103-112).
    """
    d = means - campos[None, :]
    # eps inside the rsqrt keeps the direction's gradient finite at d == 0
    d = d * torch.rsqrt(torch.sum(d * d, dim=-1, keepdim=True) + 1e-24)
    basis = sh_basis(d, degree)
    k = basis.shape[-1]
    if active_degree is not None and active_degree < degree:
        k = (active_degree + 1) ** 2
    coeffs = torch.cat([dc, sh_rest], dim=1)
    k = min(k, coeffs.shape[1])
    rgb = torch.sum(basis[:, :k, None] * coeffs[:, :k, :], dim=1) + 0.5
    return torch.clamp_min(rgb, 0.0)
