"""The Gaussian map as an `nn.Module`.

Port of the training-step part of `gsdf_slam_tpu/models/gaussian_model.py`
(GaussianModel, include/gaussian_model.h:57-175). Tensors are sized to the
live Gaussians, as in the reference; the JAX package's fixed capacity and
live-prefix mask have no counterpart here.

Parity notes (gaussian_model.cpp):
  * activations exp / normalize / sigmoid (:48-71), with the normalize's
    eps inside the rsqrt;
  * createFromPcd computes voxel-dedup indices but discards them
    (:146-147): every valid point of the first cloud becomes a Gaussian;
  * scale init log(sqrt(max(knn3, 1e-7))), opacity inverse_sigmoid(0.1),
    identity quaternions (:165-173);
  * addDensificationStats accumulates the norm of the NDC-convention screen
    gradient (pixel gradient times 0.5 W, 0.5 H; backward.cu:552-555).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.knn import knn_mean_dist2_exact
from ..ops.sh import rgb_to_sh
from ..ops.transforms import inverse_sigmoid
from .optimizer import PARAM_GROUPS


class GaussianModel(nn.Module):
    """Six trainable tensors plus the densification statistics."""

    def __init__(self, params: dict[str, torch.Tensor]):
        super().__init__()
        for k in PARAM_GROUPS:
            setattr(self, k, nn.Parameter(params[k].to(torch.float32).contiguous()))
        n = params["xyz"].shape[0]
        dev = params["xyz"].device
        self.register_buffer("max_radii2d", torch.zeros(n, device=dev))
        self.register_buffer("xyz_grad_accum", torch.zeros(n, device=dev))
        self.register_buffer("denom", torch.zeros(n, device=dev))
        self.register_buffer("exist_since_iter", torch.zeros(n, dtype=torch.int32, device=dev))

    @property
    def count(self) -> int:
        return self.xyz.shape[0]

    def params(self) -> dict[str, nn.Parameter]:
        return {k: getattr(self, k) for k in PARAM_GROUPS}

    def scaling_act(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    def rotation_act(self) -> torch.Tensor:
        n2 = torch.sum(self.rotation * self.rotation, dim=-1, keepdim=True)
        return self.rotation * torch.rsqrt(n2 + 1e-24)

    def opacity_act(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity)

    @staticmethod
    def create_from_pcd(
        points: np.ndarray,
        colors: np.ndarray,
        valid: np.ndarray | None = None,
        n_rest: int = 15,
        device: torch.device | str = "cuda",
    ) -> "GaussianModel":
        """createFromPcd (:130-199) from the first colourised cloud; no
        voxel dedup (the reference discards its result)."""
        points = np.asarray(points, np.float32)
        colors = np.asarray(colors, np.float32)
        if valid is not None:
            keep = np.asarray(valid, bool)
            points, colors = points[keep], colors[keep]
        n = points.shape[0]
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
        dist2 = torch.clamp_min(f32(knn_mean_dist2_exact(points)), 1e-7)
        rot = torch.zeros((n, 4), device=device)
        rot[:, 0] = 1.0
        return GaussianModel(
            {
                "xyz": f32(points),
                "f_dc": rgb_to_sh(f32(colors))[:, None, :],
                "f_rest": torch.zeros((n, n_rest, 3), device=device),
                "opacity": inverse_sigmoid(0.1 * torch.ones((n, 1), device=device)),
                "scaling": torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3),
                "rotation": rot,
            }
        )

    @torch.no_grad()
    def add_densification_stats(
        self, means2d_grad: torch.Tensor, radii: torch.Tensor, width: int, height: int
    ) -> None:
        """addDensificationStats (:667-681) and the max_radii2D update
        (gaussian_mapper.cpp:443-447), in place."""
        visible = radii > 0
        scale = torch.tensor([0.5 * width, 0.5 * height], dtype=torch.float32, device=means2d_grad.device)
        norm = torch.linalg.vector_norm(means2d_grad * scale, dim=-1)
        self.xyz_grad_accum += torch.where(visible, norm, 0.0)
        self.denom += visible.to(torch.float32)
        self.max_radii2d.copy_(
            torch.where(visible, torch.maximum(self.max_radii2d, radii.to(torch.float32)), self.max_radii2d)
        )
