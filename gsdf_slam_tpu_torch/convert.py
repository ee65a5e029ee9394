"""Carry a map and its optimizer state across from the JAX package.

`from_jax_state` takes the fields of a JAX `GaussianState` and
`from_jax_adam` those of an `AdamState`, as numpy arrays (for example
`{k: np.asarray(v) for k, v in state.params().items()}`), keeps the live
prefix `[:count]` and returns the port's counterpart. No jax is needed.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.gaussian_model import GaussianModel
from .models.optimizer import PARAM_GROUPS, AdamState

_STATS = ("max_radii2d", "xyz_grad_accum", "denom", "exist_since_iter")


def from_jax_state(arrays: dict[str, np.ndarray], count: int, device="cpu") -> GaussianModel:
    """GaussianModel from JAX GaussianState fields (the six parameters and,
    where given, the densification statistics)."""
    count = int(count)
    model = GaussianModel(
        {k: torch.tensor(np.asarray(arrays[k])[:count], dtype=torch.float32, device=device)
         for k in PARAM_GROUPS}
    )
    for k in _STATS:
        if k in arrays:
            buf = getattr(model, k)
            buf.copy_(torch.tensor(np.asarray(arrays[k])[:count], dtype=buf.dtype, device=device))
    return model


def from_jax_adam(
    m: dict[str, np.ndarray], v: dict[str, np.ndarray], step: int, count: int, device="cpu"
) -> AdamState:
    """AdamState from JAX AdamState fields (m and v per group, the shared step)."""
    count = int(count)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32)[:count].copy(), device=device)
    return AdamState(
        m={k: f(m[k]) for k in PARAM_GROUPS},
        v={k: f(v[k]) for k in PARAM_GROUPS},
        step=int(step),
    )


def to_numpy_state(model: GaussianModel) -> dict[str, np.ndarray]:
    """The model's parameters and statistics as numpy arrays (JAX field names)."""
    out = {k: p.detach().cpu().numpy() for k, p in model.params().items()}
    out.update({k: getattr(model, k).cpu().numpy() for k in _STATS})
    return out
