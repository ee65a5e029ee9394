"""Carry a map and its optimizer state across from the JAX package.

`from_jax_state` takes the fields of a JAX `GaussianState` and
`from_jax_adam` those of an `AdamState`, as numpy arrays (for example
`{k: np.asarray(v) for k, v in state.params().items()}`), keeps the live
prefix `[:count]` and returns the port's counterpart. `from_jax_cache`
turns a JAX `BinningCache` into the port's per-tile cache. No jax is
needed.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.gaussian_model import GaussianModel
from .models.optimizer import PARAM_GROUPS, AdamState
from .ops.projection import tile_grid
from .ops.tile_blend import BinningCache

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


def from_jax_cache(
    arrays: dict[str, np.ndarray], count: int, image_size: tuple[int, int], group: int = 8,
    device="cpu",
) -> BinningCache:
    """The port's BinningCache from a JAX one (`ranges` [2, NG] group starts
    and counts, `gid` [MPA], `slot` [MPA], `total_pairs`), built for `count`
    live Gaussians at `image_size` (height, width) with `pallas_group`
    `group`. The tile of lane i of group g is g * group + slot[i]; lanes
    keep their order within each tile."""
    height, width = image_size
    grid_w, grid_h = tile_grid(width, height)
    num_tiles = grid_w * grid_h
    starts, counts = np.asarray(arrays["ranges"]).astype(np.int64)
    gid_all = np.asarray(arrays["gid"])
    slot_all = np.asarray(arrays["slot"])
    lanes = [np.arange(s, s + n) for s, n in zip(starts, counts)]
    lane = np.concatenate(lanes) if lanes else np.zeros(0, np.int64)
    group_of = np.repeat(np.arange(len(starts)), counts)
    tile = group_of * group + slot_all[lane].astype(np.int64)
    gid = gid_all[lane].astype(np.int64)
    if tile.size and (tile.max() >= num_tiles or gid.max() >= count):
        raise ValueError("JAX cache does not fit the given grid or Gaussian count")
    order = np.argsort(tile, kind="stable")
    per_tile = np.bincount(tile, minlength=num_tiles)
    ends = np.cumsum(per_tile)
    ranges = np.stack([ends - per_tile, ends], axis=1)
    return BinningCache(
        ranges=torch.as_tensor(ranges.astype(np.int32), device=device),
        gid=torch.as_tensor(gid[order].astype(np.int32), device=device),
        total_pairs=int(np.asarray(arrays["total_pairs"])),
        num_gaussians=int(count),
        image_size=(int(height), int(width)),
    )
