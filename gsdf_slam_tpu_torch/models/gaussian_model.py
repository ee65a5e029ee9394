"""The Gaussian map as an `nn.Module`, and its surgery.

Port of `gsdf_slam_tpu/models/gaussian_model.py` (GaussianModel,
include/gaussian_model.h:57-175). Tensors are sized to the live Gaussians,
as in the reference: a surgery (`densify_and_prune`, `increase_pcd`,
`prune_young`, `reset_opacity`) rebuilds the six parameters, the four
statistics and the Adam moments of every group together, with `torch.cat`
after the live rows and index compaction, so the moments travel with their
rows. The JAX package's fixed capacity, live-prefix mask, `with_capacity`
and `SurgeryAux.dropped_for_capacity` have no counterpart here. Every
surgery adds one to `GaussianModel.generation`, which a `BinningCache`
records, so a cache from before a surgery raises even where the count is
unchanged.

Parity notes (gaussian_model.cpp):
  * activations exp / normalize / sigmoid (:48-71), with the normalize's
    eps inside the rsqrt;
  * createFromPcd computes voxel-dedup indices but discards them
    (:146-147): every valid point of the first cloud becomes a Gaussian;
  * scale init log(sqrt(max(knn3, 1e-7))), opacity inverse_sigmoid(0.1),
    identity quaternions (:165-173);
  * increasePcd dedups new points against the existing Gaussians' voxel
    hashes at 0.05 m (:207-235), with the JAX package's int32 wrap
    (PARITY.md D3);
  * densificationPostfix zeroes the densification statistics of every
    row, not only of the new ones, and the new rows' Adam moments
    (:492-568); so the screen-size prune that follows a densify reads a
    max_radii2D of zeros and never fires, as in the JAX package;
  * the split draws N(0, scale) offsets rotated into the world and shrinks
    the scale by 0.8 * N (:571-612); opacity reset min(opacity, 0.01) with
    the opacity moments zeroed (:399-429);
  * addDensificationStats accumulates the norm of the NDC-convention screen
    gradient (pixel gradient times 0.5 W, 0.5 H; backward.cu:552-555).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..ops.knn import knn_mean_dist2_exact
from ..ops.sh import rgb_to_sh
from ..ops.transforms import inverse_sigmoid, quat_to_rotmat
from ..utils.observability import span
from .optimizer import PARAM_GROUPS, AdamState

VOXEL_SIZE = 0.05  # gaussian_model.cpp:135
_HASH_PRIMES = (73856093, 19349663, 83492791)  # :138-140
STATS = ("max_radii2d", "xyz_grad_accum", "denom", "exist_since_iter")


def normalize_quat(q: torch.Tensor) -> torch.Tensor:
    """The rotation activation: q / |q| with the eps inside the rsqrt."""
    n2 = torch.sum(q * q, dim=-1, keepdim=True)
    return q * torch.rsqrt(n2 + 1e-24)


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
        # surgeries so far; a BinningCache is valid only at its generation
        self.generation = 0

    @property
    def count(self) -> int:
        return self.xyz.shape[0]

    def params(self) -> dict[str, nn.Parameter]:
        return {k: getattr(self, k) for k in PARAM_GROUPS}

    def scaling_act(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    def rotation_act(self) -> torch.Tensor:
        return normalize_quat(self.rotation)

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
        voxel dedup (the reference discards its result). The k-NN is the
        span "ingest.knn" of the current tracer."""
        points = np.asarray(points, np.float32)
        colors = np.asarray(colors, np.float32)
        if valid is not None:
            keep = np.asarray(valid, bool)
            points, colors = points[keep], colors[keep]
        params, _ = _new_point_params(points, colors, 0, n_rest, device)
        return GaussianModel(params)

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


def _new_point_params(points: np.ndarray, colors: np.ndarray, iteration: int, n_rest: int, device):
    """The shared init of createFromPcd and increasePcd (:150-196, 248-297)
    for host point and colour arrays [N, 3]: SH DC from RGB, zero rest,
    scales from the exact 3-NN among these points only, identity rotation,
    opacity 0.1. Returns the parameters and exist_since_iter, all on
    `device`; the k-NN is the current tracer's span "ingest.knn"."""
    n = points.shape[0]
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    with span("ingest.knn"):
        knn = knn_mean_dist2_exact(points)
    dist2 = torch.clamp_min(f32(knn), 1e-7)
    rot = torch.zeros((n, 4), device=device)
    rot[:, 0] = 1.0
    params = {
        "xyz": f32(points),
        "f_dc": rgb_to_sh(f32(colors))[:, None, :],
        "f_rest": torch.zeros((n, n_rest, 3), device=device),
        "opacity": inverse_sigmoid(0.1 * torch.ones((n, 1), device=device)),
        "scaling": torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3),
        "rotation": rot,
    }
    return params, torch.full((n,), int(iteration), dtype=torch.int32, device=device)


def voxel_hash(points: torch.Tensor) -> torch.Tensor:
    """Spatial hash [N] int32 (:136-140) as the JAX package computes it:
    floor(p / 0.05) in float32, to int32, then products and sums that wrap
    in int32. The sum is taken in int64 and reduced modulo 2**32, so that
    the CPU and the card give the same wrapped values. The divisor is a
    tensor: CUDA divides by a host scalar as a product with its reciprocal,
    which rounds otherwise."""
    voxel = torch.full((), VOXEL_SIZE, dtype=torch.float32, device=points.device)
    vi = torch.floor(points.to(torch.float32) / voxel).to(torch.int32).to(torch.int64)
    h = vi[:, 0] * _HASH_PRIMES[0] + vi[:, 1] * _HASH_PRIMES[1] + vi[:, 2] * _HASH_PRIMES[2]
    return (torch.remainder(h + 2**31, 2**32) - 2**31).to(torch.int32)


@torch.no_grad()
def _append(model: GaussianModel, adam: AdamState, new_params: dict[str, torch.Tensor],
            new_exist: torch.Tensor) -> None:
    """densificationPostfix (:492-568): the new rows after the live rows,
    with zero Adam moments; the densification statistics of every row
    reset."""
    for k in PARAM_GROUPS:
        new = new_params[k].to(torch.float32)
        setattr(model, k, nn.Parameter(torch.cat([getattr(model, k).detach(), new])))
        adam.m[k] = torch.cat([adam.m[k], torch.zeros_like(new)])
        adam.v[k] = torch.cat([adam.v[k], torch.zeros_like(new)])
    model.exist_since_iter = torch.cat([model.exist_since_iter, new_exist.to(torch.int32)])
    for k in ("max_radii2d", "xyz_grad_accum", "denom"):
        setattr(model, k, torch.zeros_like(model.exist_since_iter, dtype=torch.float32))
    model.generation += 1


@torch.no_grad()
def _prune(model: GaussianModel, adam: AdamState, drop: torch.Tensor) -> None:
    """prunePoints (:431-490): keep the rows where `drop` is False, in
    their order; moments and statistics travel with their rows. One host
    sync (`nonzero`)."""
    idx = torch.nonzero(~drop).squeeze(1)
    for k in PARAM_GROUPS:
        setattr(model, k, nn.Parameter(getattr(model, k).detach().index_select(0, idx)))
        adam.m[k] = adam.m[k].index_select(0, idx)
        adam.v[k] = adam.v[k].index_select(0, idx)
    for k in STATS:
        setattr(model, k, getattr(model, k).index_select(0, idx))
    model.generation += 1


def _rows(model: GaussianModel, idx: torch.Tensor) -> dict[str, torch.Tensor]:
    return {k: p.detach().index_select(0, idx) for k, p in model.params().items()}


def split_xyz(xyz: torch.Tensor, scaling: torch.Tensor, rotation: torch.Tensor,
              noise: torch.Tensor) -> torch.Tensor:
    """The centre of a split child (:583-590): R(q) (noise * exp(s)) + xyz
    for rows [N] of raw scaling and rotation and standard normal `noise`
    [N, 3]. The rotation is applied as explicit float32 sums (the JAX
    package's einsum at `precision="highest"`), not as a matmul that may
    run in TF32."""
    eps = noise * torch.exp(scaling)
    rot = quat_to_rotmat(normalize_quat(rotation))
    off = torch.stack(
        [rot[:, i, 0] * eps[:, 0] + rot[:, i, 1] * eps[:, 1] + rot[:, i, 2] * eps[:, 2] for i in range(3)],
        dim=-1,
    )
    return off + xyz


class DensifyCounts(NamedTuple):
    cloned: int  # rows appended by the clone
    split: int  # rows split, each into split_n children
    pruned: int  # rows removed by the opacity / size prune


@torch.no_grad()
def densify_and_prune(
    model: GaussianModel,
    adam: AdamState,
    *,
    max_grad: float,
    min_opacity: float,
    extent: float,
    max_screen_size: int,
    percent_dense: float = 0.01,
    split_n: int = 2,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
) -> DensifyCounts:
    """densifyAndPrune (:644-665), in place, in the reference's order:
    the mean gradients are taken before the clone; the clone appends the
    small Gaussians with a large gradient; the split appends `split_n`
    blocks of children of the large ones among the pre-clone rows, each
    block in row order, then drops those rows; the opacity / size prune
    runs over the result. Clone and split rows inherit exist_since_iter.

    `noise` [split_n, count, 3] is the standard normal draw of each block
    by pre-surgery row (only the split rows' are read); without it, it is
    drawn with `torch.randn` from `generator` on the model's device. Four
    host syncs, one `nonzero` for each selection and prune."""
    n0 = model.count
    dev = model.xyz.device
    grads = torch.where(model.denom > 0, model.xyz_grad_accum / model.denom, 0.0)
    max_scale = model.scaling_act().amax(dim=1)
    big_grad = grads >= max_grad

    # clone (:614-642)
    clone_idx = torch.nonzero(big_grad & (max_scale <= percent_dense * extent)).squeeze(1)
    _append(model, adam, _rows(model, clone_idx), model.exist_since_iter.index_select(0, clone_idx))

    # split (:571-612): the pre-clone rows only, so the clones (whose
    # statistics the append zeroed) are never split
    split_idx = torch.nonzero(big_grad & (max_scale > percent_dense * extent)).squeeze(1)
    if noise is None:
        noise = torch.randn((split_n, n0, 3), generator=generator, device=dev)
    src = _rows(model, split_idx)
    exist = model.exist_since_iter.index_select(0, split_idx)
    # log(exp(s) / (0.8 N)) as the JAX package writes it, divided by a
    # tensor (CUDA multiplies by the reciprocal of a host scalar)
    shrink = torch.full((), 0.8 * split_n, dtype=torch.float32, device=dev)
    child = {**src, "scaling": torch.log(torch.exp(src["scaling"]) / shrink)}
    for i in range(split_n):
        child["xyz"] = split_xyz(src["xyz"], src["scaling"], src["rotation"], noise[i].index_select(0, split_idx))
        _append(model, adam, child, exist)
    _prune(model, adam, torch.zeros(model.count, dtype=torch.bool, device=dev).index_fill_(0, split_idx, True))

    # prune (:655-662): transparent, huge on screen, huge in the world
    prune = model.opacity_act()[:, 0] < min_opacity
    if max_screen_size:
        big_vs = model.max_radii2d > max_screen_size
        big_ws = model.scaling_act().amax(dim=1) > 0.1 * extent
        prune = prune | big_vs | big_ws
    n1 = model.count
    _prune(model, adam, prune)
    return DensifyCounts(cloned=clone_idx.shape[0], split=split_idx.shape[0], pruned=n1 - model.count)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@torch.no_grad()
def increase_pcd(
    model: GaussianModel,
    adam: AdamState,
    points,
    colors,
    valid=None,
    iteration: int = 0,
) -> int:
    """increasePcd (:207-317), in place: the new points whose voxel hash no
    live Gaussian has are appended with a fresh init (3-NN scales among the
    kept points only), exist_since_iter = `iteration`. The new rows go to
    the model's device. Points [M, 3] and colours [M, 3] in [0, 1] are host
    arrays or tensors. Returns the number of points kept; reads the keep
    mask back to the host once, for the k-NN. Spans of the current
    tracer: "dedup.voxel" (the hashes and the keep mask's read-back),
    "ingest.knn"."""
    dev = model.xyz.device
    pts = _host(points).astype(np.float32)
    cols = _host(colors).astype(np.float32)
    with span("dedup.voxel"):
        pts_d = torch.as_tensor(pts, device=dev)
        keep = ~torch.isin(voxel_hash(pts_d), voxel_hash(model.xyz.detach()))
        if valid is not None:
            keep &= torch.as_tensor(_host(valid).astype(bool), device=dev)
        keep_h = keep.cpu().numpy()
    params, exist = _new_point_params(pts[keep_h], cols[keep_h], iteration, model.f_rest.shape[1], dev)
    _append(model, adam, params, exist)
    return int(keep_h.sum())


@torch.no_grad()
def prune_young(model: GaussianModel, adam: AdamState, iteration: int, stable_num_iter: int) -> int:
    """Existence pruning after a large pose correction (the reference's
    exist_since_iter_ and stable_num_iter_existence_,
    include/gaussian_model.h:151, include/gaussian_mapper.h:275): drop the
    Gaussians with exist_since_iter > iteration - stable_num_iter, in
    place. Returns the number dropped."""
    n = model.count
    _prune(model, adam, model.exist_since_iter > iteration - stable_num_iter)
    return n - model.count


@torch.no_grad()
def reset_opacity(model: GaussianModel, adam: AdamState) -> None:
    """resetOpacity (:399-408) and replaceTensorToOptimizer (:410-429), in
    place: opacity inverse_sigmoid(min(sigmoid(op), 0.01)); the opacity
    group's Adam moments zeroed, its step kept."""
    model.opacity.copy_(inverse_sigmoid(torch.clamp_max(model.opacity_act(), 0.01)))
    adam.m["opacity"] = torch.zeros_like(adam.m["opacity"])
    adam.v["opacity"] = torch.zeros_like(adam.v["opacity"])
    model.generation += 1
