"""Per-Gaussian rasterization preprocess: cull, project, 2D covariance.

Port of `gsdf_slam_tpu/ops/projection.py` (preprocessCUDA,
forward.cu:198-312) as plain tensor ops; autograd supplies the backward.
The numeric conventions are the JAX package's:

* frustum cull at p_view.z <= 0.2 (auxiliary.h:160-194);
* p_w = 1 / (p_hom.w + 1e-7) (forward.cu:250);
* EWA cov2D with the 1.3*tanfov clamp and the +0.3 px low-pass
  (forward.cu:104-149);
* radius = ceil(3 * sqrt(lambda_max)) (forward.cu:282-291), kept for the
  radii/visibility filter from the 3-sigma rect's area;
* the tile rect is the opacity-tight AABB of the alpha >= 1/255 ellipse,
  capped at the reference's 3-sigma rect, with the inclusive pixel-coverage
  upper bound (PARITY.md D7).

The tensors are sized to the live Gaussians; there is no capacity padding
and no liveness mask.

`preprocess` is one `torch.autograd.Function`, `Preprocess`: on a CUDA
tensor its forward and backward are the kernels `preprocess_fwd` and
`preprocess_bwd` (csrc/preprocess.cu, one launch each), which raise where
they cannot run; on a CPU tensor the forward is `preprocess_plain`, the
plain tensor ops, and the backward is the autograd VJP of that plain
forward, recomputed. The kernels replace no Pallas kernel: the JAX package
leaves the preprocess to XLA's fusion.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from .sh import eval_sh_color
from .transforms import CameraMatrices, build_cov3d, ndc_to_pix

TILE = 16  # BLOCK_X == BLOCK_Y == 16 (cuda_rasterizer/config.h:15-16)


class Preprocessed(NamedTuple):
    """Per-Gaussian screen-space quantities [P, ...]."""

    means2d: torch.Tensor  # [P, 2] pixel coords
    depths: torch.Tensor  # [P] camera-space z
    conics: torch.Tensor  # [P, 3] inverse 2D covariance (a, b, c)
    colors: torch.Tensor  # [P, 3] RGB from SH
    radii: torch.Tensor  # [P] int32, 0 => culled
    rect_min: torch.Tensor  # [P, 2] int32 tile coords (x, y)
    rect_max: torch.Tensor  # [P, 2] int32 tile coords, exclusive
    tiles_touched: torch.Tensor  # [P] int32 rect area (0 => skip)


def tile_grid(width: int, height: int) -> tuple[int, int]:
    return (width + TILE - 1) // TILE, (height + TILE - 1) // TILE


def _affine3(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Rows 0..2 of m @ [p, 1], written elementwise."""
    return torch.stack(
        [m[i, 0] * p[:, 0] + m[i, 1] * p[:, 1] + m[i, 2] * p[:, 2] + m[i, 3] for i in range(3)],
        dim=-1,
    )


def compute_cov2d(
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    cam: CameraMatrices,
    focal_x: torch.Tensor,
    focal_y: torch.Tensor,
) -> torch.Tensor:
    """EWA projection J W Sigma W^T J^T of the 3D covariance, plus the
    0.3 px low-pass on the diagonal. Returns (cov_xx, cov_xy, cov_yy) [P, 3]."""
    r = cam.view[:3, :3]
    t = _affine3(means3d, cam.view)
    # |tz| >= 0.1 keeps culled Gaussians' Jacobians finite; visible ones have
    # tz > 0.2 and are unaffected.
    tz_raw = t[:, 2]
    tz = torch.where(tz_raw.abs() < 0.1, torch.full_like(tz_raw, 0.1), tz_raw)
    limx = 1.3 * cam.tanfovx
    limy = 1.3 * cam.tanfovy
    tx = torch.clamp(t[:, 0] / tz, -limx, limx) * tz
    ty = torch.clamp(t[:, 1] / tz, -limy, limy) * tz

    inv_tz = 1.0 / tz
    j00 = focal_x * inv_tz
    j02 = -(focal_x * tx) * inv_tz * inv_tz
    j11 = focal_y * inv_tz
    j12 = -(focal_y * ty) * inv_tz * inv_tz
    t0 = j00[:, None] * r[0][None, :] + j02[:, None] * r[2][None, :]
    t1 = j11[:, None] * r[1][None, :] + j12[:, None] * r[2][None, :]

    c = cov3d  # (xx, xy, xz, yy, yz, zz)
    a0, a1, a2 = t0[:, 0], t0[:, 1], t0[:, 2]
    b0, b1, b2 = t1[:, 0], t1[:, 1], t1[:, 2]
    s00 = a0 * c[:, 0] + a1 * c[:, 1] + a2 * c[:, 2]
    s01 = a0 * c[:, 1] + a1 * c[:, 3] + a2 * c[:, 4]
    s02 = a0 * c[:, 2] + a1 * c[:, 4] + a2 * c[:, 5]
    r00 = b0 * c[:, 0] + b1 * c[:, 1] + b2 * c[:, 2]
    r01 = b0 * c[:, 1] + b1 * c[:, 3] + b2 * c[:, 4]
    r02 = b0 * c[:, 2] + b1 * c[:, 4] + b2 * c[:, 5]
    cxx = s00 * a0 + s01 * a1 + s02 * a2 + 0.3
    cxy = s00 * b0 + s01 * b1 + s02 * b2
    cyy = r00 * b0 + r01 * b1 + r02 * b2 + 0.3
    return torch.stack([cxx, cxy, cyy], dim=-1)


def preprocess_plain(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    dc: torch.Tensor,
    sh_rest: torch.Tensor,
    cam: CameraMatrices,
    *,
    width: int,
    height: int,
    sh_degree: int,
    scale_modifier: float = 1.0,
    means2d_offset: torch.Tensor | None = None,
    active_sh_degree: int | None = None,
    colors_precomp: torch.Tensor | None = None,
) -> Preprocessed:
    """`preprocess` as plain tensor ops, autograd supplying the backward: the
    CPU route of `Preprocess` and the version its kernels are held to.

    `means2d_offset` is an all-zeros [P, 2] tensor added to the projected
    pixel means; its gradient is the screen-space positional gradient that
    densification reads (the reference's retained screenspace_points grad,
    gaussian_renderer.cpp:41-48). `colors_precomp` [P, 3], where given,
    replaces the SH colours as they are, unclamped (the reference's
    override_color slot).
    """
    gw, gh = tile_grid(width, height)
    focal_x = width / (2.0 * cam.tanfovx)
    focal_y = height / (2.0 * cam.tanfovy)

    v = cam.view
    p_view_z = v[2, 0] * means3d[:, 0] + v[2, 1] * means3d[:, 1] + v[2, 2] * means3d[:, 2] + v[2, 3]
    valid = p_view_z > 0.2

    fp = cam.full_proj
    p_hom = torch.stack(
        [fp[i, 0] * means3d[:, 0] + fp[i, 1] * means3d[:, 1] + fp[i, 2] * means3d[:, 2] + fp[i, 3] for i in range(4)],
        dim=-1,
    )
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    p_proj = p_hom[:, :2] * p_w[:, None]

    cov2d = compute_cov2d(means3d, build_cov3d(scales, quats, scale_modifier), cam, focal_x, focal_y)

    det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] * cov2d[:, 1]
    valid = valid & (det != 0.0)
    det_safe = torch.where(det == 0.0, torch.ones_like(det), det)
    inv_det = 1.0 / det_safe
    conics = torch.stack(
        [cov2d[:, 2] * inv_det, -cov2d[:, 1] * inv_det, cov2d[:, 0] * inv_det], dim=-1
    )

    mid = 0.5 * (cov2d[:, 0] + cov2d[:, 2])
    lambda1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(lambda1))

    means2d = torch.stack([ndc_to_pix(p_proj[:, 0], width), ndc_to_pix(p_proj[:, 1], height)], dim=-1)
    if means2d_offset is not None:
        means2d = means2d + means2d_offset

    # Everything below is integer rect bookkeeping: no gradient flows.
    m2 = means2d.detach()
    c2 = cov2d.detach()
    rf = radius_f.detach()
    grid_i = torch.tensor([gw, gh], dtype=torch.int32, device=m2.device)
    zero_i = torch.zeros((), dtype=torch.int32, device=m2.device)

    def clip_grid(x):  # clip into [0, grid]; x is int32 [P, 2]
        return torch.minimum(torch.maximum(x, zero_i), grid_i)

    # tight per-axis AABB of the {alpha >= 1/255} ellipse, NOT capped at
    # 9 sigma^2: the 3-sigma square is enforced by the min with radius_f
    op = opacities.detach()
    power_cap = torch.clamp_min(2.0 * torch.log(torch.clamp_min(op, 1e-30) * 255.0), 0.0)
    ext = torch.ceil(torch.sqrt(power_cap[:, None] * torch.clamp_min(c2[:, [0, 2]], 0.0)))
    ext = torch.minimum(ext, rf[:, None])
    # the reference-exact 3-sigma rect, kept for the radii/visibility filter
    rmin3 = clip_grid(((m2 - rf[:, None]) / TILE).to(torch.int32))
    rmax3_f = torch.clamp_min((m2 + rf[:, None] + TILE - 1) / TILE, 0.0)
    rmax3 = torch.minimum(rmax3_f.to(torch.int32), grid_i)
    area3 = (rmax3[:, 0] - rmin3[:, 0]) * (rmax3[:, 1] - rmin3[:, 1])

    rmin = clip_grid(((m2 - ext) / TILE).to(torch.int32))
    # inclusive pixel-coverage bound (D7), clamped into the 3-sigma rect
    rmax_f = torch.clamp_min(torch.floor(m2 + ext) / TILE + 1.0, 0.0)
    rmax = torch.minimum(torch.minimum(rmax_f.to(torch.int32), rmax3), grid_i)
    # strictly below 1/255 opacity can never contribute anywhere
    zero_ext = op * 255.0 < 1.0
    area = torch.where(zero_ext, zero_i, (rmax[:, 0] - rmin[:, 0]) * (rmax[:, 1] - rmin[:, 1]))

    valid_radii = valid & (area3 > 0)
    valid = valid & (area > 0)

    if colors_precomp is None:
        colors = eval_sh_color(dc, sh_rest, means3d, cam.campos, sh_degree, active_sh_degree)
    else:
        colors = colors_precomp

    radii = torch.where(valid_radii, rf, torch.zeros_like(rf)).to(torch.int32)
    tiles_touched = torch.where(valid, area, zero_i).to(torch.int32)
    return Preprocessed(
        means2d=means2d,
        depths=p_view_z,
        conics=conics,
        colors=colors,
        radii=radii,
        rect_min=rmin,
        rect_max=rmax,
        tiles_touched=tiles_touched,
    )


class PreprocessSettings(NamedTuple):
    """The static arguments of a preprocess."""

    width: int
    height: int
    sh_degree: int
    scale_modifier: float
    active_sh_degree: int | None

    def n_coeffs(self, n_rest: int) -> int:
        """SH coefficients summed, as eval_sh_color: the degree's, cut to the
        active degree's and to the coefficients there are."""
        k = (self.sh_degree + 1) ** 2
        if self.active_sh_degree is not None and self.active_sh_degree < self.sh_degree:
            k = (self.active_sh_degree + 1) ** 2
        return min(k, 1 + n_rest)


def _camera_ptrs(cam: CameraMatrices) -> tuple[int, ...]:
    return tuple(t.data_ptr() for t in (cam.view, cam.full_proj, cam.campos, cam.tanfovx, cam.tanfovy))


def _check_inputs(means3d, scales, quats, dc, sh_rest, cam: CameraMatrices, st: PreprocessSettings) -> None:
    """Raise unless the kernels can take these inputs: float32, contiguous,
    on means3d's device, of the preprocess's shapes, SH degree <= 3."""
    dev = means3d.device
    p = means3d.shape[0]
    for name, t, shape in (("means3d", means3d, (p, 3)), ("scales", scales, (p, 3)), ("quats", quats, (p, 4)),
                           ("dc", dc, (p, 1, 3)), ("sh_rest", sh_rest, (p, -1, 3)),
                           ("view", cam.view, (4, 4)), ("full_proj", cam.full_proj, (4, 4)),
                           ("campos", cam.campos, (3,)), ("tanfovx", cam.tanfovx, ()),
                           ("tanfovy", cam.tanfovy, ())):
        kernels.check(name, t, torch.float32, shape, dev)
    if not 0 <= st.sh_degree <= 3:
        raise ValueError(f"preprocess kernels: SH degree must be in [0, 3], got {st.sh_degree}")


def _ptr(t) -> int | None:
    return t.data_ptr() if t is not None else None


def _strides(t, n: int = 2) -> tuple[int, ...]:
    return tuple(t.stride()) if t is not None else (0,) * n


def preprocess_fwd(means3d, scales, quats, opacities, dc, sh_rest, cam: CameraMatrices, st: PreprocessSettings,
                   means2d_offset=None, colors_precomp=None) -> Preprocessed:
    """Kernel `preprocess_fwd`: every field of `Preprocessed` in one launch,
    bit-equal to `preprocess_plain` on the card but for the colours' last
    bits (the SH sum's order). Reads the camera through device pointers; a
    CUDA tensor only (no plain fallback)."""
    _check_inputs(means3d, scales, quats, dc, sh_rest, cam, st)
    dev = means3d.device
    p = means3d.shape[0]
    kernels.check("opacities", opacities, torch.float32, (p,), dev)
    if means2d_offset is not None:
        kernels.check("means2d_offset", means2d_offset, torch.float32, (p, 2), dev)
    if colors_precomp is not None:
        kernels.check("colors_precomp", colors_precomp, torch.float32, (p, 3), dev, contiguous=False)
    kernels.library()  # builds on first use; raises where it cannot
    gw, gh = tile_grid(st.width, st.height)
    f = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    i = lambda *s: torch.empty(s, dtype=torch.int32, device=dev)
    out = Preprocessed(means2d=f(p, 2), depths=f(p), conics=f(p, 3), colors=f(p, 3), radii=i(p),
                       rect_min=i(p, 2), rect_max=i(p, 2), tiles_touched=i(p))
    kernels.LAUNCHES["preprocess_fwd"] += 1
    kernels.launch(
        "gsdf_preprocess_fwd", means3d.data_ptr(), scales.data_ptr(), quats.data_ptr(), opacities.data_ptr(),
        dc.data_ptr(), sh_rest.data_ptr(), sh_rest.shape[1], _ptr(means2d_offset), _ptr(colors_precomp),
        *_strides(colors_precomp), *_camera_ptrs(cam), p, st.width, st.height, gw, gh,
        st.n_coeffs(sh_rest.shape[1]), st.scale_modifier, *(t.data_ptr() for t in out),
    )
    return out


def preprocess_bwd(means3d, scales, quats, dc, sh_rest, cam: CameraMatrices, st: PreprocessSettings, ct_means2d,
                   ct_depths, ct_conics, ct_colors, sh: bool = True):
    """Kernel `preprocess_bwd`: the gradients of means3d, scales, quats and,
    with `sh`, of dc and sh_rest (zeros above the active degree) from the
    cotangents of means2d [P, 2], depths [P], conics [P, 3] and colours
    [P, 3], each read through its strides (None reads as zeros). The
    forward's intermediates are recomputed from the inputs. A CUDA tensor
    only (no plain fallback)."""
    _check_inputs(means3d, scales, quats, dc, sh_rest, cam, st)
    p = means3d.shape[0]
    for name, t, shape in (("ct_means2d", ct_means2d, (p, 2)), ("ct_depths", ct_depths, (p,)),
                           ("ct_conics", ct_conics, (p, 3)), ("ct_colors", ct_colors, (p, 3))):
        if t is not None:
            kernels.check(name, t, torch.float32, shape, means3d.device, contiguous=False)
    kernels.library()  # builds on first use; raises where it cannot
    g_means, g_scales, g_quats = torch.empty_like(means3d), torch.empty_like(scales), torch.empty_like(quats)
    g_dc, g_rest = (torch.empty_like(dc), torch.empty_like(sh_rest)) if sh else (None, None)
    kernels.LAUNCHES["preprocess_bwd"] += 1
    kernels.launch(
        "gsdf_preprocess_bwd", means3d.data_ptr(), scales.data_ptr(), quats.data_ptr(), dc.data_ptr(),
        sh_rest.data_ptr(), sh_rest.shape[1], *_camera_ptrs(cam), p, st.width, st.height,
        st.n_coeffs(sh_rest.shape[1]), st.scale_modifier, _ptr(ct_means2d), *_strides(ct_means2d),
        _ptr(ct_depths), *_strides(ct_depths, 1), _ptr(ct_conics), *_strides(ct_conics), _ptr(ct_colors),
        *_strides(ct_colors), g_means.data_ptr(), g_scales.data_ptr(), g_quats.data_ptr(), _ptr(g_dc), _ptr(g_rest),
    )
    return g_means, g_scales, g_quats, g_dc, g_rest


def _plain(inputs, cam: CameraMatrices, st: PreprocessSettings) -> Preprocessed:
    means3d, scales, quats, opacities, dc, sh_rest, means2d_offset, colors_precomp = inputs
    return preprocess_plain(
        means3d, scales, quats, opacities, dc, sh_rest, cam, width=st.width, height=st.height,
        sh_degree=st.sh_degree, scale_modifier=st.scale_modifier, means2d_offset=means2d_offset,
        active_sh_degree=st.active_sh_degree, colors_precomp=colors_precomp,
    )


# the differentiable inputs of Preprocess, in its argument order, and the
# outputs with a cotangent
_N_INPUTS = 8
_N_FLOAT_OUTPUTS = 4  # means2d, depths, conics, colors


class Preprocess(torch.autograd.Function):
    """The preprocess of `preprocess`. Inputs: means3d, scales, quats,
    opacities, dc, sh_rest, means2d_offset (or None), colors_precomp (or
    None), the five camera tensors and the `PreprocessSettings`; outputs: the
    `Preprocessed` fields. Gradients reach means3d, scales, quats, dc,
    sh_rest, means2d_offset and colors_precomp; opacities get none (they
    reach only the integer rects), as in the plain version. The backward
    saves only the inputs."""

    @staticmethod
    def forward(ctx, means3d, scales, quats, opacities, dc, sh_rest, means2d_offset, colors_precomp,
                view, full_proj, campos, tanfovx, tanfovy, st):
        cam = CameraMatrices(view, full_proj, campos, tanfovx, tanfovy)
        inputs = (means3d, scales, quats, opacities, dc, sh_rest, means2d_offset, colors_precomp)
        if kernels.runs_plain(means3d):
            out = _plain(inputs, cam, st)
        else:
            out = preprocess_fwd(means3d, scales, quats, opacities, dc, sh_rest, cam, st,
                                 means2d_offset=means2d_offset, colors_precomp=colors_precomp)
        ctx.save_for_backward(*inputs, view, full_proj, campos, tanfovx, tanfovy)
        ctx.st = st
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(out.radii, out.rect_min, out.rect_max, out.tiles_touched)
        return tuple(out)

    @staticmethod
    def backward(ctx, *cts):
        saved = ctx.saved_tensors
        inputs, cam = saved[:_N_INPUTS], CameraMatrices(*saved[_N_INPUTS:])
        cts = cts[:_N_FLOAT_OUTPUTS]
        want = ctx.needs_input_grad[:_N_INPUTS]
        if kernels.runs_plain(inputs[0]):
            grads = _plain_vjp(inputs, cam, ctx.st, cts, want)
        else:
            grads = _kernel_vjp(inputs, cam, ctx.st, cts)
        return (*(g if w else None for g, w in zip(grads, want)), None, None, None, None, None, None)


def _plain_vjp(inputs, cam, st, cts, want):
    """The autograd VJP of `preprocess_plain`, its forward recomputed."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(w) if x is not None else None for x, w in zip(inputs, want)]
        out = _plain(leaves, cam, st)[:_N_FLOAT_OUTPUTS]
        pairs = [(o, c) for o, c in zip(out, cts) if c is not None and o.requires_grad]
        wrt = [x for x, w in zip(leaves, want) if w]
        if not pairs or not wrt:
            return (None,) * _N_INPUTS
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [c for _, c in pairs], allow_unused=True))
    return tuple(next(got) if w else None for w in want)


def _kernel_vjp(inputs, cam, st, cts):
    means3d, scales, quats, _, dc, sh_rest, means2d_offset, colors_precomp = inputs
    ct_m2d, ct_depths, ct_conics, ct_colors = cts
    sh = colors_precomp is None
    g_means, g_scales, g_quats, g_dc, g_rest = preprocess_bwd(
        means3d, scales, quats, dc, sh_rest, cam, st, ct_m2d, ct_depths, ct_conics, ct_colors, sh=sh
    )
    g_offset = ct_m2d if means2d_offset is not None else None
    g_precomp = ct_colors if not sh else None
    return g_means, g_scales, g_quats, None, g_dc, g_rest, g_offset, g_precomp


def preprocess(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    dc: torch.Tensor,
    sh_rest: torch.Tensor,
    cam: CameraMatrices,
    *,
    width: int,
    height: int,
    sh_degree: int,
    scale_modifier: float = 1.0,
    means2d_offset: torch.Tensor | None = None,
    active_sh_degree: int | None = None,
    colors_precomp: torch.Tensor | None = None,
) -> Preprocessed:
    """Preprocess every Gaussian of the map (`Preprocess`: on the card the
    kernels, on the CPU `preprocess_plain`).

    `means2d_offset` is an all-zeros [P, 2] tensor added to the projected
    pixel means; its gradient is the screen-space positional gradient that
    densification reads (the reference's retained screenspace_points grad,
    gaussian_renderer.cpp:41-48). `colors_precomp` [P, 3], where given,
    replaces the SH colours as they are, unclamped (the reference's
    override_color slot).
    """
    st = PreprocessSettings(width, height, sh_degree, float(scale_modifier), active_sh_degree)
    return Preprocessed(*Preprocess.apply(
        means3d, scales, quats, opacities, dc, sh_rest, means2d_offset, colors_precomp,
        cam.view, cam.full_proj, cam.campos, cam.tanfovx, cam.tanfovy, st,
    ))
