"""Plain PyTorch reference of one mapping step: 3D Gaussian splatting as
published (Kerbl et al. 2023, the `diff-gaussian-rasterization` CUDA
rasterizer that GSDF-SLAM and Photo-SLAM build on), its L1 + D-SSIM loss,
autograd for the gradients, and torch's Adam. It imports nothing of the
program under test.

The rasterizer's conventions, from the published CUDA code:

* cull at view-space z <= 0.2; EWA 2D covariance with the 1.3 tan(fov/2)
  clamp and a 0.3 px low-pass; conic = inverse covariance;
* radius = ceil(3 sqrt(largest eigenvalue)); 16x16 tiles, the rect of
  tiles within the radius of the projected mean;
* per pixel, front to back by view depth (ties by Gaussian index):
  alpha = min(0.99, opacity exp(power)), skipped where power > 0 or alpha
  < 1/255; stop before the pair that would take T below 1e-4;
  C = sum alpha T c, plus T_final * background;
* the backward does not gate the 0.99 clamp (dL/dG = opacity dL/dalpha):
  written here as a straight-through clamp;
* SH colours up to degree 3, +0.5, clamped at 0.

`render_depth` renders the expected depth (each Gaussian's view z as its
colour over black) through the same preprocess, binning and blend, for the
monocular densify (`reference/mono.py`).

The image is rendered in blocks of whole tiles. The backward recomputes
each block with autograd from the loss's gradient of its pixels, so that a
block's [pairs, 256] panels are the most memory held at once. `dtype` runs
the whole step in that precision (the control runs it in bfloat16); the
per-tile transmittance sums are accumulated in float64 (float32 for the
control) before rounding.
"""

from __future__ import annotations

import math

import torch

TILE = 16
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_MIN = 1e-4
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005, -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
         -0.4570457994644658, 1.445305721320277, -0.5900435899266435)
GROUPS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")
BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-15
# pairs per block of the blend (whole tiles; a larger tile is its own block)
BLOCK_PAIRS = 65536


def no_tf32() -> None:
    """Plain float32 matrix products and convolutions on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Camera:
    """A pinhole view: world-to-camera `view` [4, 4], the OpenGL-style
    projection of the 3DGS code, image size and the background."""

    def __init__(self, t_wc, fx: float, fy: float, width: int, height: int, znear: float, zfar: float, device):
        t_wc = torch.as_tensor(t_wc, dtype=torch.float64)
        self.width, self.height = width, height
        self.tanfovx = width / (2.0 * fx)
        self.tanfovy = height / (2.0 * fy)
        top, right = self.tanfovy * znear, self.tanfovx * znear
        proj = torch.zeros((4, 4), dtype=torch.float64)
        proj[0, 0] = znear / right
        proj[1, 1] = znear / top
        proj[3, 2] = 1.0
        proj[2, 2] = zfar / (zfar - znear)
        proj[2, 3] = -(zfar * znear) / (zfar - znear)
        view = torch.linalg.inv(t_wc)
        self.view = view.to(torch.float32).to(device)
        self.full_proj = (proj @ view).to(torch.float32).to(device)
        self.campos = t_wc[:3, 3].to(torch.float32).to(device)

    @property
    def grid(self) -> tuple[int, int]:
        return (self.width + TILE - 1) // TILE, (self.height + TILE - 1) // TILE


def _rows(m: torch.Tensor, p: torch.Tensor, n: int) -> torch.Tensor:
    """(m @ [p, 1])[:n] for points [P, 3], as explicit sums."""
    return torch.stack([m[i, 0] * p[:, 0] + m[i, 1] * p[:, 1] + m[i, 2] * p[:, 2] + m[i, 3] for i in range(n)], -1)


def sh_colour(dc: torch.Tensor, rest: torch.Tensor, xyz: torch.Tensor, campos: torch.Tensor) -> torch.Tensor:
    """Degree-3 SH colour [P, 3] (computeColorFromSH): +0.5, clamped at 0."""
    d = xyz - campos
    d = d / torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True) + 1e-24)
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    sh = torch.cat([dc, rest], 1)  # [P, 16, 3]
    res = SH_C0 * sh[:, 0]
    res = res - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2] - SH_C1 * x * sh[:, 3]
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    res = (res + SH_C2[0] * xy * sh[:, 4] + SH_C2[1] * yz * sh[:, 5] + SH_C2[2] * (2 * zz - xx - yy) * sh[:, 6]
           + SH_C2[3] * xz * sh[:, 7] + SH_C2[4] * (xx - yy) * sh[:, 8])
    res = (res + SH_C3[0] * y * (3 * xx - yy) * sh[:, 9] + SH_C3[1] * xy * z * sh[:, 10]
           + SH_C3[2] * y * (4 * zz - xx - yy) * sh[:, 11] + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12]
           + SH_C3[4] * x * (4 * zz - xx - yy) * sh[:, 13] + SH_C3[5] * z * (xx - yy) * sh[:, 14]
           + SH_C3[6] * x * (xx - 3 * yy) * sh[:, 15])
    return torch.clamp_min(res + 0.5, 0.0)


def preprocess(params: dict, cam: Camera, dtype):
    """Per Gaussian: pixel mean [P, 2], conic [P, 3], opacity [P], colour
    [P, 3] (all differentiable), view depth [P], tile rect min / max [P, 2]
    and visibility [P] (not)."""
    p = {k: v.to(dtype) for k, v in params.items()}
    view, full = cam.view.to(dtype), cam.full_proj.to(dtype)
    xyz = p["xyz"]
    scale = torch.exp(p["scaling"])
    q = p["rotation"] / torch.linalg.vector_norm(p["rotation"], dim=-1, keepdim=True)
    opac = torch.sigmoid(p["opacity"][:, 0])

    t = _rows(view, xyz, 3)
    hom = _rows(full, xyz, 4)
    w_h = hom[:, 3:4] + 1e-7
    # a culled Gaussian at the camera plane gets no gradient, not a NaN
    ndc = hom[:, :2] / torch.where(w_h.abs() < 1e-6, torch.ones_like(w_h), w_h)
    mean2d = torch.stack([((ndc[:, 0] + 1) * cam.width - 1) * 0.5, ((ndc[:, 1] + 1) * cam.height - 1) * 0.5], -1)

    w, x, y, z = q.unbind(-1)
    rot = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)
    m = rot * scale[:, None, :]
    cov3 = m @ m.transpose(1, 2)

    fx, fy = cam.width / (2 * cam.tanfovx), cam.height / (2 * cam.tanfovy)
    tz = t[:, 2]
    tz_safe = torch.where(tz.abs() < 0.1, torch.full_like(tz, 0.1), tz)
    tx = torch.clamp(t[:, 0] / tz_safe, -1.3 * cam.tanfovx, 1.3 * cam.tanfovx) * tz_safe
    ty = torch.clamp(t[:, 1] / tz_safe, -1.3 * cam.tanfovy, 1.3 * cam.tanfovy) * tz_safe
    zero = torch.zeros_like(tz)
    jac = torch.stack([
        torch.stack([fx / tz_safe, zero, -fx * tx / (tz_safe * tz_safe)], -1),
        torch.stack([zero, fy / tz_safe, -fy * ty / (tz_safe * tz_safe)], -1),
    ], -2)
    tw = jac @ view[:3, :3]
    cov2 = tw @ cov3 @ tw.transpose(1, 2)
    a, b, c = cov2[:, 0, 0] + 0.3, cov2[:, 0, 1], cov2[:, 1, 1] + 0.3
    det = a * c - b * b
    det_ok = det != 0
    inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([c * inv, -b * inv, a * inv], -1)

    with torch.no_grad():
        mid = 0.5 * (a + c)
        lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
        radius = torch.ceil(3.0 * torch.sqrt(lam)).float()
        gw, gh = cam.grid
        grid = torch.tensor([gw, gh], device=xyz.device)
        m2 = mean2d.float()
        rmin = torch.minimum(torch.clamp_min(((m2 - radius[:, None]) / TILE).trunc().long(), 0), grid)
        rmax = torch.minimum(torch.clamp_min(((m2 + radius[:, None] + TILE - 1) / TILE).trunc().long(), 0), grid)
        area = (rmax - rmin).prod(-1)
        visible = (tz > 0.2) & det_ok & (area > 0) & (radius > 0)
    colour = sh_colour(p["f_dc"], p["f_rest"], xyz, cam.campos.to(dtype))
    return mean2d, conic, opac, colour, tz.detach(), rmin, rmax, visible


def bin_pairs(depth, rmin, rmax, visible, grid_w: int):
    """(Gaussian [M], tile [M]) of every (Gaussian, tile) pair in the
    rects, sorted by tile, then view depth, then Gaussian index; and each
    tile's [start, end) [T, 2]."""
    idx = torch.nonzero(visible).squeeze(1)
    idx = idx[torch.sort(depth[idx].float(), stable=True).indices]
    lo, hi = rmin[idx], rmax[idx]
    rw = (hi[:, 0] - lo[:, 0])
    counts = rw * (hi[:, 1] - lo[:, 1])
    g = torch.repeat_interleave(idx, counts)
    local = torch.arange(g.numel(), device=g.device) - torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    rwp = torch.repeat_interleave(rw, counts)
    tx = torch.repeat_interleave(lo[:, 0], counts) + local % rwp
    ty = torch.repeat_interleave(lo[:, 1], counts) + local // rwp
    tile = ty * grid_w + tx
    order = torch.sort(tile, stable=True).indices
    return g[order], tile[order]


def _blend_block(g, tile, tiles, seg_start, mean2d, conic, opac, colour, cam: Camera, bg, acc_dtype):
    """Colour [n, 256, 3] and final T [n, 256] of the tiles `tiles` [n]
    whose pairs are (g, tile) [Mb]; seg_start [Mb] is each pair's index of
    its tile's first pair within the block. The panels are pixel-major,
    [256, Mb], so that the transmittance's running sum runs along the
    contiguous axis."""
    gw, _ = cam.grid
    dt = mean2d.dtype
    j = torch.arange(TILE * TILE, device=g.device)
    ox = (tile % gw * TILE).to(dt)
    oy = (tile // gw * TILE).to(dt)
    dx = (mean2d[g, 0] - ox)[None, :] - (j % TILE).to(dt)[:, None]
    dy = (mean2d[g, 1] - oy)[None, :] - (j // TILE).to(dt)[:, None]
    cn = conic[g]
    power = -0.5 * (cn[:, 0] * dx * dx + cn[:, 2] * dy * dy) - cn[:, 1] * dx * dy
    raw = opac[g][None, :] * torch.exp(power)
    alpha = raw - torch.clamp_min(raw - ALPHA_MAX, 0.0).detach()  # straight-through clamp
    live = (power <= 0) & (alpha >= ALPHA_MIN)
    alpha = torch.where(live, alpha, torch.zeros_like(alpha))
    log1m = torch.log1p(-alpha)
    csum = torch.cumsum(log1m.to(acc_dtype), 1)
    base = torch.where((seg_start > 0)[None, :], csum[:, (seg_start - 1).clamp_min(0)], torch.zeros_like(csum))
    incl = csum - base
    excl = incl - log1m.to(acc_dtype)
    applied = incl.detach() >= math.log(T_MIN)
    wgt = alpha * torch.exp(excl).to(dt) * applied
    slot = torch.searchsorted(tiles, tile)
    n = tiles.numel()
    rgb = torch.zeros((TILE * TILE, n, 3), dtype=dt, device=g.device)
    rgb = rgb.index_add(1, slot, wgt[:, :, None] * colour[g][None, :, :])
    logt = torch.zeros((TILE * TILE, n), dtype=acc_dtype, device=g.device)
    logt = logt.index_add(1, slot, torch.where(applied, log1m.to(acc_dtype), torch.zeros_like(incl)))
    final_t = torch.exp(logt).to(dt).T
    return rgb.transpose(0, 1) + final_t[:, :, None] * bg.to(dt), final_t


def _blocks(tile: torch.Tensor, num_tiles: int):
    """Blocks of whole tiles of about BLOCK_PAIRS pairs: a list of (pair
    start, pair end, the block's tiles with pairs)."""
    counts = torch.bincount(tile, minlength=num_tiles).cpu()
    ends = torch.cumsum(counts, 0)
    out, start, t0 = [], 0, 0
    for t in range(num_tiles):
        end = int(ends[t])
        if end - start >= BLOCK_PAIRS or (t == num_tiles - 1 and end > start):
            out.append((start, end, t0, t + 1))
            start, t0 = end, t + 1
    return out


def _tile_image(tile_rgb: torch.Tensor, cam: Camera) -> torch.Tensor:
    gw, gh = cam.grid
    img = tile_rgb.reshape(gh, gw, TILE, TILE, 3).permute(0, 2, 1, 3, 4).reshape(gh * TILE, gw * TILE, 3)
    return img[: cam.height, : cam.width]


def _block_inputs(g, tile, start, end, t0, t1):
    gb, tb = g[start:end], tile[start:end]
    first = torch.searchsorted(tb, tb)  # index of each pair's tile's first pair
    tiles = torch.unique_consecutive(tb)
    return gb, tb, first, tiles


def render_and_grad(params: dict, cam: Camera, gt: torch.Tensor, bg: torch.Tensor, lambda_dssim: float,
                    dtype=torch.float32, fault: str | None = None, stats: dict | None = None):
    """The loss of the render of `params` from `cam` against `gt` [H, W, 3],
    and its gradient for each group, in `dtype`. Returns (loss, grads,
    image, the loss's gradient of the pixel means [P, 2] and the visibility
    [P], which the densification statistics read). `fault` plants a fault for the check's own test: "altered"
    reverses the render's colour channels, "half_batch" takes the loss over
    the upper half of the rows only. `stats`, if given, gathers the pairs
    and blocks rendered."""
    acc_dtype = torch.float64 if dtype == torch.float32 else torch.float32
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    mean2d, conic, opac, colour, depth, rmin, rmax, visible = preprocess(leaves, cam, dtype)
    gw, gh = cam.grid
    num_tiles = gw * gh
    g, tile = bin_pairs(depth, rmin, rmax, visible, gw)
    blocks = _blocks(tile, num_tiles)
    if stats is not None:
        stats["pairs"] = stats.get("pairs", 0) + int(g.numel())
        stats["blocks"] = stats.get("blocks", 0) + len(blocks)
    screen = [x.detach().requires_grad_(True) for x in (mean2d, conic, opac, colour)]
    bgd = bg.to(dtype)
    tile_rgb = bgd.expand(num_tiles, TILE * TILE, 3).clone()
    with torch.no_grad():
        for start, end, t0, t1 in blocks:
            gb, tb, first, tiles = _block_inputs(g, tile, start, end, t0, t1)
            rgb, _ = _blend_block(gb, tb, tiles, first, *screen, cam, bgd, acc_dtype)
            tile_rgb[tiles] = rgb
    tile_rgb.requires_grad_(True)
    image = _tile_image(tile_rgb, cam)
    img, ref = image, gt.to(dtype)
    if fault == "altered":
        img = img.flip(-1)
    elif fault == "half_batch":
        img, ref = img[: cam.height // 2], ref[: cam.height // 2]
    loss = mapper_loss(img, ref, lambda_dssim)
    (d_tiles,) = torch.autograd.grad(loss, [tile_rgb])
    for start, end, t0, t1 in blocks:
        gb, tb, first, tiles = _block_inputs(g, tile, start, end, t0, t1)
        rgb, _ = _blend_block(gb, tb, tiles, first, *screen, cam, bgd, acc_dtype)
        torch.autograd.backward(rgb, d_tiles[tiles])
    outs = [t for t, s in zip((mean2d, conic, opac, colour), screen) if s.grad is not None]
    grads_in = [s.grad for s in screen if s.grad is not None]
    torch.autograd.backward(outs, grads_in)
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v)).to(params[k].dtype) for k, v in leaves.items()}
    mean2d_grad = screen[0].grad if screen[0].grad is not None else torch.zeros_like(screen[0])
    return loss.detach(), grads, image.detach(), (mean2d_grad.float(), visible)


@torch.no_grad()
def render_depth(params: dict, cam: Camera, dtype=torch.float32):
    """The expected-depth render of `params` from `cam`: each Gaussian's
    view z blended as its colour in all three channels over black, through
    the preprocess, binning and blend of `render_and_grad`. Returns (depth
    [H, W], coverage [H, W]) in `dtype`: coverage = 1 - final T, depth = the
    blended z / max(coverage, 1e-6)."""
    acc_dtype = torch.float64 if dtype == torch.float32 else torch.float32
    mean2d, conic, opac, _, depth, rmin, rmax, visible = preprocess(params, cam, dtype)
    colour = depth[:, None].expand(-1, 3)
    gw, gh = cam.grid
    g, tile = bin_pairs(depth, rmin, rmax, visible, gw)
    bg = torch.zeros(3, dtype=dtype, device=depth.device)
    tile_z = torch.zeros((gw * gh, TILE * TILE, 3), dtype=dtype, device=depth.device)
    tile_t = torch.ones((gw * gh, TILE * TILE, 3), dtype=dtype, device=depth.device)
    for start, end, t0, t1 in _blocks(tile, gw * gh):
        gb, tb, first, tiles = _block_inputs(g, tile, start, end, t0, t1)
        z, final_t = _blend_block(gb, tb, tiles, first, mean2d, conic, opac, colour, cam, bg, acc_dtype)
        tile_z[tiles] = z
        tile_t[tiles] = final_t[:, :, None]
    coverage = 1 - _tile_image(tile_t, cam)[..., 0]
    return _tile_image(tile_z, cam)[..., 0] / torch.clamp_min(coverage, 1e-6), coverage


# ------------------------------------------------------------------ densify
def quat_rotmat(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


@torch.no_grad()
def densify_and_prune(params: dict, m: dict, v: dict, grad_accum: torch.Tensor, denom: torch.Tensor, *,
                      max_grad: float, min_opacity: float, extent: float, percent_dense: float,
                      gen: torch.Generator, split_n: int = 2) -> None:
    """3DGS's densifyAndPrune (gaussian_model.cpp), in place on the groups
    and their Adam moments: the small Gaussians whose mean screen gradient
    reaches `max_grad` are cloned, the large ones split into `split_n`
    children drawn N(0, scale) about them with their scale over 0.8 split_n,
    the split parents dropped, then the Gaussians under `min_opacity`
    pruned. New rows get zero moments. The screen-size prune is off, as the
    mapper runs it before prune_big_point_after_iter."""
    grads = torch.where(denom > 0, grad_accum / denom.clamp_min(1), torch.zeros_like(grad_accum))
    max_scale = torch.exp(params["scaling"]).amax(1)
    big = grads >= max_grad

    def append(rows: dict):
        for k in GROUPS:
            params[k] = torch.cat([params[k], rows[k]])
            m[k] = torch.cat([m[k], torch.zeros_like(rows[k])])
            v[k] = torch.cat([v[k], torch.zeros_like(rows[k])])

    def keep_rows(keep: torch.Tensor):
        for d in (params, m, v):
            for k in GROUPS:
                d[k] = d[k][keep]

    clone = torch.nonzero(big & (max_scale <= percent_dense * extent)).squeeze(1)
    append({k: params[k][clone] for k in GROUPS})
    split = torch.nonzero(big & (max_scale > percent_dense * extent)).squeeze(1)
    src = {k: params[k][split] for k in GROUPS}
    scale = torch.exp(src["scaling"])
    rot = quat_rotmat(src["rotation"])
    for _ in range(split_n):
        noise = torch.randn(scale.shape, generator=gen, dtype=scale.dtype, device=scale.device) * scale
        child = dict(src)
        child["xyz"] = src["xyz"] + (rot @ noise[:, :, None])[:, :, 0]
        child["scaling"] = torch.log(scale / (0.8 * split_n))
        append(child)
    keep = torch.ones(params["xyz"].shape[0], dtype=torch.bool, device=scale.device)
    keep[split] = False
    keep_rows(keep)
    keep_rows(torch.sigmoid(params["opacity"][:, 0]) >= min_opacity)


@torch.no_grad()
def reset_opacity(params: dict, m: dict, v: dict) -> None:
    """resetOpacity: opacity at most 0.01, its moments zeroed."""
    op = torch.clamp_max(torch.sigmoid(params["opacity"]), 0.01)
    params["opacity"] = torch.log(op / (1 - op))
    m["opacity"] = torch.zeros_like(m["opacity"])
    v["opacity"] = torch.zeros_like(v["opacity"])


# ------------------------------------------------------------------ loss
def _gauss_window(dtype, device, size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float64) - size // 2
    g = torch.exp(-(x * x) / (2 * sigma * sigma))
    g = g / g.sum()
    return (g[:, None] @ g[None, :]).to(dtype).to(device).expand(3, 1, size, size).contiguous()


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two [H, W, 3] images: 11-tap sigma-1.5 Gaussian window,
    zero padding (the 3DGS `ssim`)."""
    x, y = a.permute(2, 0, 1)[None], b.permute(2, 0, 1)[None]
    w = _gauss_window(a.dtype, a.device)
    f = lambda t: torch.nn.functional.conv2d(t, w, padding=5, groups=3)
    mu1, mu2 = f(x), f(y)
    s11 = f(x * x) - mu1 * mu1
    s22 = f(y * y) - mu2 * mu2
    s12 = f(x * y) - mu1 * mu2
    c1, c2 = 0.01**2, 0.03**2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / ((mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2))
    return m.mean()


def mapper_loss(image: torch.Tensor, gt: torch.Tensor, lambda_dssim: float) -> torch.Tensor:
    """(1 - l) L1 + l (1 - SSIM), the mapper's loss with no mask."""
    return (1 - lambda_dssim) * (image - gt).abs().mean() + lambda_dssim * (1 - ssim(image, gt))


# ------------------------------------------------------------------ adam
def expon_lr(step: float, lr_init: float, lr_final: float, delay_mult: float, max_steps: int) -> float:
    """3DGS's get_expon_lr_func with no delay steps."""
    if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
        return 0.0
    t = min(max(step / max_steps, 0.0), 1.0)
    return math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)


def group_lrs(opt: dict, iteration: int, spatial_lr_scale: float) -> dict[str, float]:
    return {
        "xyz": expon_lr(iteration, opt["position_lr_init"], opt["position_lr_final"],
                        opt["position_lr_delay_mult"], opt["position_lr_max_steps"]) * spatial_lr_scale,
        "f_dc": opt["feature_lr"],
        "f_rest": opt["feature_lr"] / 20.0,
        "opacity": opt["opacity_lr"],
        "scaling": opt["scaling_lr"],
        "rotation": opt["rotation_lr"],
    }


@torch.no_grad()
def adam(params: dict, grads: dict, m: dict, v: dict, step: int, lrs: dict) -> int:
    """torch.optim.Adam (eps 1e-15), one shared step count; in place."""
    step += 1
    bc1 = 1 - BETA1**step
    bc2 = 1 - BETA2**step
    for k in GROUPS:
        m[k].mul_(BETA1).add_(grads[k], alpha=1 - BETA1)
        v[k].mul_(BETA2).addcmul_(grads[k], grads[k], value=1 - BETA2)
        denom = (v[k].sqrt() / math.sqrt(bc2)).add_(ADAM_EPS)
        params[k].addcdiv_(m[k], denom, value=-lrs[k] / bc1)
    return step
