"""Plain PyTorch reference of a monocular keyframe's inactive-geometry
densify (Photo-SLAM's mono mode): the depth of each of the keyframe's
samples and where it came from, and the points they add to the depth cache.
It imports nothing of the program under test.

A keyframe of h x w pixels is sampled at rows and columns stride // 2 +
i * stride, stride = max(4, min(h, w) // 60), row by row. Each sample's
depth comes from the first of:

* "tracker": the nearest of the keyframe's tracker points projected into
  its camera (view z > 0.2, inside the image) if its squared pixel distance
  is at most the reach's square; in float64, the first index of the least
  squared distance;
* "render": the map's expected-depth render (`splat.render_depth`; the map
  already grown by the tracker points) where its coverage is over 0.5 and
  its depth over 0.2;
* "prior": where no sample has a depth, every sample at the flat prior.

A sample whose depth is not over 0.2 has none (-1). The samples with a
depth are backprojected into the world in float64, rounded to float32,
with their pixels' colours, and join the depth cache; every `depth_cache`
keyframes the whole cache grows the map.

The keyframe's camera pose T_cw is the inverse of its float32 T_wc, taken
in float64 and rounded to float32 (numpy), as the mapper's keyframe holds
it: the tracker points' pixels then round alike on both sides, and a near
tie between two of them goes the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from . import splat

SOURCES = ("tracker", "render", "prior")  # the codes 0, 1, 2; -1 for none
MIN_DEPTH = 0.2
MIN_COVERAGE = 0.5
# samples a block of the nearest search
BLOCK = 2048


def keyframe_pose(t_wc) -> np.ndarray:
    """T_cw [4, 4] float32 of a float32 T_wc."""
    return np.linalg.inv(np.asarray(t_wc, np.float32).astype(np.float64)).astype(np.float32)


def sample_grid(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The samples' rows and columns [S], row by row."""
    stride = max(4, min(h, w) // 60)
    gy, gx = torch.meshgrid(torch.arange(stride // 2, h, stride, device=device),
                            torch.arange(stride // 2, w, stride, device=device), indexing="ij")
    return gy.reshape(-1), gx.reshape(-1)


def _affine(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return torch.stack([m[i, 0] * p[:, 0] + m[i, 1] * p[:, 1] + m[i, 2] * p[:, 2] + m[i, 3] for i in range(3)], -1)


def nearest(points: torch.Tensor, t_cw: np.ndarray, calib: dict, gy: torch.Tensor, gx: torch.Tensor,
            reach: float, hi: torch.dtype) -> torch.Tensor:
    """The depth [S] in `hi` of each sample's nearest projected tracker
    point within `reach` pixels, NaN where there is none."""
    dev = points.device
    p = _affine(torch.as_tensor(t_cw, device=dev).to(hi), points.to(hi))
    z = p[:, 2]
    u = calib["fx"] * p[:, 0] / z + calib["cx"]
    v = calib["fy"] * p[:, 1] / z + calib["cy"]
    ok = (z > MIN_DEPTH) & (u >= 0) & (u < calib["width"]) & (v >= 0) & (v < calib["height"])
    su, sv, sz = u[ok], v[ok], z[ok]
    out = torch.full(gy.shape, float("nan"), dtype=hi, device=dev)
    if not len(sz):
        return out
    for i in range(0, len(gy), BLOCK):
        d2 = (gx[i : i + BLOCK, None].to(hi) - su[None, :]) ** 2 + (gy[i : i + BLOCK, None].to(hi) - sv[None, :]) ** 2
        j = torch.argmin(d2, dim=1)
        near = d2.gather(1, j[:, None])[:, 0] <= reach * reach
        out[i : i + BLOCK] = torch.where(near, sz[j], out[i : i + BLOCK])
    return out


def densify(params: dict, frame, cache: dict, calib: dict, mapper: dict, dtype, swapped: bool = False):
    """The keyframe `frame`'s samples on the map `params` (already grown by
    its tracker points) and the depth cache `cache` (the program's, before
    the keyframe: "points", "colors", lists of float32 arrays; "cached").
    Returns (the samples: "depth" [S] float32, NaN where none, "source"
    [S] int8; the cache's points and colours [N, 3] in `dtype` if this
    keyframe flushes it, else None). `dtype` below float32 (the control)
    takes the float64 parts in float32. `swapped` (a planted fault) takes
    the render's depth before the tracker's."""
    dev = params["xyz"].device
    hi = torch.float64 if dtype == torch.float32 else torch.float32
    h, w = calib["height"], calib["width"]
    gy, gx = sample_grid(h, w, dev)
    t_cw = keyframe_pose(frame.t_wc)
    depth = torch.full(gy.shape, float("nan"), dtype=torch.float32, device=dev)
    source = torch.full(gy.shape, -1, dtype=torch.int8, device=dev)

    def tracker():
        pts = torch.as_tensor(frame.points, device=dev).to(dtype)
        d = nearest(pts, t_cw, calib, gy, gx, float(mapper.get("Monocular.inactive_geo_densify_max_pixel_dist", 20.0)),
                    hi).to(dtype).float()
        take = depth.isnan() & ~d.isnan()
        depth[take], source[take] = d[take], SOURCES.index("tracker")

    def render():
        todo = depth.isnan()
        if not todo.any() or params["xyz"].shape[0] == 0:
            return
        cam = splat.Camera(frame.t_wc, calib["fx"], calib["fy"], w, h, mapper["Camera.z_near"], mapper["Camera.z_far"],
                           dev)
        dep, cov = splat.render_depth(params, cam, dtype)
        flat = gy * w + gx
        d, c = dep.reshape(-1)[flat].float(), cov.reshape(-1)[flat].float()
        take = todo & (c > MIN_COVERAGE) & (d > MIN_DEPTH)
        depth[take], source[take] = d[take], SOURCES.index("render")

    for fill in ((render, tracker) if swapped else (tracker, render)):
        fill()
    if depth.isnan().all():
        depth[:] = float(mapper.get("Monocular.init_depth", 2.0))
        source[:] = SOURCES.index("prior")
    ok = ~depth.isnan() & (depth > MIN_DEPTH)
    source[~ok] = -1
    samples = {"depth": torch.where(ok, depth, float("nan")).cpu().numpy(), "source": source.cpu().numpy()}
    if not ok.any():
        return samples, None

    zc = depth[ok].to(hi)
    cam_pts = torch.stack([(gx[ok].to(hi) - calib["cx"]) / calib["fx"] * zc,
                           (gy[ok].to(hi) - calib["cy"]) / calib["fy"] * zc, zc], -1)
    c2w = torch.as_tensor(np.linalg.inv(t_cw.astype(np.float64)), device=dev).to(hi)
    points = [torch.as_tensor(np.asarray(a), device=dev).to(dtype) for a in cache["points"]]
    colours = [torch.as_tensor(np.asarray(a), device=dev).to(dtype) for a in cache["colors"]]
    points.append(_affine(c2w, cam_pts).float().to(dtype))
    colours.append(torch.as_tensor(frame.image, device=dev)[gy[ok], gx[ok]].to(dtype))
    if cache["cached"] + 1 < max(1, int(mapper.get("Mapper.depth_cache", 1))):
        return samples, None
    return samples, (torch.cat(points), torch.cat(colours))
