"""The probe kernels, and the bucket checkpoints of K1 and K4, against
their plain versions: the bars and the comparisons (and the count of
checkpoint words K1 writes, and the keep bytes K4 writes); the depth
render through K1 against the plain blend; the model surgery, the
colouriser and a short stream on the card against the same on the CPU.
Shared by chip_smoke.py and tests/test_torch_cuda.py so that each bar is
defined once.

Bars, with their reasons:

- accum and T = exp(log T), effective and raw, within FWD_SMALL on the
  small scenes (the image bar of tests/test_pallas_blend.py); accum is held
  to the bar times max(1, its largest value), since the `nocarry` stand-in
  sums every pair to ~20, not an image. At the headline the caller gives
  K1's bar;
- n_done exact on the small scenes; at the headline its mismatches are
  counted;
- `floor` holds no image: its log_t_eff is 1e-30 x a sum of mean x, so
  exp() of it is 1 whatever the sum. Its log_t_eff / FLOOR_SCALE is held
  within FLOOR_RTOL of the plain version's, relative to the tile's sum of
  |mean x| (the sum's own size where no term cancels): float32 sums of up
  to 128 terms in another order. accum and log_t_raw are exactly 0;
- gradients within BWD_SMALL scaled per field (the gradient bar of
  tests/test_pallas_blend.py); two launches of the backward bit-equal;
- the kernels that copy 32-bit words or add integers (`expand_gather` and
  the pair-table kernels) bit-equal.

The depth render blends each Gaussian's camera-space z as its colour, so
K1's colour bars scale with max |z| of the Gaussians it renders: the
blended depth (the image) is held to the caller's colour bar times max
|z|, coverage to the bar, and depth = blended / coverage where coverage >
0.5 to the bar both terms give, 4 x bar x max |z|.

Surgery on the card against the CPU from one state with one noise draw:
the counts exact; every parameter, Adam moment and statistic bit-equal,
except the values a surgery computes with exp, log, rsqrt or a division
by a constant (the split children's xyz and scaling, the new points'
parameters, the reset opacity), where the card's math library and the
CPU's may differ in the last bit: those within SURGERY_RTOL of the
largest magnitude among them (the 1e-6 of the CPU parity tests against
the JAX package).

The colouriser on the card against the same function on a CPU copy: the
validity masks equal; the points and colours bit-equal (the same
elementwise float32 ops, no contraction), or else the count of points
whose colour differs (each landed on another pixel) and the largest
errors are reported.

A short stream on the card against the same stream on the CPU (the same
frames and seed): the keyframe of every step, the iteration, the count
after every step and the binning of every step (fresh, export, cached)
equal; losses within STREAM_LOSS_ATOL, the bar of the card's training
steps against the CPU's in chip_smoke.py.

A short mono stream (probes/mono.py) on the card against the CPU: each
keyframe's samples from tracker points and the prior bit-equal in depth;
those from the depth render (K3 and K1 on the card) kept on both sides
within K1's bar, FWD_SMALL on coverage and 4 x FWD_SMALL x max |z| on the
depth (tests/test_torch_depth.py's two-term bar); a sample kept on one
side only must lie at the selection's frontier, the CPU's coverage within
FWD_SMALL of 0.5 or its depth within the depth bar of 0.2, and such
samples are counted. Counts after every feed equal, and the step log as a
short stream's.

The loss kernels (loss_fwd, loss_bwd) against the plain version on the
card, on the same tensors: the loss within LOSS_ATOL (the two means are
summed in other orders: the kernel by tiles and then in double, torch by
its own tree), the gradient within BWD_SMALL scaled (the port's gradient
bar; it is computed in the plain version's op order, so it is expected to
agree far closer), two runs' losses and gradients bit-equal (no atomics).

The Adam kernel (adam_step) against the plain version run on copies on
the card, fed the same host scalars: p, m and v bit-equal after each step
(the same float32 ops in the same order, no contraction); a clone taken
before the steps unchanged; one launch a step. Its span, "step.adam",
makes no blocking call: a tracer runs it under
torch.cuda.set_sync_debug_mode("error").

At the headline a pair within rounding of the T = 1e-4 frontier may apply
on one side only (the kernels sum log T pair by pair, the plain versions by
chunks). That moves log T_eff by at least log1p(-1/255) and, for `notrans`,
accum by up to 0.99 |log 1e-4| x colour. Such pixels (|d log T_eff| >
FLIP_LOG_T) are counted, at most MAX_FLIPS (K1 and its plain version
differ on 8 of 825,600), and accum is held on the others.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import kernels
from ..ops.blend import checkpoint_slots, checkpoints_read, keep_log_exit
from ..ops.blend_probe import FLOOR_SCALE, pair_n_done
from ..utils.observability import PhaseTimer, using

FWD_SMALL = 5e-6
BWD_SMALL = 2e-5
FLOOR_RTOL = 1e-5
FLIP_LOG_T = 1e-3
MAX_FLIPS = 80
FIELDS = {"means2d": slice(0, 2), "conics": slice(2, 5), "opacity": slice(5, 6), "colors": slice(6, 9)}
SURGERY_RTOL = 1e-6
STREAM_LOSS_ATOL = 1e-5
LOSS_ATOL = 1e-6


def bit_equal(got, want) -> bool:
    """Same shape and the same 32-bit words (NaN bits included)."""
    return got.shape == want.shape and torch.equal(got.view(torch.int32), want.view(torch.int32))


def _floor_rel_err(got_teff, want_teff, payload, ranges) -> float:
    """max over pixels of |d log_t_eff| / FLOOR_SCALE over the tile's sum
    of |mean x| (0 where both are 0)."""
    cs = torch.cat([payload.new_zeros(1, dtype=torch.float64), torch.cumsum(payload[0].abs().double(), 0)])
    abs_sum = cs[ranges[:, 1].long()] - cs[ranges[:, 0].long()]
    d = (got_teff.double() - want_teff.double()).abs() / FLOOR_SCALE
    # a NaN stays NaN and fails the bar
    return float(torch.where(d == 0, 0.0, d / abs_sum.clamp_min(1e-300)[:, None]).max())


def fwd_check(name, got, want, payload, ranges, bound, headline=False):
    """A forward probe's (accum, log_t_eff, log_t_raw, n_done) `got` against
    its plain version's `want` on the binning (ranges, payload). `name` is
    the mode, or `pair2`. Returns (errors, failed check names)."""
    acc, teff, traw, nd = got
    w_acc, w_teff, w_traw, w_nd = want
    scale = max(1.0, float(w_acc.abs().max())) if w_acc.numel() else 1.0
    if headline:
        flip = (teff - w_teff).abs() > FLIP_LOG_T
    else:
        flip = torch.zeros_like(teff, dtype=torch.bool)
    d_acc = torch.where(flip[..., None], 0.0, (acc - w_acc).abs())
    errs = dict(
        accum=float(d_acc.max()) / scale,
        t_eff=float((teff.exp() - w_teff.exp()).abs().max()),
        t_raw=float((traw.exp() - w_traw.exp()).abs().max()),
        n_done=int((nd != w_nd).sum()),
        flips=int(flip.sum()),
    )
    failed = []
    if not all(errs[k] <= bound for k in ("accum", "t_eff", "t_raw")):  # False on NaN
        failed.append(name)
    if errs["flips"] > MAX_FLIPS:
        failed.append(f"{name}-flips")
    if errs["n_done"] and not headline:
        failed.append(f"{name}-n_done")
    if name == "floor":
        errs["floor_sum"] = _floor_rel_err(teff, w_teff, payload, ranges)
        if not errs["floor_sum"] <= FLOOR_RTOL:
            failed.append("floor-sum")
        if bool(acc.ne(0).any()) or bool(traw.ne(0).any()):
            failed.append("floor-zeros")
    return errs, failed


def pair2_check(got, want, single, payload, ranges, bound, headline=False):
    """pair2's outputs against its plain version, and against the
    `chunk_exit` kernel's `single`: accum and log T bit-equal, n_done the
    pair's larger. Returns (errors, failed check names)."""
    errs, failed = fwd_check("pair2", got, want, payload, ranges, bound, headline)
    as_single = all(torch.equal(a, b) for a, b in zip(got[:3], single[:3]))
    errs["as_chunk_exit"] = as_single and torch.equal(got[3], pair_n_done(single[3]))
    if not errs["as_chunk_exit"]:
        failed.append("pair2-not-chunk_exit")
    return errs, failed


def scaled_errors(got, want) -> dict:
    """Per field of [9, M] gradients: max |got - want| over max |want|."""
    return {k: float((got[sl] - want[sl]).abs().max()) / max(float(want[sl].abs().max()), 1e-12)
            for k, sl in FIELDS.items()}


def bwd_check(got, again, want, bound):
    """The backward's per-pair gradients `got` (and a second launch's
    `again`) against the plain version's `want`. Returns (errors, failed
    check names)."""
    errs = scaled_errors(got, want)
    failed = [] if all(e <= bound for e in errs.values()) else ["bwd"]
    errs["max_abs"] = float((got - want).abs().max()) if got.numel() else 0.0
    errs["deterministic"] = torch.equal(got, again)
    if not errs["deterministic"]:
        failed.append("bwd-not-deterministic")
    return errs, failed


def checkpoint_check(got, want, ranges, nc_got, nc_want):
    """K1's or K4's bucket checkpoints `got` against `want` (the plain
    version's, or K1's), on the words that K2 reads under both n_contrib.
    Returns (largest |d colour sum|, largest |d T| with T = exp(log T),
    whether those words are bit-equal, words compared). The colour sums and
    T are K1's accum and final T at a shorter render, so they take K1's
    bars."""
    rows, read = checkpoints_read(ranges, torch.minimum(nc_got, nc_want))
    g, w = got[rows][read], want[rows][read]
    if not g.numel():
        return 0.0, 0.0, True, 0
    return (float((g[:, 1:] - w[:, 1:]).abs().max()), float((g[:, 0].exp() - w[:, 0].exp()).abs().max()),
            bit_equal(g, w), int(read.sum()))


def checkpoint_words_written(ranges, payload, grid_w, shape) -> int:
    """K1 launched into a NaN-filled checkpoint buffer of `shape`: the words
    it wrote (a written word holds a finite log T), to hold against the
    words K2 reads. The launch is made outside the wrapper, so it is not
    counted."""
    num_tiles, dev = ranges.shape[0], ranges.device
    ckpt = torch.full(shape, float("nan"), device=dev)
    outs = (torch.empty((num_tiles, 256, 3), device=dev), torch.empty((num_tiles, 256), device=dev),
            torch.empty((num_tiles, 256), dtype=torch.int32, device=dev))
    kernels.launch("gsdf_blend_fwd", ranges.data_ptr(), payload.data_ptr(), payload.shape[1], num_tiles, grid_w,
                   *(o.data_ptr() for o in outs), ckpt.data_ptr())
    return int(torch.isfinite(ckpt[..., 0]).sum())


def keep_bytes(ranges, payload, grid_w, margin) -> torch.Tensor:
    """K4 launched into a keep buffer of 2s: the bytes it left, uint8 [M],
    to hold against the plain keep flags (a byte K4 did not write stays
    2). The launch is made outside the wrapper, so it is not counted."""
    num_tiles, dev, m = ranges.shape[0], ranges.device, payload.shape[1]
    keep = torch.full((m,), 2, dtype=torch.uint8, device=dev)
    outs = (torch.empty((num_tiles, 256, 3), device=dev), torch.empty((num_tiles, 256), device=dev),
            torch.empty((num_tiles, 256), dtype=torch.int32, device=dev),
            torch.empty((checkpoint_slots(num_tiles, m), 256, 4), device=dev))
    kernels.launch("gsdf_blend_fwd_export", ranges.data_ptr(), payload.data_ptr(), m, num_tiles, grid_w,
                   keep_log_exit(margin), *(o.data_ptr() for o in outs), keep.data_ptr())
    return keep


def log1p_live_mismatches() -> int:
    """The float32 alphas in [1/255, 0.99], every one, at which the
    live-range log1p of K4 and the probe kernels (csrc/common.cuh) differs
    in any bit from the CUDA math library's log1pf(-alpha), which K1 and
    blend_probe_fwd call: 0 keeps K4 bit-equal to K1, and pair2 to
    chunk_exit. Needs the card."""
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    kernels.launch("gsdf_log1p_live_mismatches", out.data_ptr())
    return int(out.item())


def depth_check(model, cam, cfg, depth, cov) -> dict:
    """`render_depth_state`'s outputs (`depth`, `cov`; K3 and K1 on a CUDA
    model) against the same depth render binned by the plain route and
    blended by K1's plain version on the same device: the blended depth's max abs
    error over max |z| of the rendered Gaussians (`accum`), the coverage's
    (`coverage`), the depth's where both coverages exceed 0.5 over max |z|
    (`depth`), the covered pixels and max |z|. Launches no kernel."""
    from ..ops import binning
    from ..ops.blend import assemble_image, blend_fwd_plain
    from ..ops.projection import preprocess

    gw, gh = cfg.grid
    with torch.no_grad():
        v, xyz = cam.view, model.xyz
        z = v[2, 0] * xyz[:, 0] + v[2, 1] * xyz[:, 1] + v[2, 2] * xyz[:, 2] + v[2, 3]
        op = model.opacity_act()[:, 0]
        pre = preprocess(xyz, model.scaling_act(), model.rotation_act(), op, model.f_dc, model.f_rest, cam,
                         width=cfg.width, height=cfg.height, sh_degree=cfg.sh_degree,
                         colors_precomp=z[:, None].expand(-1, 3))
        ranges, _, payload, _ = binning.bin_and_pack_plain(pre.depths, pre.rect_min, pre.rect_max,
                                                           pre.tiles_touched, pre.means2d, pre.conics, op,
                                                           pre.colors, grid_w=gw, grid_h=gh)
        acc, lte, _, _ = blend_fwd_plain(ranges, payload, gw, gh)
        img, final_t = assemble_image(acc, lte, torch.zeros(3, device=xyz.device), grid_w=gw, grid_h=gh,
                                      width=cfg.width, height=cfg.height)
        cov_p = 1.0 - final_t
        depth_p = img[..., 0] / torch.clamp_min(cov_p, 1e-6)
        z_max = float(z[pre.tiles_touched > 0].abs().max())
        both = (cov > 0.5) & (cov_p > 0.5)
        blended = depth * torch.clamp_min(cov, 1e-6)
        return dict(
            accum=float((blended - img[..., 0]).abs().max()) / z_max,
            coverage=float((cov - cov_p).abs().max()),
            depth=float((depth - depth_p)[both].abs().max()) / z_max if bool(both.any()) else 0.0,
            covered=int((cov > 0.5).sum()), z_max=z_max,
        )


def split_children(xyz_after, xyz_before) -> torch.Tensor:
    """Rows of `xyz_after` whose centre (its three float32 words) no row of
    `xyz_before` has: the children a split made. A CPU bool tensor."""
    import numpy as np

    words = lambda x: np.ascontiguousarray(x.detach().cpu().numpy()).view(np.dtype((np.void, 12))).ravel()
    return torch.from_numpy(~np.isin(words(xyz_after), words(xyz_before)))


def surgery_check(got_model, got_adam, want_model, want_adam, computed, fields=("xyz", "scaling")) -> dict:
    """A surgery's result (`got`, on any device) against the same surgery's
    (`want`, on the CPU) from one state and one noise draw. The rows
    `computed` (a CPU bool mask: the split children, or the new points) of
    `fields` are held to SURGERY_RTOL of the largest magnitude among them;
    everything else must be bit-equal. Returns the counts, the names not
    bit-equal, each field's scaled error and rows not bit-equal over the
    computed rows, and `ok`."""
    from ..models.gaussian_model import STATS
    from ..models.optimizer import PARAM_GROUPS

    out = dict(counts=(got_model.count, want_model.count), not_equal=[], errs={}, rows_differ={},
               computed=int(computed.sum()), ok=False)
    if got_model.count != want_model.count:
        out["not_equal"].append("count")
        return out
    for k in PARAM_GROUPS:
        got, want = getattr(got_model, k).detach().cpu(), getattr(want_model, k).detach()
        if k in fields:
            g, w = got[computed].reshape(int(computed.sum()), -1), want[computed].reshape(int(computed.sum()), -1)
            scale = max(float(w.abs().max()), 1e-30) if w.numel() else 1.0
            out["errs"][k] = float((g - w).abs().max()) / scale if w.numel() else 0.0
            out["rows_differ"][k] = int((g.view(torch.int32) != w.view(torch.int32)).any(1).sum())
            got, want = got[~computed], want[~computed]
        if not bit_equal(got, want):
            out["not_equal"].append(k)
        for moment, a, b in (("m", got_adam.m, want_adam.m), ("v", got_adam.v, want_adam.v)):
            if not bit_equal(a[k].cpu(), b[k]):
                out["not_equal"].append(f"{moment}.{k}")
    for k in STATS:
        if not bit_equal(getattr(got_model, k).cpu(), getattr(want_model, k)):
            out["not_equal"].append(k)
    if got_adam.step != want_adam.step:
        out["not_equal"].append("step")
    out["ok"] = not out["not_equal"] and all(e <= SURGERY_RTOL for e in out["errs"].values())
    return out


def colorize_check(got, want) -> dict:
    """`ops/colorize.py::colorize_pointcloud` outputs (ColorizedCloud) on
    the card against the CPU's."""
    got = type(got)(*(x.cpu() for x in got))
    valid = want.valid
    moved = (got.colors[valid] != want.colors[valid]).any(dim=1)
    out = {
        "n": int(valid.numel()),
        "valid": int(valid.sum()),
        "valid_equal": bool(torch.equal(got.valid, valid)),
        "points_bit_equal": bool(torch.equal(got.points_world, want.points_world)),
        "points_err": float((got.points_world - want.points_world).abs().max()),
        "colors_bit_equal": bool(torch.equal(got.colors[valid], want.colors[valid])),
        "moved_pixels": int(moved.sum()),
        "colors_err": float((got.colors[valid] - want.colors[valid]).abs().max()) if valid.any() else 0.0,
    }
    out["ok"] = out["valid_equal"] and bool(torch.isfinite(got.points_world).all())
    return out


def mono_samples_check(got: dict, want: dict) -> dict:
    """A mono keyframe's samples (`GaussianMapper.last_mono_samples` with
    the view's `z_max`) on the card against the CPU's."""
    import numpy as np

    from ..engine.mapper import MONO_SOURCES

    depth_bar = 4 * FWD_SMALL * want["z_max"]
    src_g, src_w = got["source"], want["source"]
    render = MONO_SOURCES.index("render")
    fixed = (src_w >= 0) & (src_w != render)  # tracker points and the prior
    fixed_equal = bool(np.array_equal(src_g[fixed], src_w[fixed])
                       and np.array_equal(got["depth"][fixed], want["depth"][fixed]))
    both = (src_g == render) & (src_w == render)
    one = (src_g == render) != (src_w == render)
    cov, dep = want["coverage"][one], want["rendered_depth"][one]
    at_frontier = (np.abs(cov - 0.5) <= FWD_SMALL) | (np.abs(dep - 0.2) <= depth_bar)
    depth_err = float(np.abs(got["depth"][both] - want["depth"][both]).max()) if both.any() else 0.0
    out = {
        "samples": len(src_w), **{k: int((src_w == i).sum()) for i, k in enumerate(MONO_SOURCES)},
        "fixed_equal": fixed_equal, "frontier": int(one.sum()), "depth_err": depth_err, "depth_bar": depth_bar,
    }
    out["ok"] = (fixed_equal and bool(at_frontier.all()) and depth_err <= depth_bar
                 and np.array_equal(got["gy"], want["gy"]) and np.array_equal(got["gx"], want["gx"]))
    return out


def mono_run_check(got: dict, want: dict) -> dict:
    """`probes/mono.py::short_mono_run` on the card against the CPU: every
    keyframe's samples (mono_samples_check), the counts after every feed,
    and the step log (stream_check). Once a sample differs at the frontier
    the two maps differ by a Gaussian, so the counts and steps are compared
    only while none has."""
    per_kf = [mono_samples_check(g, w) for g, w in zip(got["samples"], want["samples"])]
    frontier = [r["frontier"] for r in per_kf]
    upto = next((i for i, f in enumerate(frontier) if f), len(per_kf))
    steps_upto = sum(1 for r in want["log"] if r["fid"] < upto)
    out = {
        "keyframes": len(per_kf), "frontier": sum(frontier), "compared_keyframes": upto,
        "samples_ok": all(r["ok"] for r in per_kf), "depth_err": max(r["depth_err"] for r in per_kf),
        "sources": {k: sum(r[k] for r in per_kf) for k in ("tracker", "render", "prior")},
        "counts_equal": got["counts"][:upto] == want["counts"][:upto],
        "steps": stream_check(got["log"][:steps_upto], want["log"][:steps_upto]),
    }
    out["ok"] = out["samples_ok"] and out["counts_equal"] and out["steps"]["ok"]
    return out


def stream_check(got_steps: list[dict], want_steps: list[dict]) -> dict:
    """`stream.run_stream`'s step records on the card against the CPU's."""
    key = lambda s: [(r["iteration"], r["fid"], r["count"], r["binning"]) for r in s]
    loss_err = max((abs(a["loss"] - b["loss"]) for a, b in zip(got_steps, want_steps)), default=0.0)
    out = {"steps": len(got_steps), "sequence_equal": key(got_steps) == key(want_steps), "loss_err": loss_err}
    out["ok"] = out["sequence_equal"] and loss_err <= STREAM_LOSS_ATOL and len(got_steps) > 0
    return out


# The preprocess kernels against the plain version on the card: the fields
# that fix the pairs and their depth order bit-equal (the same float32 ops
# in the same order, no contraction); the colours within PREPROCESS_COLOR
# (torch sums the SH terms in its own order: a few ulps of values near 1);
# the gradients within BWD_SMALL, scaled per input (the port's gradient
# bar), over each group of rows on its own.
PREPROCESS_EXACT = ("means2d", "depths", "conics", "radii", "rect_min", "rect_max", "tiles_touched")
PREPROCESS_COLOR = 1e-6
PREPROCESS_INPUTS = ("means3d", "scales", "quats", "dc", "sh_rest")


def preprocess_cotangents(pre, seed: int = 0, visible_only: bool = True, depths: bool = False):
    """Cotangents of means2d, depths, conics and colours as the blend's
    backward hands them over: column slices of one [P, 9] buffer (K2's
    layout), standard normal, zero on rows the binning culls unless not
    `visible_only`; the depths' None unless `depths`."""
    p = pre.means2d.shape[0]
    dev = pre.means2d.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn((p, 9), generator=gen, device=dev)
    if visible_only:
        g = g * (pre.tiles_touched > 0)[:, None]
    ct_depths = torch.randn((p,), generator=gen, device=dev) if depths else None
    return g[:, 0:2], ct_depths, g[:, 2:5], g[:, 6:9]


def preprocess_check(args, cam, st, cts=None, groups=None, means2d_offset=None, colors_precomp=None) -> dict:
    """`preprocess_fwd` and `preprocess_bwd` against `preprocess_plain` and
    its autograd VJP, on the same tensors. `args` are the six inputs,
    `st` a PreprocessSettings; `cts` the four cotangents
    (`preprocess_cotangents` of the plain forward by default); `groups`
    {name: bool mask [P]} the rows whose gradients are scaled together
    (all rows by default). Returns the comparisons and "ok"."""
    from ..ops import projection

    means3d, scales, quats, opac, dc, rest = args
    got = projection.preprocess_fwd(*args, cam, st, means2d_offset=means2d_offset, colors_precomp=colors_precomp)
    leaves = [t.detach().clone().requires_grad_(True) for t in (means3d, scales, quats, dc, rest)]
    with torch.enable_grad():
        want = projection.preprocess_plain(
            leaves[0], leaves[1], leaves[2], opac, leaves[3], leaves[4], cam, width=st.width, height=st.height,
            sh_degree=st.sh_degree, scale_modifier=st.scale_modifier, means2d_offset=means2d_offset,
            active_sh_degree=st.active_sh_degree, colors_precomp=colors_precomp,
        )
        if cts is None:
            cts = preprocess_cotangents(want)
        outs = [(o, c) for o, c in zip((want.means2d, want.depths, want.conics, want.colors), cts)
                if c is not None and o.requires_grad]
        g_want = torch.autograd.grad([o for o, _ in outs], leaves, [c for _, c in outs], allow_unused=True)
    g_got = projection.preprocess_bwd(means3d, scales, quats, dc, rest, cam, st, *cts,
                                      sh=colors_precomp is None)
    torch.cuda.synchronize()
    res = {"bit_equal": {f: bit_equal(getattr(got, f), getattr(want, f).detach()) for f in PREPROCESS_EXACT}}
    res["colors"] = float((got.colors - want.colors.detach()).abs().max()) if got.colors.numel() else 0.0
    res["pairs"] = [int(got.tiles_touched.sum()), int(want.tiles_touched.sum())]
    res["visible"] = int((want.tiles_touched > 0).sum())
    groups = groups or {"all": torch.ones(means3d.shape[0], dtype=torch.bool, device=means3d.device)}
    res["grads"] = {}
    for gname, rows in groups.items():
        errs = {}
        for name, a, b, x in zip(PREPROCESS_INPUTS, g_got, g_want, leaves):
            if a is None:  # no SH gradients where the colours are given
                continue
            b = torch.zeros_like(x) if b is None else b
            a, b = a[rows], b[rows]
            errs[name] = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12) if b.numel() else 0.0
        res["grads"][gname] = errs
    res["ok"] = (all(res["bit_equal"].values()) and res["colors"] <= PREPROCESS_COLOR
                 and res["pairs"][0] == res["pairs"][1]
                 and all(e <= BWD_SMALL for errs in res["grads"].values() for e in errs.values()))
    return res


def loss_inputs(width: int, height: int, masked: bool, device, seed: int = 0):
    """(rendered, gt, mask) for the loss kernels at width x height: the gt
    uniform in [0, 1]; the render the gt plus noise, clipped, equal to it on
    ~5% of the pixels (where the L1 term's sign is 0), and a crop of a
    buffer whose width is a multiple of 16, strided as the blend's image;
    with `masked`, an [H, W] float mask of 0s on a border band and ~10% of
    the pixels, else None."""
    gen = torch.Generator(device=device).manual_seed(seed)
    gt = torch.rand((height, width, 3), generator=gen, device=device)
    noisy = (gt + 0.1 * torch.randn(gt.shape, generator=gen, device=device)).clamp(0.0, 1.0)
    tie = torch.rand((height, width, 1), generator=gen, device=device) < 0.05
    buf = torch.zeros((height, (width + 15) // 16 * 16, 3), device=device)
    buf[:, :width] = torch.where(tie, gt, noisy)
    rendered = buf[:, :width]
    mask = None
    if masked:
        mask = (torch.rand((height, width), generator=gen, device=device) > 0.1).float()
        band = max(1, min(height, width) // 20)
        mask[:band] = 0.0
        mask[:, :band] = 0.0
    return rendered, gt, mask


def loss_check(rendered, gt, mask, lambda_dssim: float = 0.2) -> dict:
    """`loss_fwd` and `loss_bwd` against `mapper_loss_plain` and
    `mapper_loss_grad_plain` on the same tensors, the upstream gradient 1;
    twice, the second run held bit-equal to the first. Returns the
    comparisons and "ok"."""
    from ..ops import losses

    one = torch.ones((), device=rendered.device)
    runs = []
    for _ in range(2):
        loss, dmaps = losses.loss_fwd(rendered, gt, mask, lambda_dssim)
        runs.append((loss, dmaps, losses.loss_bwd(rendered, gt, mask, lambda_dssim, dmaps, one)))
    want = losses.mapper_loss_plain(rendered, gt, mask, lambda_dssim)
    g_want = losses.mapper_loss_grad_plain(rendered, gt, mask, lambda_dssim, one)
    _, x, _ = losses._masked(rendered, gt, mask)
    maps_want = torch.stack([d.permute(2, 0, 1) for d in losses.ssim_derivative_maps(x, gt)])
    torch.cuda.synchronize()
    (loss, dmaps, grad), (loss2, dmaps2, grad2) = runs
    res = {
        "shape": list(rendered.shape), "masked": mask is not None,
        "loss": float(loss), "loss_err": abs(float(loss) - float(want)),
        "grad_err": float((grad - g_want).abs().max()) / max(float(g_want.abs().max()), 1e-12),
        "grad_bit_equal": bit_equal(grad, g_want), "maps_bit_equal": bit_equal(dmaps, maps_want),
        "repeat_bit_equal": bit_equal(loss, loss2) and bit_equal(grad, grad2) and bit_equal(dmaps, dmaps2),
    }
    res["ok"] = res["loss_err"] <= LOSS_ATOL and res["grad_err"] <= BWD_SMALL and res["repeat_bit_equal"]
    return res


def binning_check(depths, rect_min, rect_max, tiles_touched, means2d, conics, opacities, colors, *, grid_w: int,
                  grid_h: int) -> dict:
    """The card's binning route (`bin_and_pack_depth_first`: `bin_count`,
    `bin_write`, the tile sort, K3) against the plain route on the same
    tensors: ranges, gid, payload and total_pairs bit-equal; and
    `bin_count` and `bin_write` alone against their plain versions (the
    counts and totals equal, the tile ids and Gaussians bit-equal). Returns
    the comparisons, each pass's largest absolute difference from its plain
    version (`count_err`, `write_err`; inf where the shapes differ), the
    pair counts and "ok"."""
    from ..ops import binning

    a = (depths, rect_min, rect_max, tiles_touched, means2d, conics, opacities, colors)
    got = binning.bin_and_pack_depth_first(*a, grid_w=grid_w, grid_h=grid_h)
    want = binning.bin_and_pack_plain(*a, grid_w=grid_w, grid_h=grid_h)
    gauss = (binning.depth_order(depths), tiles_touched, rect_min, rect_max, means2d, conics,
             torch.log(opacities * 255.0))
    counts, totals = binning.bin_count(*gauss, grid_w=grid_w)
    counts_p, totals_p = binning.bin_count_plain(*gauss, grid_w=grid_w)
    kept = int(totals_p[0])
    w = (*gauss, torch.cumsum(counts_p, 0), kept)
    tiles, pair_gid = binning.bin_write(*w, grid_w=grid_w)
    tiles_p, pair_gid_p = binning.bin_write_plain(*w, grid_w=grid_w)
    torch.cuda.synchronize()
    same = lambda x, y: x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)  # integers

    def err(*pairs):  # the largest |x - y| over integer pairs
        if any(x.shape != y.shape for x, y in pairs):
            return float("inf")
        return max((float((x.long() - y.long()).abs().max()) for x, y in pairs if x.numel()), default=0.0)

    res = {
        "pairs": int(want.gid.shape[0]), "total_pairs": want.total_pairs, "tiles": grid_w * grid_h,
        "ranges": same(got.ranges, want.ranges), "gid": same(got.gid, want.gid),
        "payload": bit_equal(got.payload, want.payload), "total": got.total_pairs == want.total_pairs,
        "counts": same(counts, counts_p), "totals": same(totals, totals_p),
        "tile_ids": same(tiles, tiles_p), "pair_gid": same(pair_gid, pair_gid_p),
    }
    res["ok"] = all(v for k, v in res.items() if isinstance(v, bool))
    res["count_err"] = err((counts, counts_p), (totals, totals_p))
    res["write_err"] = err((tiles, tiles_p), (pair_gid, pair_gid_p))
    return res


def adam_inputs(shapes: dict[str, tuple], device, seed: int = 0, step: int = 776, misaligned: bool = False):
    """(params, grads, AdamState) for the Adam kernel: normal parameters,
    gradients and first moments, second moments |normal| x 1e-6, the step
    count `step`, each group of `shapes`. With `misaligned`, every tensor
    a view one float into its buffer, so not 16-byte aligned."""
    from ..models.optimizer import AdamState

    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(shape, scale=1.0, positive=False):
        n = int(np.prod(shape))
        buf = torch.randn(n + int(misaligned), generator=gen, device=device)
        t = buf[int(misaligned):].view(shape)
        return (t.abs() if positive else t).mul_(scale)

    params = {k: draw(s) for k, s in shapes.items()}
    grads = {k: draw(s, 1e-2) for k, s in shapes.items()}
    state = AdamState(m={k: draw(s, 1e-2) for k, s in shapes.items()},
                      v={k: draw(s, 1e-6, positive=True) for k, s in shapes.items()}, step=step)
    return params, grads, state


def adam_check(params, grads, state, lrs, steps: int = 2) -> dict:
    """`optimizer.adam_step` (the kernel, on CUDA tensors) for `steps`
    steps with the same gradients against `adam_step_plain` on copies on
    the card, fed the same host scalars: p, m and v bit-equal after every
    step; a clone taken before the steps unchanged; one launch a step; the
    gradients' layouts. Updates `params` and `state`. Returns the
    comparisons and "ok"."""
    from ..models import optimizer

    before = {k: (params[k].clone(), state.m[k].clone(), state.v[k].clone()) for k in params}
    before_cpu = {k: tuple(t.cpu() for t in ts) for k, ts in before.items()}
    want_p = {k: p.clone() for k, p in params.items()}
    want_m = {k: t.clone() for k, t in state.m.items()}
    want_v = {k: t.clone() for k, t in state.v.items()}
    n0 = kernels.LAUNCHES["adam_step"]
    not_equal = []
    for i in range(steps):
        optimizer.adam_step(params, grads, state, lrs)
        bc1, _, sqrt_bc2 = optimizer.bias_corrections(state.step)
        for k in want_p:
            want_m[k], want_v[k] = optimizer.adam_step_plain(
                want_p[k], grads[k], want_m[k], want_v[k], float(np.float32(lrs[k]) / bc1), float(sqrt_bc2))
        torch.cuda.synchronize()
        for k in params:
            for what, got, want in (("p", params[k], want_p[k]), ("m", state.m[k], want_m[k]),
                                    ("v", state.v[k], want_v[k])):
                if not bit_equal(got, want):
                    not_equal.append(f"step {i + 1}: {what}.{k}")
    kept = all(bit_equal(a.cpu(), b) for k in before for a, b in zip(before[k], before_cpu[k]))
    moved = all(not bit_equal(params[k], before[k][0]) for k in params if params[k].numel())
    res = {
        "n": {k: int(p.shape[0]) if p.dim() else 1 for k, p in params.items()},
        "elements": sum(p.numel() for p in params.values()), "steps": steps, "t": state.step,
        "launches": kernels.LAUNCHES["adam_step"] - n0, "not_equal": not_equal, "snapshot_unchanged": kept,
        "moved": moved,
        "grad_layouts": {k: [list(g.shape), list(g.stride()), g.is_contiguous(), g.data_ptr() % 16]
                         for k, g in grads.items()},
    }
    res["ok"] = not not_equal and kept and moved and res["launches"] == steps
    return res


class _SyncErrorSpans(PhaseTimer):
    """A tracer that runs each span named in `names` under
    torch.cuda.set_sync_debug_mode("error"), so a blocking call inside it
    raises; counts the spans it guarded."""

    def __init__(self, names):
        super().__init__()
        self.names = set(names)
        self.guarded = 0

    @contextlib.contextmanager
    def phase(self, name: str):
        with super().phase(name):
            if name not in self.names:
                yield
                return
            self.guarded += 1
            torch.cuda.set_sync_debug_mode("error")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode("default")


def adam_span_check(model, adam, cam, gt, bg, cfg, opt, n_steps: int = 6) -> dict:
    """`n_steps` train_steps of `model`, in turns fresh, export and cached
    (through a cache exported first), with the span "step.adam" guarded
    against blocking calls: the error a blocking call there raised (None),
    the spans guarded and the adam_step launches, one a step. Returns them
    and "ok"."""
    from ..engine.train import train_step

    _, cache = train_step(model, adam, cam, gt, None, bg, 0, 1.0, cfg, opt, export_binning_cache=True)
    kinds = ({}, {"export_binning_cache": True}, {"binning_cache": cache})
    tracer = _SyncErrorSpans(("step.adam",))
    n0 = kernels.LAUNCHES["adam_step"]
    error = None
    with using(tracer):
        try:
            for i in range(n_steps):
                train_step(model, adam, cam, gt, None, bg, 1 + i, 1.0, cfg, opt, **kinds[i % 3])
        except RuntimeError as e:
            error = str(e)
    torch.cuda.synchronize()
    res = {"steps": n_steps, "guarded": tracer.guarded, "launches": kernels.LAUNCHES["adam_step"] - n0,
           "error": error}
    res["ok"] = error is None and tracer.guarded == n_steps == res["launches"]
    return res


def adam_street_inputs(device, size: str, seed: int = 0, step: int = 776):
    """(params, grads, AdamState) as a cell's step hands them to Adam: the
    street scene of `size` (scene.STREET_SIZES: "polish" 0.63M, "drive"
    2.0M Gaussians) as a model, its gradients from one render at KITTI's
    1226x370 against a uniform random image through the step's own loss
    and autograd backward (the layouts autograd returns), and moments
    drawn as `adam_inputs` does."""
    from ..engine.train import render_state
    from ..models import GaussianModel
    from ..models.optimizer import PARAM_GROUPS
    from ..ops import RasterizeConfig
    from ..ops.losses import mapper_loss
    from ..ops.transforms import inverse_sigmoid
    from .scene import KITTI_HEIGHT, KITTI_WIDTH, STREET_SIZES, kitti_camera, street_scene

    n, _, scale_mult = STREET_SIZES[size]
    means, scales, quats, opac, dc, rest = street_scene(device, n, scale_mult, seed=seed)
    model = GaussianModel({"xyz": means, "f_dc": dc, "f_rest": rest, "opacity": inverse_sigmoid(opac)[:, None],
                           "scaling": torch.log(scales), "rotation": quats})
    del means, scales, quats, opac, dc, rest
    gen = torch.Generator(device=device).manual_seed(seed)
    gt = torch.rand((KITTI_HEIGHT, KITTI_WIDTH, 3), generator=gen, device=device)
    m2d0 = torch.zeros((n, 2), device=device, requires_grad=True)
    out = render_state(model, kitti_camera(device), torch.zeros(3, device=device),
                       RasterizeConfig(height=KITTI_HEIGHT, width=KITTI_WIDTH), means2d_offset=m2d0)
    params = model.params()
    grads = torch.autograd.grad(mapper_loss(out.image, gt, None, 0.2), [params[k] for k in PARAM_GROUPS] + [m2d0])
    del out
    _, _, state = adam_inputs({k: tuple(params[k].shape) for k in PARAM_GROUPS}, device, seed=seed + 1, step=step)
    return {k: params[k].data for k in PARAM_GROUPS}, dict(zip(PARAM_GROUPS, grads[:-1])), state
