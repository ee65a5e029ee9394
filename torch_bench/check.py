"""The check that decides `correct`: the program's own path at the timed
sizes against the plain reference (`reference/`).

After the window, the same mapper runs the check segment through the
window's own calls: for a streaming cell the next keyframe (colourise and
feed_keyframe), then CHECK_STEPS train_for_one_iteration calls on the
keyframes its sampler draws; and where the schedule densifies soon, a
surgery segment (`program_segment`). The state before each segment is
snapshotted on the device; the program is then freed, and the reference
replays the segments from the snapshots and the traffic's own frames,
taking from the program only which keyframe each step drew.

Compared, each as a gap against the reference (LEAVES: the six parameter
groups):

* loss_gap: the largest |loss - reference| / |reference| over the steps;
* grad_gap: over the leaves, the largest | |g| - |g_ref| | / max(|g_ref|,
  the median leaf's |g_ref|) of the first step's gradient; the program's
  is read from its Adam state, (m1 - beta1 m0) / (1 - beta1);
* change_gap: the same for each leaf's change over the steps;
  both leave out the leaves whose reference gradient is under a thousandth
  of the median leaf's (round-off moves them under Adam);
* colour_gap (LiDAR): the mean |colour - reference| over the colourised
  points, row by row, plus the share by which their counts differ;
  point_gap: the largest |world point - reference| over the largest
  |reference|;
* surgery_count_gap and surgery_gap (where the schedule densifies): after
  the surgery segment's densify (and opacity reset), the gap of the
  Gaussians' count over the reference's, and the largest gap of a leaf's
  norm over the reference's, xyz left out: the split children's offsets
  are drawn from each side's own generator;
* kept_gap (streaming cells): | kept - kept_ref | / kept_ref of the ingest;
  scale_gap: | |s| - |s_ref| | / |s_ref| of the new rows' initial scales;
  dc_gap: the largest gap of a colour channel's sum of the new rows' SH DC
  over the sum of the reference's three. In a monocular cell the new rows
  are those of the tracker points and of the depth cache's flush together:
  before the main segment the check feeds, unchecked, the keyframes that
  bring the cache to one short of its flush, so the checked keyframe
  flushes it (`reference/mono.py`); the cache before each checked feed is
  snapshotted with the parameters;
* mono_source_gap (monocular cells): the share of a checked keyframe's
  samples whose depth came from another source (tracker, render, prior or
  none) than the reference's; mono_depth_gap: the largest | depth -
  reference | / reference over the samples of the same source; each the
  larger over the checked keyframes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference import ingest, mono, splat

LEAVES = splat.GROUPS
BETA1 = splat.BETA1
# a leaf is left out below this share of the median leaf's gradient norm
ROUNDOFF_SHARE = 1e-3


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _state(model, adam) -> dict:
    """A snapshot, on the device, of the parameters and Adam's state."""
    return {
        "params": {k: getattr(model, k).detach().clone() for k in LEAVES},
        "m": {k: adam.m[k].clone() for k in LEAVES},
        "v": {k: adam.v[k].clone() for k in LEAVES},
        "step": int(adam.step),
    }


def _schedule(config: dict):
    c = config["mapper"]
    return (int(c.get("Optimization.densify_from_iter", 500)), int(c.get("Optimization.densify_until_iter", 15000)),
            int(c.get("Optimization.densification_interval", 100)), int(c.get("Optimization.opacity_reset_interval", 3000)))


def densify_at(config: dict, iteration: int) -> bool:
    """Does the mapper densify after step `iteration` (gaussian_mapper.cpp:449-461)?"""
    frm, until, every, _ = _schedule(config)
    return iteration < until and iteration > frm and every > 0 and iteration % every == 0


def reset_at(config: dict, iteration: int) -> bool:
    """Does the mapper reset the opacities after step `iteration`?"""
    _, until, _, reset = _schedule(config)
    return iteration < until and reset > 0 and iteration % reset == 0


def cadence_due(config: dict, iteration: int) -> bool:
    return densify_at(config, iteration) or reset_at(config, iteration)


def mono_densify(config: dict) -> bool:
    """Does the cell feed monocular keyframes (a tracker's points and no
    depth) that the mapper densifies?"""
    return "tracker" in config["sensors"] and bool(config["mapper"].get("Mapper.inactive_geo_densify", 1))


def depth_cache(config: dict) -> int:
    """Keyframes a flush of the monocular depth cache."""
    return max(1, int(config["mapper"].get("Mapper.depth_cache", 1)))


def flush_feeds(config: dict) -> int:
    """The most keyframes the check feeds, unchecked, to bring the depth
    cache to one short of its flush."""
    return depth_cache(config) - 1 if mono_densify(config) else 0


# the steps of the main segment; the most iterations trained, unchecked,
# to reach the surgery segment: the first densify (iteration 500 in the
# RGB-D and monocular configurations) lies up to ~380 iterations past a
# window that trains slowly behind its keyframes
CHECK_STEPS = 3
SURGERY_REACH = 400


def _run_program(cell, steps: int, feed: bool) -> dict:
    """Snapshot the mapper, feed the next keyframe (if `feed`), train
    `steps` iterations; what the program gave."""
    mp = cell.mapper
    seg = {"s0": _state(mp.model, mp.adam), "n0": mp.model.count}
    if feed:
        seg["kf"] = cell.next_kf
        if mono_densify(cell.config):
            seg["cache0"] = {"points": [a.copy() for a in mp.depth_cache_points],
                             "colors": [a.copy() for a in mp.depth_cache_colors], "cached": mp.depth_cached}
        fd = cell.feed(cell.next_kf)
        cell.next_kf += 1
        if fd is not None:
            seg["colourised"] = (np.asarray(fd.points), np.asarray(fd.colors))
        if "cache0" in seg:
            seg["mono"] = {k: mp.last_mono_samples[k].copy() for k in ("depth", "source")}
            seg["cached"] = mp.depth_cached
    p0 = {k: getattr(mp.model, k).detach().clone() for k in LEAVES}
    m0 = {k: mp.adam.m[k].clone() for k in LEAVES}
    n0 = seg["n0"]
    if feed:
        seg["kept"] = mp.model.count - n0
        seg["new_scale_norm"] = _norm(torch.exp(p0["scaling"][n0:, 0]))
        seg["new_dc_sums"] = p0["f_dc"][n0:, 0].double().sum(0).tolist()
    mp.step_log = []
    losses = []
    for j in range(steps):
        out = mp.train_for_one_iteration()
        losses.append(float(out["loss"]))
        if j == 0:
            seg["grad_norms"] = {k: _norm((mp.adam.m[k] - BETA1 * m0[k]) / (1 - BETA1)) for k in LEAVES}
    seg["losses"] = losses
    seg["fids"] = [e["fid"] for e in mp.step_log]
    seg["binnings"] = [e["binning"] for e in mp.step_log]
    seg["iterations"] = [e["iteration"] for e in mp.step_log]
    if mp.model.count == p0["xyz"].shape[0]:
        seg["change_norms"] = {k: _norm(getattr(mp.model, k).detach() - p0[k]) for k in LEAVES}
    seg["final_norms"] = {k: _norm(getattr(mp.model, k).detach()) for k in LEAVES}
    seg["final_count"] = mp.model.count
    return seg


def program_segment(cell) -> dict:
    """The check's segments on the program: the main one (the next
    keyframe of a streaming cell, then CHECK_STEPS steps, no surgery among
    them), and where the schedule densifies within SURGERY_REACH
    iterations, the surgery segment: train up to two steps short of the
    densify, feed a keyframe (its ingest resets the densification
    statistics), and take the two steps, the second followed by the
    densify. In a monocular cell the keyframes that bring the depth cache
    to one short of its flush are fed first, unchecked."""
    mp = cell.mapper
    if cell.check_feeds:
        for _ in range(flush_feeds(cell.config) - mp.depth_cached):
            cell.feed(cell.next_kf)
            cell.next_kf += 1
    while any(cadence_due(cell.config, mp.iteration + j) for j in range(1, CHECK_STEPS + 1)):
        mp.train_for_one_iteration()
    seg = _run_program(cell, CHECK_STEPS, cell.check_feeds)
    nxt = next((i for i in range(mp.iteration + 2, mp.iteration + SURGERY_REACH) if densify_at(cell.config, i)), None)
    if cell.check_feeds and nxt is not None:
        while mp.iteration < nxt - 2:
            mp.train_for_one_iteration()
        seg["surgery"] = _run_program(cell, 2, True)
    return seg


def _opt(mapper: dict) -> dict:
    keys = ("position_lr_init", "position_lr_final", "position_lr_delay_mult", "position_lr_max_steps",
            "feature_lr", "opacity_lr", "scaling_lr", "rotation_lr")
    return {k: mapper[f"Optimization.{k}"] for k in keys}


def _replay(cell, seg: dict, variant: str | None, dtype, gen: torch.Generator) -> dict:
    """One segment replayed by the reference from its snapshot."""
    dev = cell.device
    s0 = seg["s0"]
    params = {k: s0["params"][k].to(dtype).clone() for k in LEAVES}
    m = {k: s0["m"][k].to(dtype).clone() for k in LEAVES}
    v = {k: s0["v"][k].to(dtype).clone() for k in LEAVES}
    step = s0["step"]
    c = cell.stream.calib
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)
    out = {"stats": {}}
    if "kf" in seg:
        f = cell.stream.frame(seg["kf"])
        if f.scan is not None:
            pts, cols = ingest.colourise(t(f.scan), t(f.image), t(c["proj"]), t(c["tr"]), t(f.lidar_pose), dtype)
        elif f.depth is not None:
            pts, cols = ingest.backproject(t(f.depth), t(f.image), f.t_wc, c["fx"], c["fy"], c["cx"], c["cy"],
                                           dtype=dtype)
        else:
            pts, cols = t(f.points).to(dtype), t(f.colors).to(dtype)
        if variant == "altered" and f.scan is not None:
            cols = cols.flip(-1)
        if f.scan is not None:
            out["colourised"] = (pts.float().cpu().numpy(), cols.float().cpu().numpy())
        cap = int(cell.config.get("ingest_capacity", 1 << 16))

        def grow(p: torch.Tensor, q: torch.Tensor) -> dict:
            _, new = ingest.grow(params["xyz"], p, q, n_rest=params["f_rest"].shape[1])
            for k in LEAVES:
                params[k] = torch.cat([params[k], new[k].to(dtype)])
                m[k] = torch.cat([m[k], torch.zeros_like(new[k], dtype=dtype)])
                v[k] = torch.cat([v[k], torch.zeros_like(new[k], dtype=dtype)])
            return new

        news = [grow(pts[:cap], cols[:cap])]
        if "cache0" in seg:
            out["mono"], flush = mono.densify(params, f, seg["cache0"], c, cell.config["mapper"], dtype,
                                              swapped=variant == "sources_swapped")
            if flush is not None:
                # in chunks of the ingest's capacity, each against the map
                # the chunks before it grew
                news += [grow(flush[0][i : i + cap], flush[1][i : i + cap]) for i in range(0, len(flush[0]), cap)]
        scaling = torch.cat([n["scaling"] for n in news])
        out["kept"] = scaling.shape[0]
        out["new_scale_norm"] = _norm(torch.exp(scaling[:, 0]))
        out["new_dc_sums"] = torch.cat([n["f_dc"] for n in news])[:, 0].double().sum(0).tolist()
    p0 = {k: params[k].clone() for k in LEAVES}
    mapper = cell.config["mapper"]
    opt = _opt(mapper)
    # the scene extent is taken over the keyframes present at the first
    # ingest, one camera: 0 (getNerfppNorm); the position lr's scale is
    # floored at 1e-6
    extent, spatial_lr_scale = 0.0, 1e-6
    bg = torch.zeros(3, device=dev)
    n = params["xyz"].shape[0]
    grad_accum = torch.zeros(n, device=dev)
    denom = torch.zeros(n, device=dev)
    half_wh = torch.tensor([0.5 * c["width"], 0.5 * c["height"]], device=dev)
    losses = []
    # the altered answer is the colouriser's in a LiDAR cell, else the
    # render's: a mapped room keeps few of a keyframe's points, often none
    lidar = "kf" in seg and cell.stream.frame(seg["kf"]).scan is not None
    fault = "half_batch" if variant == "half_batch" else ("altered" if variant == "altered" and not lidar else None)
    for j, (fid, it) in enumerate(zip(seg["fids"], seg["iterations"])):
        f = cell.stream.frame(fid)
        cam = splat.Camera(f.t_wc, c["fx"], c["fy"], c["width"], c["height"], mapper["Camera.z_near"],
                           mapper["Camera.z_far"], dev)
        loss, grads, _, (m2g, vis) = splat.render_and_grad(params, cam, t(f.image), bg,
                                                           mapper["Optimization.lambda_dssim"], dtype, fault=fault,
                                                           stats=out["stats"])
        grad_accum += torch.where(vis, torch.linalg.vector_norm(m2g * half_wh, dim=-1), 0.0)
        denom += vis.float()
        if j == 0:
            out["grad_norms"] = {k: _norm(grads[k]) for k in LEAVES}
        if variant != "state_unchanged":
            step = splat.adam(params, grads, m, v, step, splat.group_lrs(opt, it, spatial_lr_scale))
        losses.append(float(loss))
    out["change_norms"] = {k: _norm(params[k].float() - p0[k].float()) for k in LEAVES}
    out["losses"] = losses
    last = seg["iterations"][-1]
    if densify_at(cell.config, last):
        splat.densify_and_prune(params, m, v, grad_accum, denom,
                                max_grad=mapper["Optimization.densify_grad_threshold"],
                                min_opacity=mapper["Optimization.densify_min_opacity"], extent=extent,
                                percent_dense=mapper["Optimization.percent_dense"], gen=gen)
    if reset_at(cell.config, last):
        splat.reset_opacity(params, m, v)
    out["final_norms"] = {k: _norm(params[k].float()) for k in LEAVES}
    out["final_count"] = params["xyz"].shape[0]
    return out


def reference_segment(cell, seg: dict, variant: str | None = None) -> dict:
    """The segments replayed by the reference from their snapshots;
    `variant` puts a control or a planted fault in the program's place:
    "control" (the whole replay in bfloat16), "half_batch" (the loss over
    half the image's rows), "altered" (colours channel-reversed where they
    are made: the colouriser in a LiDAR cell, else the render), or
    "state_unchanged" (no Adam step), or "sources_swapped" (a monocular
    keyframe's samples take the render's depth before the tracker's)."""
    splat.no_tf32()
    dtype = torch.bfloat16 if variant == "control" else torch.float32
    gen = torch.Generator(device=cell.device).manual_seed(cell.seed)
    out = _replay(cell, seg, variant, dtype, gen)
    if "surgery" in seg:
        out["surgery"] = _replay(cell, seg["surgery"], variant, dtype, gen)
    return out


def _leaf_gap(prog: dict, ref: dict, leaves: list[str]) -> float:
    med = float(np.median([ref[k] for k in LEAVES]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves) if leaves else 0.0


def compare(seg: dict, ref: dict) -> dict:
    """The compared numbers, program (or a variant) against the reference."""
    out = {}
    losses = list(zip(seg["losses"], ref["losses"]))
    if "surgery" in ref:
        s, r = seg["surgery"], ref["surgery"]
        losses += list(zip(s["losses"], r["losses"]))
        out["surgery_count_gap"] = abs(s["final_count"] - r["final_count"]) / max(r["final_count"], 1)
        out["surgery_gap"] = max(abs(s["final_norms"][k] - r["final_norms"][k]) / max(r["final_norms"][k], 1e-30)
                                 for k in LEAVES if k != "xyz")
    out["loss_gap"] = max(abs(a - b) / abs(b) for a, b in losses)
    g_ref = ref["grad_norms"]
    med = float(np.median([g_ref[k] for k in LEAVES]))
    leaves = [k for k in LEAVES if g_ref[k] >= ROUNDOFF_SHARE * med]
    out["grad_gap"] = _leaf_gap(seg["grad_norms"], g_ref, leaves)
    out["change_gap"] = _leaf_gap(seg["change_norms"], ref["change_norms"], leaves)
    if "colourised" in ref:
        (pp, cp), (pr, cr) = seg["colourised"], ref["colourised"]
        n = min(len(cp), len(cr))
        count = abs(len(cp) - len(cr)) / max(len(cr), 1)
        out["colour_gap"] = float(np.abs(cp[:n] - cr[:n]).mean()) + count if n else 1.0
        out["point_gap"] = float(np.abs(pp[:n] - pr[:n]).max() / np.abs(pr).max()) + count if n else 1.0
    monos = [(s["mono"], r["mono"]) for s, r in ((seg, ref), (seg.get("surgery"), ref.get("surgery")))
             if r is not None and "mono" in r]
    if monos:
        out["mono_source_gap"] = max(float(np.mean(s["source"] != r["source"])) for s, r in monos)
        gaps = [0.0]
        for s, r in monos:
            same = (s["source"] == r["source"]) & (r["source"] >= 0)
            if same.any():
                d, d_ref = s["depth"][same].astype(np.float64), r["depth"][same].astype(np.float64)
                gaps.append(float(np.max(np.abs(d - d_ref) / d_ref)))
        out["mono_depth_gap"] = max(gaps)
    if "kept" in ref:
        out["kept_gap"] = abs(seg["kept"] - ref["kept"]) / max(ref["kept"], 1)
        out["scale_gap"] = abs(seg["new_scale_norm"] - ref["new_scale_norm"]) / max(ref["new_scale_norm"], 1e-30)
        scale = max(sum(abs(x) for x in ref["new_dc_sums"]), 1e-30)
        out["dc_gap"] = max(abs(a - b) for a, b in zip(seg["new_dc_sums"], ref["new_dc_sums"])) / scale
    return {k: (float(v) if math.isfinite(v) else float("inf")) for k, v in out.items()}


def segment_line(seg: dict, ref: dict) -> str:
    """The main segment as the check saw it, for a run's record: the
    keyframes and binnings of its steps, each step's loss and each leaf's
    first gradient norm, program / reference."""
    pair = lambda a, b: f"{a:.7g}/{b:.7g}"
    return (f"segment: keyframes {seg['fids']} binnings {seg['binnings']} losses "
            f"{' '.join(pair(a, b) for a, b in zip(seg['losses'], ref['losses']))} first gradient "
            f"{' '.join(f'{k} ' + pair(seg['grad_norms'][k], ref['grad_norms'][k]) for k in LEAVES)}")


def verdict(numbers: dict, limits: dict) -> tuple[bool, list[str]]:
    """Correct iff every number is finite and within its limit, and every
    limit has its number. Returns (correct, the lines to print)."""
    lines, ok = [], True
    for name in sorted(set(limits) | set(numbers)):
        val, lim = numbers.get(name), limits.get(name)
        good = val is not None and lim is not None and math.isfinite(val) and val <= lim
        ok &= good
        lines.append(f"check {name} {val!r} limit {lim!r} {'ok' if good else 'FAIL'}")
    return ok, lines
