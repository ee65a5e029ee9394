"""Port parity: the mapper's second half (`gsdf_slam_tpu_torch/engine/
mapper.py`) against the JAX package's GaussianMapper: the monocular
inactive-geometry densify and its depth cache, tracker pose corrections
and existence pruning, checkpoints in both directions, pipelined metrics,
the live parameter channel and the keyframe image record. Frames are
`tests/test_mapper.py::make_frames`'; the JAX mapper runs with a pair
capacity of 16,384, which these scenes never reach.

Bars. The depth cache's samples from tracker points and from the prior
are bit-equal; those from the depth render agree within the render's bar
(tests/test_torch_depth.py: 5e-6 on coverage, 4 x 5e-6 x max |z| on the
depth), and a sample may be kept on one side only where the JAX coverage
lies within that bar of 0.5 or its depth within it of 0.2. Counts are
equal, the pairs before the cull to 1% (a sample lies on an integer pixel,
so its footprint can end exactly on a tile edge). Losses agree to 1e-6, with one exception that the tests detect:
the mono densify places points at exactly tied depths by construction
(every sample propagated from one tracker point has that point's depth in
its keyframe's view, and the prior is one depth for the whole view), and
XLA's fused arithmetic and PyTorch's give a view depth that differs in
the last bit for some Gaussians; tied Gaussians then blend in another
order. A step whose view the two packages' depths order differently is
held to TIE_LOSS_ATOL. To keep every other comparison at its own bar, the
mono stream hands the port the JAX state after every step, so each
keyframe's densify and each step start from the same state on both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_mapper import FakeLoader, make_frames
from test_torch_mapper import LOSS_ATOL, LR, _assert_logs_equal, _jax_params, _step

import gsdf_slam_tpu.engine.mapper as jmapper_mod
from gsdf_slam_tpu.config import OptimizationParams as JOpt
from gsdf_slam_tpu.data import CameraIntrinsics as JIntr
from gsdf_slam_tpu.engine import GaussianMapper as JMapper
from gsdf_slam_tpu.engine import MapperSettings as JSettings
from gsdf_slam_tpu_torch.config import OptimizationParams
from gsdf_slam_tpu_torch.convert import from_jax_adam, from_jax_state
from gsdf_slam_tpu_torch.data import CameraIntrinsics
from gsdf_slam_tpu_torch.engine import GaussianMapper, MapperSettings
from gsdf_slam_tpu_torch.engine.mapper import MONO_SOURCES
from gsdf_slam_tpu_torch.models.optimizer import PARAM_GROUPS
from gsdf_slam_tpu_torch.utils import so3_exp

H = W = 32
MAX_PAIRS = 1 << 14
RENDER_BAR = 5e-6  # tests/test_torch_depth.py's image bar
# a step whose view holds tied depths that the packages order differently
# (measured up to 5e-4 on these scenes)
TIE_LOSS_ATOL = 2e-3
NO_DENSIFY = dict(densification_interval=0, opacity_reset_interval=0)


def _intr(pkg_intr, h=H, w=W):
    return pkg_intr(fx=w / 2, fy=w / 2, cx=w / 2 - 0.5, cy=h / 2 - 0.5, width=w, height=h)


def _pair(opt=None, frames=None, ingest_capacity=128, seed=0, jax_kw=None, **kw):
    """A JAX and a port mapper with the same settings (`kw` on both), over
    a FakeLoader of `frames` if given."""
    opt = dict(NO_DENSIFY, **(opt or {}))
    kw = {"new_keyframe_times_of_use": 2, **kw}
    loaders = (FakeLoader(frames, _intr(JIntr)), FakeLoader(frames, _intr(JIntr))) if frames else (None, None)
    jm = JMapper(settings=JSettings(opt=JOpt(**opt), **kw), dataloader=loaders[0], capacity=512,
                 max_pairs=MAX_PAIRS, ingest_capacity=ingest_capacity, seed=seed, **(jax_kw or {}))
    pm = GaussianMapper(settings=MapperSettings(opt=OptimizationParams(**opt), **kw), dataloader=loaders[1],
                        ingest_capacity=ingest_capacity, seed=seed, device="cpu")
    return jm, pm


def _count(m):
    return int(m.state.count) if isinstance(m, JMapper) else m.model.count


def _resync(pm, jm):
    """Hand the port the JAX mapper's state (parameters, statistics and
    Adam), as a new generation."""
    n = int(jm.state.count)
    arrays = {k: np.asarray(v) for k, v in jm.state.params().items()}
    arrays.update({k: np.asarray(getattr(jm.state, k)) for k in ("max_radii2d", "xyz_grad_accum", "denom",
                                                                  "exist_since_iter")})
    gen = pm.model.generation + 1
    pm.model = from_jax_state(arrays, n, device="cpu")
    pm.model.generation = gen
    pm.adam = from_jax_adam({k: np.asarray(v) for k, v in jm.adam.m.items()},
                            {k: np.asarray(v) for k, v in jm.adam.v.items()}, int(jm.adam.step), n, device="cpu")
    pm._invalidate_binning_caches()


@jax.jit
def _jax_view_depth(xyz, v):
    return v[2, 0] * xyz[:, 0] + v[2, 1] * xyz[:, 1] + v[2, 2] * xyz[:, 2] + v[2, 3]


def _depth_orders_differ(state, kf) -> bool:
    """Do the packages order `state`'s Gaussians differently by their depth
    in keyframe `kf`'s view (the sort the binning does per tile)? The view
    matrix is the JAX one; the port builds it bit-equal."""
    n = int(state.count)
    xyz = np.asarray(state.xyz)[:n]
    v = np.asarray(kf.camera_matrices(0.01, 100.0).view)
    zj = np.asarray(_jax_view_depth(jnp.asarray(xyz), jnp.asarray(v)))
    x, vt = torch.from_numpy(xyz.copy()), torch.from_numpy(v.copy())
    zt = (vt[2, 0] * x[:, 0] + vt[2, 1] * x[:, 1] + vt[2, 2] * x[:, 2] + vt[2, 3]).numpy()
    return not np.array_equal(np.argsort(zj, kind="stable"), np.argsort(zt, kind="stable"))


class _Appends(list):
    """A list that also records what is appended to it."""

    def __init__(self, items, log):
        super().__init__(items)
        self.log = log

    def append(self, x):
        self.log.append(x)
        super().append(x)


def _mono_pose(i):
    """make_frames' camera path, turned a little more at every keyframe, so
    that no keyframe after the first sees the prior plane face on."""
    pose = np.eye(4)
    pose[0, 3] = 0.05 * i
    pose[:3, :3] = so3_exp(np.array([0.03, -0.05, 0.02]) * i)
    return pose.astype(np.float32)


def _samples_by_pixel(points, t_cw, fx, cx, cy):
    """Each cached point's sample pixel (x, y), from its projection into its
    keyframe's view."""
    t = t_cw.astype(np.float64)
    pc = points.astype(np.float64) @ t[:3, :3].T + t[:3, 3]
    gx = np.rint(fx * pc[:, 0] / pc[:, 2] + cx).astype(int)
    gy = np.rint(fx * pc[:, 1] / pc[:, 2] + cy).astype(int)
    return {(x, y): i for i, (x, y) in enumerate(zip(gx, gy))}, pc[:, 2]


def _assert_cache_entries_match(jpts, ppts, psrc, kf, renders):
    """One keyframe's depth cache entries: the JAX points `jpts`, the port's
    `ppts` with their sources `psrc`; `renders` the JAX mapper's depth
    render of that keyframe (depth, coverage, max |z| of the Gaussians) or
    None."""
    fx, cx, cy = kf.camera.fx, kf.camera.cx, kf.camera.cy
    jkeys, _ = _samples_by_pixel(jpts, kf.t_cw, fx, cx, cy)
    pkeys, _ = _samples_by_pixel(ppts, kf.t_cw, fx, cx, cy)
    assert len(jkeys) == len(jpts) and len(pkeys) == len(ppts)
    render = MONO_SOURCES.index("render")
    for key, i in pkeys.items():
        if psrc[i] != render:  # tracker points and the prior: bit-equal
            assert key in jkeys, key
            np.testing.assert_array_equal(ppts[i], jpts[jkeys[key]])
    if renders is None:
        assert not (psrc == render).any()
        assert set(pkeys) == set(jkeys)
        return
    dep, cov, z_max = renders
    depth_bar = 4 * RENDER_BAR * z_max
    ray = np.sqrt(1 + ((np.arange(W) - cx) / fx).max() ** 2 + ((np.arange(H) - cy) / fx).max() ** 2)
    for key in set(pkeys) | set(jkeys):
        if key in pkeys and key in jkeys:
            np.testing.assert_allclose(ppts[pkeys[key]], jpts[jkeys[key]], atol=depth_bar * ray + 1e-6, rtol=0)
        else:  # kept on one side only: at the render's selection frontier
            x, y = key
            assert abs(cov[y, x] - 0.5) <= RENDER_BAR or abs(dep[y, x] - 0.2) <= depth_bar, (key, cov[y, x])


MONO_CASES = {
    # tracker points (make_frames' wall points) within 3 pixels, the map's
    # render elsewhere; max_depth_cached 1 and 2; chunks of 48 rows
    "tracker-cache1": dict(points=True, max_depth_cached=1),
    "tracker-cache2": dict(points=True, max_depth_cached=2),
    # image only: the prior, then the render
    "image-cache1": dict(points=False, max_depth_cached=1),
    "image-cache2": dict(points=False, max_depth_cached=2),
}
MONO_KEYFRAMES, MONO_STEPS = 5, 2


@pytest.fixture(scope="module", params=list(MONO_CASES))
def mono_run(request):
    case = MONO_CASES[request.param]
    frames = make_frames(n=MONO_KEYFRAMES)
    jm, pm = _pair(ingest_capacity=48, max_depth_cached=case["max_depth_cached"],
                   inactive_geo_densify_max_pixel_dist=3.0)
    renders = []
    real_render = jmapper_mod.render_depth_state

    def spy_render(state, cam, cfg):
        out = real_render(state, cam, cfg)
        n, v = int(state.count), np.asarray(cam.view)
        z_max = float(np.abs(np.asarray(state.xyz)[:n] @ v[2, :3] + v[2, 3]).max())
        renders.append((*(np.asarray(x) for x in out), z_max))
        return out

    flushes = {"jax": [], "port": []}
    for name, m in (("jax", jm), ("port", pm)):
        real = m._ingest_points
        m._ingest_points = lambda p, c, real=real, log=flushes[name]: (log.append(len(p)), real(p, c))[1]
    mp = pytest.MonkeyPatch()
    mp.setattr(jmapper_mod, "render_depth_state", spy_render)
    out = {"keyframes": [], "steps": [], "flushes": flushes, "pm": pm, "jm": jm}
    try:
        for i, f in enumerate(frames):
            entries = {"jax": [], "port": []}
            jm.depth_cache_points = _Appends(jm.depth_cache_points, entries["jax"])
            pm.depth_cache_points = _Appends(pm.depth_cache_points, entries["port"])
            n_renders = len(renders)
            kw = dict(points=f.points, colors=f.colors) if case["points"] else {}
            jm.feed_keyframe(i, _mono_pose(i), f.image, intrinsics=_intr(JIntr), **kw)
            pm.feed_keyframe(i, _mono_pose(i), f.image, intrinsics=_intr(CameraIntrinsics), **kw)
            src = pm.last_mono_samples["source"]
            entries["sources"] = [src[src >= 0]]  # the cached samples' sources, in their order
            out["keyframes"].append({
                "kf": jm.scene.keyframes[i], "entries": entries, "counts": (_count(jm), _count(pm)),
                "render": renders[n_renders] if len(renders) > n_renders else None,
                "renders": len(renders) - n_renders,
            })
            _resync(pm, jm)
            for _ in range(MONO_STEPS):
                pre = jm.state
                jo, po = jm.train_for_one_iteration(), pm.train_for_one_iteration()
                assert jm._last_kf.fid == pm._last_kf.fid
                out["steps"].append({"jax": jo, "port": po, "tied": _depth_orders_differ(pre, jm._last_kf)})
                _resync(pm, jm)
    finally:
        mp.undo()
    out["case"] = case
    return out


def test_mono_stream_densifies_like_jax(mono_run):
    case = mono_run["case"]
    for k in mono_run["keyframes"]:
        assert k["counts"][0] == k["counts"][1]
        ent = k["entries"]
        assert len(ent["jax"]) == len(ent["port"]) == len(ent["sources"]) == 1
        assert k["renders"] <= 1
        _assert_cache_entries_match(ent["jax"][0], ent["port"][0], ent["sources"][0], k["kf"], k["render"])
    # the depth cache's cadence and its chunks of 48 rows
    flushes = mono_run["flushes"]
    assert flushes["jax"] == flushes["port"]
    assert len(flushes["port"]) == MONO_KEYFRAMES // case["max_depth_cached"]
    assert max(flushes["port"]) > 48
    assert mono_run["pm"].depth_cached == mono_run["jm"].depth_cached == MONO_KEYFRAMES % case["max_depth_cached"]
    pm = mono_run["pm"]
    sources = set(pm.mono_sources)
    assert "render" in sources and ("tracker" in sources) == case["points"] and ("prior" in sources) != case["points"]
    assert pm.timer.counts["mono.depth_render"] == sum(k["renders"] for k in mono_run["keyframes"]) > 0
    assert pm.timer.counts.get("mono.nearest", 0) == (MONO_KEYFRAMES if case["points"] else 0)


def test_mono_stream_trains_like_jax(mono_run):
    steps = mono_run["steps"]
    assert len(steps) == MONO_KEYFRAMES * MONO_STEPS
    for s in steps:
        j, p = s["jax"], s["port"]
        assert j["count"] == p["count"]
        # pairs before the cull: a sample sits on an integer pixel, so its
        # rect can end exactly on a tile edge, which the last bit decides
        assert abs(j["total_pairs"] - p["total_pairs"]) <= 0.01 * j["total_pairs"]
        assert abs(j["loss"] - p["loss"]) <= (TIE_LOSS_ATOL if s["tied"] else LOSS_ATOL), s
    # the tied views are the exception: most steps hold the strict bar
    assert sum(not s["tied"] for s in steps) >= len(steps) // 3


def test_default_settings_mono_keyframe_grows_the_map():
    """feed_keyframe with an image and nothing else, at the default
    settings (do_inactive_geo_densify on, max_depth_cached 1): the prior's
    samples become the first Gaussians, and the next keyframe's come from
    the map's depth render, as in the JAX package."""
    rng = np.random.default_rng(0)
    jm, pm = _pair()
    for m, intr in ((jm, JIntr), (pm, CameraIntrinsics)):
        assert m.settings.do_inactive_geo_densify and m.settings.max_depth_cached == 1
        for i in range(3):
            m.feed_keyframe(i, _mono_pose(i), rng.uniform(0.1, 0.9, (H, W, 3)).astype(np.float32),
                            intrinsics=_intr(intr))
            m.train_for_one_iteration()
        rng = np.random.default_rng(0)
    assert _count(pm) == _count(jm) > 64
    assert pm.mono_sources["prior"] == 64 and pm.mono_sources["render"] > 0


# ---- tracker pose corrections


@pytest.fixture(scope="module")
def pose_runs():
    """tests/test_slam_modes.py::test_existence_pruning_on_large_pose_update
    on both packages, with rebin_interval 4 and the JAX mapper on its
    grouped Pallas path in interpret mode (its cached binning needs it):
    eight steps on keyframe 0, then keyframe 1 and two steps, a small
    correction of keyframe 1 and four steps (on it too), then a large one
    at iteration 14, where stable_num_iter_existence 7 makes keyframe 1's
    Gaussians (from iteration 8) the young ones."""
    frames = make_frames(n=2)
    jm, pm = _pair(frames=frames, jax_kw={"backend": "pallas"}, new_keyframe_times_of_use=8, rebin_interval=4,
                   stable_num_iter_existence=7, large_rotation_threshold=10.0, large_translation_threshold=1.0)
    decisions = []
    real = jm._dispatch_train_step

    def spy(*a, **k):
        rec = real(*a, **k)
        decisions.append("cached" if rec["used_cache"] else ("export" if rec["export_cache"] else "fresh"))
        return rec

    jm._dispatch_train_step = spy
    out = {}
    t_wc_small = frames[1].cam_pose.copy()
    t_wc_small[0, 3] += 0.01
    th = np.deg2rad(25.0)
    rot = np.eye(4)
    rot[:3, :3] = [[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]]
    t_wc_large = (rot @ t_wc_small.astype(np.float64)).astype(np.float32)
    for name, m in (("jax", jm), ("port", pm)):
        log, rec, binning = [], {}, []

        def steps(n):
            for _ in range(n):
                _step(m, log)
                binning.append(getattr(m, "last_binning", None))

        m.ingest_frame(0, frames[0])
        steps(8)
        m.ingest_frame(1, frames[1])
        rec["n1"] = _count(m)
        steps(2)
        rec["caches_before"] = sorted(m._bin_cache)
        m.update_keyframe_pose(1, t_wc_small)
        rec["caches_after_small"] = sorted(m._bin_cache)
        rec["after_small"] = _count(m)
        steps(4)
        rec["before_large"], rec["large_at"] = _count(m), m.iteration
        rec["exist_before"] = np.asarray(m.state.exist_since_iter if name == "jax" else m.model.exist_since_iter)[
            : rec["before_large"]].copy()
        m.update_keyframe_pose(1, t_wc_large)
        rec["after_large"] = _count(m)
        rec["caches_after_large"] = sorted(m._bin_cache)
        steps(2)
        rec["log"], rec["binning"] = log, binning
        out[name] = rec
    out["jax"]["binning"] = decisions
    out["jm"], out["pm"] = jm, pm
    return out


def test_small_correction_prunes_nothing_and_drops_only_its_caches(pose_runs):
    j, p = pose_runs["jax"], pose_runs["port"]
    assert p["after_small"] == p["n1"] == j["after_small"]
    assert p["caches_before"] == j["caches_before"] and {k[0] for k in p["caches_before"]} == {0, 1}
    assert p["caches_after_small"] == j["caches_after_small"] == [k for k in p["caches_before"] if k[0] != 1]
    # the cache decisions, the steps on the corrected keyframe included
    assert p["binning"] == j["binning"] and p["binning"].count("cached") >= 4
    assert 1 in [r["fid"] for r in p["log"][10:14]]
    _assert_logs_equal(j["log"], p["log"])


def test_large_correction_prunes_the_young_like_jax(pose_runs):
    j, p = pose_runs["jax"], pose_runs["port"]
    assert p["before_large"] == j["before_large"] > p["after_large"] == j["after_large"] > 0
    assert p["caches_after_large"] == j["caches_after_large"] == []
    # survivors row for row: the stable rows, in their order
    pm, jm = pose_runs["pm"], pose_runs["jm"]
    stable = 7
    keep = p["exist_before"] <= p["large_at"] - stable
    assert keep.sum() == p["after_large"] and not keep.all()
    np.testing.assert_array_equal(p["exist_before"], j["exist_before"])
    np.testing.assert_array_equal(pm.model.exist_since_iter.numpy(),
                                  np.asarray(jm.state.exist_since_iter)[: j["after_large"]])
    np.testing.assert_array_equal(pm.model.exist_since_iter.numpy(), p["exist_before"][keep])
    # the survivors' rows: every group to 0.05 lr but the rotation, whose
    # rounding-sized first steps (_assert_params_close) have had 14 steps
    # to compound here; it is held to the 2 lr a step a flip can move it
    want = _jax_params(jm)
    for k in PARAM_GROUPS:
        err = np.abs(getattr(pm.model, k).detach().numpy() - want[k]).max() / LR[k]
        assert err <= (2 * pm.iteration if k == "rotation" else 0.05), (k, err)


def test_pose_correction_moves_the_camera_it_trains_through():
    """A corrected keyframe's next step renders from the new pose: its
    cached camera matrices are dropped with the correction."""
    frames = make_frames(n=1)
    _, pm = _pair(frames=frames, do_inactive_geo_densify=False)
    pm.ingest_frame(0, frames[0])
    kf = pm.scene.keyframes[0]
    before = kf.camera_matrices(device="cpu").view.clone()
    moved = frames[0].cam_pose.copy()
    moved[1, 3] += 0.3
    pm.update_keyframe_pose(0, moved)
    assert kf._cam_matrices is None
    after = kf.camera_matrices(device="cpu").view
    np.testing.assert_allclose(after.numpy()[1, 3] - before.numpy()[1, 3], -0.3, atol=1e-6)
    pm.update_keyframe_pose(99, moved)  # an unknown keyframe is ignored


# ---- checkpoints


def _trained_pair(frames, steps=3, **kw):
    jm, pm = _pair(frames=frames, do_inactive_geo_densify=False, **kw)
    for m in (jm, pm):
        for i in range(len(frames)):
            m.ingest_frame(i, frames[i])
        for _ in range(steps):
            m.train_for_one_iteration()
    return jm, pm


def _next_losses(m, n=3):
    return [m.train_for_one_iteration()["loss"] for _ in range(n)]


@pytest.mark.parametrize("direction", ["port-to-port", "jax-to-port", "port-to-jax"])
def test_checkpoint_resumes_in_either_package(tmp_path, direction):
    """A save, and a load into a mapper that has seen the same frames and
    steps (so it samples the same keyframes next): the next steps of the
    saving and the loading mapper agree, bit for bit port to port and to
    1e-6 across the packages."""
    frames = make_frames(n=2)
    jm, pm = _trained_pair(frames)
    jm2, pm2 = _trained_pair(frames)
    ckpt = tmp_path / "ck.npz"
    src, dst = {"port-to-port": (pm, pm2), "jax-to-port": (jm, pm2), "port-to-jax": (pm, jm2)}[direction]
    # a state that the load must replace
    pm2.model.xyz.data += 0.1
    jm2.state = jm2.state.replace(xyz=jm2.state.xyz + 0.1)
    src.save_checkpoint(ckpt)
    z = np.load(ckpt)
    n = _count(src)
    assert int(z["state.count"]) == n and z["state.xyz"].shape[0] == (n if src is pm else 512)
    assert ("max_pairs" in z.files) == (src is jm)
    gen = pm2.model.generation
    dst.load_checkpoint(ckpt)
    assert dst.iteration == src.iteration and _count(dst) == n
    assert not dst._bin_cache
    if dst is pm2:
        assert pm2.model.generation == gen + 1 and pm2.adam.step == src.iteration
        want = _jax_params(jm) if src is jm else {k: getattr(pm.model, k).detach().numpy() for k in PARAM_GROUPS}
        for k in PARAM_GROUPS:
            np.testing.assert_array_equal(getattr(pm2.model, k).detach().numpy(), want[k])
            np.testing.assert_array_equal(pm2.adam.m[k].numpy(), np.asarray(src.adam.m[k])[:n])
        np.testing.assert_array_equal(pm2.model.exist_since_iter.numpy(),
                                      np.asarray((jm.state if src is jm else pm.model).exist_since_iter)[:n])
    got, want = _next_losses(dst), _next_losses(src)
    if direction == "port-to-port":
        assert got == want
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ATOL)


# ---- pipelined metrics


def _pipe_run(depth, n_iters=10, package="port", **kw):
    """tests/test_pipeline.py::_run: three frames, four uses each, seed 7."""
    frames = make_frames(n=3)
    jm, pm = _pair(frames=frames, seed=7, do_inactive_geo_densify=False, new_keyframe_times_of_use=4,
                   metrics_pipeline_depth=depth, **kw)
    m = pm if package == "port" else jm
    m.step_log = []
    for i, f in enumerate(frames):
        m.ingest_frame(i, f)
    outs = [m.train_for_one_iteration() for _ in range(n_iters)]
    m.flush_metrics()
    return m, outs


def test_pipelined_losses_are_bit_equal_to_synchronous():
    sync, sync_outs = _pipe_run(0)
    pipe, outs = _pipe_run(2)
    assert [r["loss"] for r in pipe.step_log] == [r["loss"] for r in sync.step_log] == [o["loss"] for o in sync_outs]
    assert [(r["iteration"], r["fid"], r["count"]) for r in pipe.step_log] == [
        (r["iteration"], r["fid"], r["count"]) for r in sync.step_log]
    assert pipe.ema_loss == sync.ema_loss
    for k in PARAM_GROUPS:
        assert torch.equal(getattr(pipe.model, k), getattr(sync.model, k)), k
    # two steps in flight: a placeholder, then the lagged metrics
    assert outs[0]["pending"] and outs[1]["pending"] and outs[2] == sync_outs[0] and outs[-1] == sync_outs[-3]


def test_pipelined_returns_follow_jax():
    """The JAX mapper's pipelined run returns the same sequence of dicts,
    placeholder included."""
    _, pouts = _pipe_run(2, package="port")
    _, jouts = _pipe_run(2, package="jax")
    assert len(pouts) == len(jouts)
    for p, j in zip(pouts, jouts):
        assert p.keys() == j.keys() and p.get("pending") == j.get("pending")
        assert (p["count"], p["total_pairs"]) == (j["count"], j["total_pairs"])
        if not p.get("pending"):
            assert abs(p["loss"] - j["loss"]) <= LOSS_ATOL


def test_pipelined_flush_on_window_drain():
    """tests/test_pipeline.py::test_flush_on_window_drain on the port."""
    frames = make_frames(n=2)
    _, m = _pair(frames=frames, do_inactive_geo_densify=False, new_keyframe_times_of_use=4, metrics_pipeline_depth=2)
    assert m.train_for_one_iteration() is None  # nothing ingested yet
    m.ingest_frame(0, frames[0])
    m.ingest_frame(1, frames[1])
    for _ in range(2 * 4 + 2):  # crosses the refill boundary
        assert m.train_for_one_iteration() is not None
    assert len(m._pending) == 2
    m.flush_metrics()
    assert not m._pending and np.isfinite(m.ema_loss) and m.ema_loss != 0.0
    m.scene.keyframes.clear()  # no keyframe: the steps in flight resolve
    m.ingest_frame(2, frames[0])
    m.train_for_one_iteration()
    m.scene.keyframes.clear()
    assert m._pending and m.train_for_one_iteration() is None and not m._pending


def test_pipelined_cadence_and_saves_flush(tmp_path):
    """tests/test_pipeline.py::test_cadence_flushes_pipeline and
    test_save_paths_flush on the port: the surgery, pose corrections,
    checkpoints and the PLY save and load run on a resolved pipeline; an
    ingest does not resolve."""
    frames = make_frames(n=3)
    opt = dict(densification_interval=3, densify_from_iter=1, densify_until_iter=8)
    _, m = _pair(opt=opt, frames=frames, do_inactive_geo_densify=False, new_keyframe_times_of_use=4,
                 metrics_pipeline_depth=2)
    for i in range(2):
        m.ingest_frame(i, frames[i])
    for _ in range(7):
        assert m.train_for_one_iteration() is not None
        if m._cadence_due(m.iteration):
            assert not m._pending  # resolved before the surgery
    assert m.timer.counts["cadence"] == 2
    m.train_for_one_iteration()
    assert m._pending
    m.ingest_frame(2, frames[2])
    assert m._pending
    for action in (lambda: m.update_keyframe_pose(0, frames[0].cam_pose), lambda: m.save_checkpoint(tmp_path / "c"),
                   lambda: m.load_checkpoint(tmp_path / "c.npz"), lambda: m.save_ply(tmp_path),
                   lambda: m.load_ply(next(tmp_path.glob("point_cloud/*/point_cloud.ply")))):
        m.train_for_one_iteration()
        assert m._pending
        action()
        assert not m._pending


# ---- the live parameter channel and the keyframe record


def test_variable_parameters_follow_jax():
    jm, pm = _pair()
    assert dataclasses.asdict(pm.get_variable_parameters()) == dataclasses.asdict(jm.get_variable_parameters())
    for m in (jm, pm):
        p = m.get_variable_parameters()
        p.feature_lr, p.densify_interval, p.lambda_dssim, p.stable_num_iter_existence = 0.9, 77, 0.4, 3
        p.do_inactive_geo_densify = False
        m.set_variable_parameters(p)
    assert dataclasses.asdict(pm.get_variable_parameters()) == dataclasses.asdict(jm.get_variable_parameters())
    assert pm.settings.opt.feature_lr == 0.9 and pm.settings.opt.densification_interval == 77
    assert pm.settings.stable_num_iter_existence == 3 and not pm.settings.do_inactive_geo_densify
    assert not pm._stopped


def test_variable_parameters_reach_the_next_step_and_stop_the_run():
    frames = make_frames(n=3)
    _, pm = _pair(frames=frames, do_inactive_geo_densify=False)
    _, ref = _pair(frames=frames, do_inactive_geo_densify=False)
    for m in (pm, ref):
        m.ingest_frame(0, frames[0])
        m.train_for_one_iteration()
    p = pm.get_variable_parameters()
    p.feature_lr = 0.0
    pm.set_variable_parameters(p)
    dc = pm.model.f_dc.detach().clone()
    pm.train_for_one_iteration()
    ref.train_for_one_iteration()
    assert torch.equal(pm.model.f_dc, dc) and not torch.equal(ref.model.f_dc, dc)
    p.keep_training = False
    pm.set_variable_parameters(p)
    assert pm._stopped and not pm.get_variable_parameters().keep_training
    pm.run()  # stops before its first frame
    assert pm.iteration == 2


def test_keyframe_record_writes_what_jax_writes(tmp_path):
    cv2 = pytest.importorskip("cv2")
    frames = make_frames(n=2)
    jm, pm = _pair(frames=frames, do_inactive_geo_densify=False, keyframe_record_interval=2)
    for name, m in (("jax", jm), ("port", pm)):
        m.result_dir = tmp_path / name
        for i in range(2):
            m.ingest_frame(i, frames[i])
        for _ in range(4):
            m.train_for_one_iteration()
    names = sorted(p.name for p in (tmp_path / "port" / "record").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax" / "record").iterdir())
    assert len(names) == 4 and names[0].startswith("iter2_kf")
    for nm in names:
        got = cv2.imread(str(tmp_path / "port" / "record" / nm)).astype(int)
        want = cv2.imread(str(tmp_path / "jax" / "record" / nm)).astype(int)
        assert got.shape == (H, W, 3)
        assert np.abs(got - want).max() <= 1, nm
        if nm.endswith("_gt.png"):
            np.testing.assert_array_equal(got, want)


# ---- the short mono stream of chip_smoke.py phase 10 (probes/mono.py)


def test_short_mono_run_at_both_pipeline_depths():
    """probes/mono.py's short stream (cfg/tum_mono.yaml's settings at 64x64,
    depth cache 2, rebin 4, one small and one large correction) on the CPU
    at pipeline depths 0 and 2: the same samples, counts and step log, bit
    for bit; the small correction prunes nothing and drops only its
    keyframe's caches; the large one prunes the young."""
    from gsdf_slam_tpu_torch.probes import checks, mono

    frames = mono.make_sequence(mono.SHORT["frames"], mono.SHORT["size"], mono.SHORT["size"])
    runs = [mono.short_mono_run("cpu", depth, frames=frames) for depth in (0, 2)]
    a, b = runs
    assert a["log"] == b["log"] and len(a["log"]) == mono.SHORT["frames"] * mono.SHORT["steps"]
    assert a["counts"] == b["counts"]
    for sa, sb in zip(a["samples"], b["samples"]):
        res = checks.mono_samples_check(sa, sb)
        assert res["ok"] and res["frontier"] == 0 and res["depth_err"] == 0.0, res
    fid = a["small_fid"]
    assert a["caches_before"] and any(k[0] == fid for k in a["caches_before"])
    assert a["caches_after"] == [k for k in a["caches_before"] if k[0] != fid] and a["small_pruned"] == 0
    n0, n1 = a["large"]
    assert n1 < n0 and a["stable"]
    sources = a["mapper"].mono_sources
    assert sources["tracker"] > 0 and sources["render"] > 0
    assert {r["binning"] for r in a["log"]} == {"export", "cached"}


def test_image_only_runs_grow_the_map_at_both_depth_caches():
    """probes/mono.py::image_only_run on the CPU (chip_smoke.py 10d runs it
    on the card): at the default settings every keyframe grows the map; at
    cfg/tum_mono.yaml's depth cache of 10 the first nine steps train an
    empty map (finite losses), and the tenth keyframe's flush holds ten
    keyframes of the prior's samples."""
    from gsdf_slam_tpu_torch.engine import MapperSettings
    from gsdf_slam_tpu_torch.probes import mono

    frames = mono.make_sequence(11, 48, 32)
    default = mono.image_only_run("cpu", MapperSettings(), frames)
    assert default["counts"][0] == 8 * 12 and default["counts"][-1] > default["counts"][0]  # 48x32, stride 4
    cached = mono.image_only_run("cpu", mono.mono_settings(), frames)
    assert cached["counts"][:9] == [0] * 9 and cached["counts"][9] > 0
    assert all(np.isfinite(r["loss"]) for r in cached["log"]) and len(cached["log"]) == 11
    assert cached["mapper"].mono_sources["prior"] == 10 * 8 * 12  # the eleventh reads the render
