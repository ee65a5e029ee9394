"""Port parity: the mapper's synchronous streaming loop
(`gsdf_slam_tpu_torch/engine/mapper.py`) against the JAX package's
GaussianMapper, on `tests/test_mapper.py::make_frames` data with the same
settings on both sides.

Bars: the keyframe sampling sequence, `kfs_used_times`, the iteration,
the count after every step and the binning of every step (fresh, export
or cached) equal; losses per iteration to 1e-6; parameters after the run
to 0.05 of the group's learning rate (the bars of
`tests/test_torch_train.py`); ingested points, keyframe images and masks
equal. The PLY writer is held byte for byte: both mappers save the same
state. The densify cadence takes JAX's split noise and thresholds through
a test-side wrapper around each package's `densify_and_prune`: the
thresholds sit in gaps of the JAX run's statistics, so float noise in the
port's statistics cannot move a row across them, and then the same rows
are cloned, split and pruned.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from test_mapper import FakeLoader, _mapper, make_frames
from test_torch_surgery import _gap_threshold, _jax_noise

import gsdf_slam_tpu.engine.mapper as jmapper_mod
from gsdf_slam_tpu.config import OptimizationParams as JOpt
from gsdf_slam_tpu.data import CameraIntrinsics as JIntr
from gsdf_slam_tpu.engine import GaussianMapper as JMapper
from gsdf_slam_tpu.engine import MapperSettings as JSettings
import gsdf_slam_tpu_torch.engine.mapper as tmapper_mod
from gsdf_slam_tpu_torch.config import OptimizationParams
from gsdf_slam_tpu_torch.convert import from_jax_state
from gsdf_slam_tpu_torch.data import CameraIntrinsics
from gsdf_slam_tpu_torch.engine import GaussianMapper, MapperSettings
from gsdf_slam_tpu_torch.models.optimizer import PARAM_GROUPS

LR = {"xyz": 1.6e-4, "f_dc": 2.5e-3, "f_rest": 1.25e-4, "opacity": 5e-2, "scaling": 5e-3, "rotation": 1e-3}
LOSS_ATOL = 1e-6
EXTRA_ITERS = 3


def _port(frames, opt, **kw):
    """The port's mapper over the same FakeLoader and settings as
    test_mapper._mapper's (intrinsics read from the loader)."""
    h, w = frames[0].image.shape[:2]
    intr = JIntr(fx=w / 2, fy=w / 2, cx=w / 2 - 0.5, cy=h / 2 - 0.5, width=w, height=h)
    settings = MapperSettings(opt=opt, **{"new_keyframe_times_of_use": 2, "do_inactive_geo_densify": False, **kw})
    return GaussianMapper(settings=settings, dataloader=FakeLoader(frames, intr), ingest_capacity=128, device="cpu")


def _step(m, log):
    out = m.train_for_one_iteration()
    log.append({"fid": m._last_kf.fid, "iteration": m.iteration, "count": out["count"], "loss": out["loss"]})


def _jax_params(m):
    n = int(m.state.count)
    return {k: np.asarray(v)[:n] for k, v in m.state.params().items()}


def _assert_params_close(jm, pm, rows=None):
    """Parameters to 0.05 lr (test_torch_train.py's bar), but the rotation
    of a few rows. The mapper initialises every Gaussian isotropic (its
    three 3-NN scales equal), where the rotation's gradient is zero up to
    rounding, and Adam's first step turns a rounding-sized gradient into a
    whole lr step of its sign: a row whose rounding differs between the
    packages moves the other way. So the rotation holds every row to 2 lr
    a step, the most a flipped sign can move it, and 90% of the rows to
    0.05 lr (flips hit a few percent of the rows here). `rows` (a mask) limits the check to those rows."""
    want = _jax_params(jm)
    for k in PARAM_GROUPS:
        got = getattr(pm.model, k).detach().numpy()
        assert got.shape == want[k].shape, k
        err = np.abs(got - want[k]).reshape(len(got), -1).max(1) / LR[k]
        err = err if rows is None else err[rows]
        if k == "rotation":
            assert float(err.max()) <= 2 * pm.iteration, f"{k}: {err.max():.3g} lr"
            assert (err < 0.05).mean() >= 0.9, f"{k}: {(err >= 0.05).sum()} of {len(err)} rows over 0.05 lr"
        else:
            assert float(err.max()) < 0.05, f"{k}: {err.max():.3g} lr"


def _assert_logs_equal(jlog, plog, atol=LOSS_ATOL):
    assert [(r["fid"], r["iteration"], r["count"]) for r in plog] == [
        (r["fid"], r["iteration"], r["count"]) for r in jlog]
    np.testing.assert_allclose([r["loss"] for r in plog], [r["loss"] for r in jlog], rtol=0, atol=atol)


# ---- the streaming run, its results and the PLY round trip


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    frames = make_frames()
    sparse = np.random.default_rng(9).uniform(-1, 1, (20, 3)).astype(np.float32)
    out = {}
    jm = _mapper(frames)
    jm.settings = dataclasses.replace(jm.settings, do_inactive_geo_densify=False)
    pm = _port(frames, OptimizationParams(densification_interval=0, opacity_reset_interval=0))
    for name, m in (("jax", jm), ("port", pm)):
        log = []
        for i in range(len(frames)):
            m.ingest_frame(i, m.dataloader.get_item(i))
            _step(m, log)
        m.feed_keyframe(len(frames), frames[0].cam_pose, frames[0].image, points=sparse, colors=0.5 + 0 * sparse)
        for _ in range(EXTRA_ITERS):
            _step(m, log)
        out[name] = {"mapper": m, "log": log, "dir": tmp_path_factory.mktemp(name)}
    return out


def test_stream_samples_trains_and_grows_like_jax(runs):
    jm, pm = runs["jax"]["mapper"], runs["port"]["mapper"]
    _assert_logs_equal(runs["jax"]["log"], runs["port"]["log"])
    assert pm.kfs_used_times == jm.kfs_used_times
    assert pm.iteration == jm.iteration == len(runs["port"]["log"])
    assert pm.model.count == int(jm.state.count) > 180
    assert pm.spatial_lr_scale == pytest.approx(jm.spatial_lr_scale, rel=1e-12)
    assert pm.binning_counts == {"fresh": pm.iteration}
    _assert_params_close(jm, pm)
    for fid, kf in jm.scene.keyframes.items():
        np.testing.assert_array_equal(pm.scene.keyframes[fid].t_cw, kf.t_cw)
        np.testing.assert_array_equal(pm.scene.keyframes[fid].image, kf.image)


def test_render_from_pose_matches_jax(runs):
    jm, pm = runs["jax"]["mapper"], runs["port"]["mapper"]
    pose = np.eye(4, dtype=np.float32)
    want = jm.render_from_pose(pose, 32, 32)
    got = pm.render_from_pose(pose, 32, 32)
    assert got.shape == (32, 32, 3)
    # the trained states differ within the lr bar; the images follow them
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_save_ply_is_byte_equal_on_the_same_state(runs):
    jm, pm = runs["jax"]["mapper"], runs["port"]["mapper"]
    jdir, pdir = runs["jax"]["dir"] / "same", runs["port"]["dir"] / "same"
    trained = pm.model
    pm.model = from_jax_state(_jax_params(jm), int(jm.state.count), device="cpu")
    try:
        jply, pply = jm.save_ply(jdir), pm.save_ply(pdir)
    finally:
        pm.model = trained
    assert pply.relative_to(pdir) == jply.relative_to(jdir)
    assert pply.read_bytes() == jply.read_bytes()
    assert json.loads((pdir / "cameras.json").read_text()) == json.loads((jdir / "cameras.json").read_text())
    assert (pdir / "input.ply").read_bytes() == (jdir / "input.ply").read_bytes()
    used = f"keyframe_used_times_{pm.iteration}.txt"
    assert (pdir / used).read_text() == (jdir / used).read_text()
    assert (pdir / "cfg_args").read_text().replace(str(pdir), "D") == (jdir / "cfg_args").read_text().replace(
        str(jdir), "D")


def test_load_ply_round_trip(runs):
    pm = runs["port"]["mapper"]
    ply = pm.save_ply(runs["port"]["dir"] / "trained")
    m2 = GaussianMapper(device="cpu")
    m2.load_ply(ply)
    assert m2.initial_mapped and m2.model.count == pm.model.count
    for k in PARAM_GROUPS:
        assert torch.equal(getattr(m2.model, k), getattr(pm.model, k).detach()), k
    assert m2.adam.step == 0 and float(m2.adam.m["xyz"].abs().sum()) == 0.0


# ---- ingest: undistortion, sky mask, backprojection


def _fisheye_intr(pkg_intr, model):
    dist = {"radtan": np.array([0.2624, -0.9531, -0.0054, 0.0026, 1.1633]),
            "fisheye": np.array([0.0034, 0.0007, -0.0039, 0.0005])}.get(model)
    return pkg_intr(fx=40.0, fy=40.0, cx=31.5, cy=23.5, width=64, height=48, dist=dist,
                    model="fisheye" if model == "fisheye" else "pinhole")


@pytest.mark.parametrize("case", ["plain", "radtan", "fisheye", "sky"])
def test_feed_keyframe_with_depth_ingests_like_jax(case):
    if case in ("radtan", "fisheye"):
        pytest.importorskip("cv2")
    rng = np.random.default_rng(10)
    image = rng.uniform(0, 1, (48, 64, 3)).astype(np.float32)
    depth = rng.uniform(1.0, 3.0, (48, 64)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.2] = 0.0
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.1, -0.2, 0.3]
    sky = np.zeros((48, 64), bool)
    sky[:10] = True
    sky = sky if case == "sky" else None
    jm = JMapper(settings=JSettings(do_inactive_geo_densify=False), capacity=1 << 12, max_pairs=1 << 14,
                 ingest_capacity=1 << 10, sky_mask=sky)
    pm = GaussianMapper(settings=MapperSettings(do_inactive_geo_densify=False), ingest_capacity=1 << 10,
                        sky_mask=sky, device="cpu")
    jkf = jm.feed_keyframe(0, pose, image, depth=depth, intrinsics=_fisheye_intr(JIntr, case))
    pkf = pm.feed_keyframe(0, pose, image, depth=depth, intrinsics=_fisheye_intr(CameraIntrinsics, case))
    np.testing.assert_array_equal(pkf.image, jkf.image)
    assert (pkf.mask is None) == (jkf.mask is None) == (case == "plain")
    if pkf.mask is not None:
        np.testing.assert_array_equal(pkf.mask, jkf.mask)
    np.testing.assert_array_equal(pkf.t_cw, jkf.t_cw)
    assert pm.model.count == int(jm.state.count) > 100
    np.testing.assert_array_equal(pm.model.xyz.detach().numpy(), _jax_params(jm)["xyz"])
    np.testing.assert_array_equal(pm.model.f_dc.detach().numpy(), _jax_params(jm)["f_dc"])
    assert pm.timer.counts["ingest.backproject"] == 1 and pm.timer.counts["ingest.knn"] == 1


# ---- the densify cadence


@pytest.fixture(scope="module")
def densify_runs():
    """Five iterations over two keyframes with a densify at iteration 3, on
    both packages; each densify goes through a wrapper that records (JAX)
    or takes (port) the noise key, the capacity and the thresholds."""
    frames = make_frames(n=2)
    opt = dict(densification_interval=3, densify_from_iter=1, densify_until_iter=100, opacity_reset_interval=0)
    records, out = [], {}

    real_j = jmapper_mod.densify_and_prune

    def jax_densify(state, adam, key, **kw):
        n = int(state.count)
        accum, denom = np.asarray(state.xyz_grad_accum)[:n], np.asarray(state.denom)[:n]
        grads = np.where(denom > 0, accum / np.maximum(denom, 1), 0)
        max_grad, g_gap = _gap_threshold(grads)
        big = grads >= max_grad
        scales = np.exp(np.asarray(state.scaling)[:n]).max(1)
        scale_cut, s_gap = _gap_threshold(scales[big], 0.2, 0.8)
        opac = 1 / (1 + np.exp(-np.asarray(state.opacity)[:n, 0]))
        min_op, o_gap = _gap_threshold(opac, 0.02, 0.3)
        kw = dict(kw, max_grad=max_grad, extent=scale_cut / kw["percent_dense"], min_opacity=min_op)
        sel = (int((big & (scales <= scale_cut)).sum()), int((big & (scales > scale_cut)).sum()),
               int((opac < min_op).sum()))
        records.append({"key": key, "cap": state.capacity, "n": n, "kw": kw, "gaps": (g_gap, s_gap, o_gap),
                        "sel": sel})
        return real_j(state, adam, key, **kw)

    real_t = tmapper_mod.densify_and_prune

    def port_densify(model, adam, **kw):
        rec = records[len(out["port_counts"])]
        assert model.count == rec["n"]
        kw = dict(kw, **{k: rec["kw"][k] for k in ("max_grad", "extent", "min_opacity")})
        assert kw.pop("generator") is not None
        before = {tuple(r) for r in model.xyz.detach().numpy()}
        counts = real_t(model, adam, **kw, noise=_jax_noise(rec["key"], rec["n"], rec["cap"]))
        out["port_counts"].append(counts)
        out["children"] = np.array([tuple(r) not in before for r in model.xyz.detach().numpy()])
        return counts

    mp = pytest.MonkeyPatch()
    mp.setattr(jmapper_mod, "densify_and_prune", jax_densify)
    mp.setattr(tmapper_mod, "densify_and_prune", port_densify)
    try:
        jm = _mapper(frames)
        jm.settings = dataclasses.replace(jm.settings, opt=JOpt(**opt), new_keyframe_times_of_use=4)
        pm = _port(frames, OptimizationParams(**opt), new_keyframe_times_of_use=4)
        out["port_counts"] = []
        for name, m in (("jax", jm), ("port", pm)):
            log = []
            for i in range(2):
                m.ingest_frame(i, frames[i])
            for _ in range(5):
                _step(m, log)
            out[name] = {"mapper": m, "log": log}
    finally:
        mp.undo()
    out["records"] = records
    return out


def test_densify_cadence_clones_splits_and_prunes_the_same_rows(densify_runs):
    (rec,) = densify_runs["records"]
    (counts,) = densify_runs["port_counts"]
    assert min(rec["gaps"]) > 1.01, rec["gaps"]
    assert (counts.cloned, counts.split) == rec["sel"][:2]
    assert counts.cloned > 0 and counts.split > 0 and counts.pruned > 0, counts
    jm, pm = densify_runs["jax"]["mapper"], densify_runs["port"]["mapper"]
    jlog, plog = densify_runs["jax"]["log"], densify_runs["port"]["log"]
    assert plog[3]["count"] == rec["n"] + counts.cloned + counts.split - counts.pruned
    # to 1e-6 up to the densify; after it, to the card-against-CPU bar of
    # 1e-5: the split places a child by its parent's rotation, which a
    # rounding-sized first step may have sent the other way (see
    # _assert_params_close), and computes its xyz and scaling with exp, log
    # and a rotation (1e-7 relative, tests/test_torch_surgery.py)
    _assert_logs_equal(jlog[:3], plog[:3])
    _assert_logs_equal(jlog, plog, atol=1e-5)
    np.testing.assert_array_equal(pm.model.exist_since_iter.numpy(), np.asarray(jm.state.exist_since_iter)[
        : int(jm.state.count)])
    # the split children's centres follow their parents' rotations (above)
    children = densify_runs["children"]
    assert 0 < children.sum() <= 2 * counts.split
    _assert_params_close(jm, pm, rows=~children)
    assert all(bool(torch.isfinite(p).all()) for p in pm.model.params().values())
    assert pm.timer.counts["cadence"] == 1


# ---- the cached binning's decisions


@pytest.fixture(scope="module")
def rebin_runs():
    """rebin_interval 4 over two keyframes, with an ingest in between; the
    JAX mapper on its grouped Pallas path in interpret mode, as
    tests/test_binning_cache.py runs it on the CPU, with a pair capacity at
    its autosizer's floor (16,384), so that it never changes: a change
    drops the JAX mapper's caches, and the port has no pair capacity."""
    frames = make_frames(n=2)
    h, w = frames[0].image.shape[:2]
    opt = dict(densification_interval=0, opacity_reset_interval=0, densify_until_iter=100)
    jm = JMapper(settings=JSettings(opt=JOpt(**opt), new_keyframe_times_of_use=8, rebin_interval=4),
                 dataloader=FakeLoader(frames, JIntr(fx=w / 2, fy=w / 2, cx=w / 2 - 0.5, cy=h / 2 - 0.5, width=w,
                                                     height=h)),
                 capacity=512, max_pairs=1 << 14, ingest_capacity=128, backend="pallas")
    decisions = []
    real = jm._dispatch_train_step

    def spy(*a, **k):
        rec = real(*a, **k)
        decisions.append("cached" if rec["used_cache"] else ("export" if rec["export_cache"] else "fresh"))
        return rec

    jm._dispatch_train_step = spy
    pm = _port(frames, OptimizationParams(**opt), new_keyframe_times_of_use=8, rebin_interval=4)
    out = {}
    for name, m in (("jax", jm), ("port", pm)):
        log, binning = [], []
        m.ingest_frame(0, frames[0])
        for i in range(10):
            if i == 6:
                m.ingest_frame(1, frames[1])
            _step(m, log)
            binning.append(getattr(m, "last_binning", None))
        out[name] = {"mapper": m, "log": log, "binning": binning}
    out["jax"]["binning"] = decisions
    return out


def test_cache_decisions_match_jax_at_rebin_4(rebin_runs):
    want, got = rebin_runs["jax"]["binning"], rebin_runs["port"]["binning"]
    assert got == want
    assert got.count("cached") >= 4 and got.count("export") >= 3 and "fresh" not in got
    _assert_logs_equal(rebin_runs["jax"]["log"], rebin_runs["port"]["log"])
    pm = rebin_runs["port"]["mapper"]
    assert pm.binning_counts == {"export": got.count("export"), "cached": got.count("cached")}
    assert all(e["uses"] < 3 for e in pm._bin_cache.values())


# ---- what is left for later raises


def _mapper_with(**kw):
    return GaussianMapper(settings=MapperSettings(**kw), device="cpu")


NOT_PORTED = {
    "mesh": lambda: GaussianMapper(mesh=object(), device="cpu"),
    "skyseg_onnx_path": lambda: _mapper_with(skyseg_onnx_path="skyseg.onnx"),
}


@pytest.mark.parametrize("what", list(NOT_PORTED))
def test_modes_left_for_later_raise(what):
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        NOT_PORTED[what]()


def _assert_config_reads_like_the_jax_one(name):
    """gsdf_slam_tpu_torch/cfg/<name> holds cfg/<name>'s keys."""
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    want = JSettings.from_yaml(root / "cfg" / name)
    got = MapperSettings.from_yaml(root / "gsdf_slam_tpu_torch" / "cfg" / name)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert (dataclasses.asdict(a) == dataclasses.asdict(b)) if dataclasses.is_dataclass(a) else a == b, f.name
    return got


def test_port_kitti_config_reads_like_the_jax_one():
    got = _assert_config_reads_like_the_jax_one("kitti.yaml")
    assert got.opt.densify_until_iter == 3 and got.rebin_interval_after_densify == 8


def test_port_tum_mono_config_reads_like_the_jax_one():
    got = _assert_config_reads_like_the_jax_one("tum_mono.yaml")
    assert got.do_inactive_geo_densify and got.max_depth_cached == 10 and got.stable_num_iter_existence == 1
    assert (got.large_rotation_threshold, got.large_translation_threshold) == (30.0, 1.0)
    assert got.opt.densification_interval == 100 and got.do_gaus_pyramid_training


def test_stream_entry_point_on_the_cpu(capsys):
    """`python -m gsdf_slam_tpu_torch.stream` on the CPU at 48x32: one
    step a frame, then the drain of the uses the window has left at the
    end (13 steps in all, the same count in both runs), and one JSON line
    with the host ms of every phase; with rebin 4, export and cached
    steps."""
    from gsdf_slam_tpu_torch import stream

    assert stream.main(["--frames", "4", "--res", "48x32", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["frames"] == 4 and line["iterations"] == 13 and line["gaussians"] > 0
    assert set(line["phases_ms"]) == {
        "ingest.backproject", "ingest.knn", "ingest.increase_pcd", "train_step", "dedup.voxel", "upload.images",
        "mapper.first_step", "render.preprocess", "render.blend", "render.binning", "step.loss", "step.backward",
        "step.stats", "step.adam", "step.readback",
    }
    assert line["phases_ms"]["ingest.knn"]["calls"] == 4 and line["binning"] == {"fresh": 13}
    _, steps = stream.run_stream(4, 48, 32, "cpu", rebin_interval=4)
    assert [s["binning"] for s in steps].count("cached") > 0
    assert [s["iteration"] for s in steps] == list(range(1, 14))


def test_stream_pipeline_gives_the_synchronous_steps(capsys):
    """`--pipeline 2` (the default) against `--pipeline 0`: the same
    iterations, keyframes, counts, binning and losses, and the depth in
    the JSON line."""
    from gsdf_slam_tpu_torch import stream

    lines = {}
    for depth in ("2", "0"):
        assert stream.main(["--frames", "3", "--res", "48x32", "--pipeline", depth, "--device", "cpu"]) == 0
        lines[depth] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert lines["2"]["pipeline_depth"] == 2 and lines["0"]["pipeline_depth"] == 0
    assert lines["2"]["iterations"] == lines["0"]["iterations"] > 3
    _, sync = stream.run_stream(3, 48, 32, "cpu")
    _, pipe = stream.run_stream(3, 48, 32, "cpu", pipeline=2)
    assert pipe == sync and [s["iteration"] for s in pipe] == list(range(1, len(pipe) + 1))


def test_tum_mono_demo_on_the_cpu(tmp_path, capsys):
    """gsdf_slam_tpu_torch.demo.train_tum_mono over a TUM-layout sequence
    (tests/test_torch_data.py's fixture, 10 frames): image-only keyframes
    grow the map through the inactive-geometry densify (the first flush of
    the depth cache: the prior's samples), and the results are written."""
    pytest.importorskip("cv2")
    from torch_port_helpers import write_tum_sequence

    from gsdf_slam_tpu_torch.demo import train_tum_mono

    # ten keyframes: the demo's depth cache (10 keyframes) flushes once
    seq = write_tum_sequence(tmp_path / "tum", np.random.default_rng(7), n=10)
    out = tmp_path / "out"
    assert train_tum_mono.main([str(seq), "--frame-stride", "1", "--extra-iterations", "2", "--output", str(out),
                                "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "kf 0/10: loss" in text and "points 0" in text and "wrote" in text
    ply = out / "point_cloud" / "iteration_12" / "point_cloud.ply"
    assert ply.exists() and (out / "cameras.json").exists()
    from gsdf_slam_tpu_torch.io import read_ply

    assert len(read_ply(ply)["x"]) > 1000
