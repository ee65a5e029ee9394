"""The port's tracer (`gsdf_slam_tpu_torch/utils/observability.py`): nested
spans with parents and self time, intervals only when recording, counters,
the current tracer of `using` and a `span` that does nothing without one;
and the spans and counters the program records where the work happens: the
step's parts inside `train_step`, the pairs each blend walks, the ingest's
and the colouriser's spans, under the names the benchmark's readers sum
(CPU)."""

from __future__ import annotations

import contextlib
from types import SimpleNamespace

import numpy as np
import pytest
from torch_port_helpers import scene_arrays

from gsdf_slam_tpu_torch.data import CameraIntrinsics, colorize_frame
from gsdf_slam_tpu_torch.engine import GaussianMapper, MapperSettings
from gsdf_slam_tpu_torch.ops import tile_blend
from gsdf_slam_tpu_torch.utils import observability as obs
from gsdf_slam_tpu_torch.utils.observability import PhaseTimer, count, span, using

H = W = 64
STEP_CHILDREN = {"render.preprocess", "render.blend", "step.loss", "step.backward", "step.stats", "step.adam",
                 "step.readback"}


@pytest.fixture
def clock(monkeypatch):
    """The tracer's clock, advanced by hand (ns)."""
    now = SimpleNamespace(ns=0)
    monkeypatch.setattr(obs, "time", SimpleNamespace(perf_counter_ns=lambda: now.ns))
    return now


def test_nesting_parents_and_self_time(clock):
    t = PhaseTimer(record=True)
    with t.phase("outer"):
        clock.ns += 10
        with t.phase("a"):
            clock.ns += 30
            with t.phase("leaf"):
                clock.ns += 5
        with t.phase("b"):
            clock.ns += 20
        clock.ns += 1
    assert t.totals["outer"] == pytest.approx(66e-9)
    assert t.self_totals["outer"] == pytest.approx(11e-9)
    assert t.self_totals["a"] == pytest.approx(30e-9) and t.totals["a"] == pytest.approx(35e-9)
    assert t.self_totals["leaf"] == t.totals["leaf"] == pytest.approx(5e-9)
    assert t.intervals == [("leaf", "a", 40, 45), ("a", "outer", 10, 45), ("b", "outer", 45, 65),
                           ("outer", None, 0, 66)]
    s = t.summary()
    assert s["outer"]["self_ms"] == pytest.approx(11e-6) and s["outer"]["total_ms"] == pytest.approx(66e-6)
    assert list(s["outer"]) == ["calls", "total_ms", "mean_ms", "self_ms"]
    # a span left by an exception still closes, and its parent's self time
    # still leaves it out
    with pytest.raises(KeyError), t.phase("outer"):
        with t.phase("a"):
            clock.ns += 7
            raise KeyError
    assert t.counts["a"] == 2 and t.self_totals["outer"] == pytest.approx(11e-9)


def test_intervals_only_when_recording(clock):
    t = PhaseTimer()
    for _ in range(3):
        with t.phase("x"), t.phase("y"):
            clock.ns += 2
    assert t.intervals == [] and t.counts == {"y": 3, "x": 3}
    assert t.totals["x"] == pytest.approx(6e-9) and t.means["x"] == pytest.approx(2e-9)
    t.record = True
    with t.phase("x"):
        clock.ns += 4
    t.record = False
    with t.phase("x"):
        clock.ns += 4
    assert t.intervals == [("x", None, 6, 10)]


def test_counters():
    t = PhaseTimer()
    t.count("pairs", 5)
    with using(t):
        count("pairs", np.int64(7))
        count("other", 1)
    count("pairs", 100)  # no tracer current: nothing
    assert t.counters == {"pairs": 12, "other": 1}
    assert all(type(v) is int for v in t.counters.values())


def test_span_does_nothing_without_a_current_tracer():
    assert isinstance(span("x"), contextlib.nullcontext)
    with span("x"):
        count("n", 1)
    a, b = PhaseTimer(), PhaseTimer()
    with using(a):
        with span("in_a"):
            with using(b), span("in_b"):
                pass
            with span("in_a_again"):
                pass
    with span("after"):
        pass
    assert set(a.counts) == {"in_a", "in_a_again"} and set(b.counts) == {"in_b"}
    assert obs._CURRENT.get() is None


def _mapper(**kw) -> GaussianMapper:
    """A CPU mapper holding one 64x64 keyframe at the origin and the test
    scene's Gaussians in front of it."""
    s = scene_arrays()
    n = int(s["alive"].sum())
    keep = s["means"][:n, 2] > 1.0
    m = GaussianMapper(settings=MapperSettings(do_inactive_geo_densify=False, **kw), device="cpu")
    image = np.random.default_rng(3).uniform(0, 1, (H, W, 3)).astype(np.float32)
    colors = np.random.default_rng(4).uniform(0, 1, (int(keep.sum()), 3)).astype(np.float32)
    m.feed_keyframe(0, np.eye(4, dtype=np.float32), image, points=s["means"][:n][keep], colors=colors,
                    intrinsics=CameraIntrinsics(fx=W / 2, fy=H / 2, cx=W / 2 - 0.5, cy=H / 2 - 0.5, width=W,
                                                height=H))
    return m


def _children(intervals, outer):
    """Names of the intervals inside `outer`'s, with their parents."""
    _, _, a, b = outer
    return [(n, p) for n, p, s, e in intervals if a <= s and e <= b and (n, p, s, e) != outer]


def test_train_step_spans_and_blend_pairs(monkeypatch):
    walked = []
    orig = tile_blend.bin_and_pack

    def spy(*a, **k):
        out = orig(*a, **k)
        walked.append(out.gid.shape[0])
        return out

    monkeypatch.setattr(tile_blend, "bin_and_pack", spy)
    m = _mapper(rebin_interval=4)
    t = m.timer
    t.record = True
    assert m.train_for_one_iteration()["count"] > 0  # the first step: an export
    assert m.last_binning == "export"
    steps = [iv for iv in t.intervals if iv[0] == "train_step"]
    assert len(steps) == 1
    inside = _children(t.intervals, steps[0])
    names = {n for n, _ in inside}
    assert STEP_CHILDREN <= names
    assert {n for n, p in inside if p == "train_step"} == STEP_CHILDREN
    assert {p for n, p in inside if n == "render.binning"} == {"render.blend"}
    # the first step's span holds train_step, once
    first = [iv for iv in t.intervals if iv[0] == "mapper.first_step"]
    assert len(first) == 1 and steps[0][1] == "mapper.first_step"
    assert len(walked) == 1 and t.counters["blend.pairs"] == walked[0] > 0

    # a cached step: the pairs of the cache, no binning
    cache = next(iter(m._bin_cache.values()))["cache"]
    t.intervals.clear()
    m.train_for_one_iteration()
    assert m.last_binning == "cached" and len(walked) == 1
    assert t.counters["blend.pairs"] == walked[0] + cache.gid.shape[0]
    names = {n for n, _, _, _ in t.intervals}
    assert "render.binning" not in names and "mapper.first_step" not in names
    assert STEP_CHILDREN | {"train_step"} <= names


def test_metric_span_names_keep_their_meaning():
    """`step.host_ms` reads "train_step", `ingest.ms_per_kf` every
    "ingest.*" but "ingest.knn": no new span takes either name, and
    train_step still holds the step to its read-back, once a step."""
    m = _mapper()
    for _ in range(3):
        m.train_for_one_iteration()
    t = m.timer
    assert t.counts["train_step"] == 3 == m.iteration
    assert {k for k in t.totals if k.startswith("ingest.")} == {"ingest.increase_pcd", "ingest.knn"}
    assert t.counts["upload.images"] == 1
    assert t.counts["step.readback"] == 3
    assert t.totals["train_step"] >= t.totals["step.readback"] + t.totals["render.blend"]

    # a second keyframe goes through increase_pcd: its dedup inside the phase
    t.record = True
    s = scene_arrays(seed=2)
    pts = s["means"][s["means"][:, 2] > 1.0]
    m.feed_keyframe(1, np.eye(4, dtype=np.float32), np.zeros((H, W, 3), np.float32), points=pts,
                    colors=np.full_like(pts, 0.5))
    parents = {n: p for n, p, _, _ in t.intervals}
    assert parents["dedup.voxel"] == parents["ingest.knn"] == "ingest.increase_pcd"
    assert parents["upload.images"] is None and parents["ingest.increase_pcd"] is None
    assert {k for k in t.totals if k.startswith("ingest.")} == {"ingest.increase_pcd", "ingest.knn"}


def test_colourise_spans_under_a_current_tracer():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-5, 5, (500, 3)).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) + 1.0
    proj = np.array([[20.0, 0, 16, 0], [0, 20.0, 16, 0], [0, 0, 1, 0]], np.float32)
    args = (rng.uniform(0, 1, (32, 32, 3)).astype(np.float32), pts, proj, np.eye(4, dtype=np.float32),
            np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32))
    plain = colorize_frame(*args, device="cpu")
    t = PhaseTimer(record=True)
    with using(t):
        fd = colorize_frame(*args, device="cpu")
    np.testing.assert_array_equal(fd.points, plain.points)
    np.testing.assert_array_equal(fd.colors, plain.colors)
    assert [n for n, _, _, _ in t.intervals] == ["colourise.kernels", "colourise.readback"]
    assert 0 < len(fd.points) < len(pts)


def test_no_timer_parameters_left():
    import inspect

    from gsdf_slam_tpu_torch.models import gaussian_model as gm

    for fn in (gm.increase_pcd, gm.GaussianModel.create_from_pcd, gm._new_point_params):
        assert "timer" not in inspect.signature(fn).parameters
    assert not hasattr(obs, "profile_trace") and not hasattr(obs, "tensor_memory_mb")
