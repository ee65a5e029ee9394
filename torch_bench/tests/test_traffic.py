"""The traffic's scenes against the program's numpy probes they copy, the
periodic street, the monocular stream's tracker points, and the seed's hold
on the frames (CPU)."""

from __future__ import annotations

import copy
import json

import numpy as np
import pytest
import torch

from gsdf_slam_tpu_torch.probes import synthetic_outdoor as so
from gsdf_slam_tpu_torch.probes import synthetic_room as sr
from torch_bench import harness
from torch_bench.traffic import generator, scenes

from .tiny import MONO, tiny_spec

F64 = torch.float64


@pytest.mark.parametrize("yaw,pitch", [(0.0, -0.2), (0.7, 0.1), (2.9, 0.2), (4.4, -0.3)])
def test_room_matches_probe(yaw, pitch):
    pose = sr.room_pose(yaw, pitch)
    rgb0, d0 = sr.raycast_room(pose, 64, 48)
    rgb1, d1 = scenes.raycast_room(torch.as_tensor(pose, dtype=F64), 64, 48, 32.0)
    np.testing.assert_array_equal(rgb1.numpy(), rgb0)
    np.testing.assert_allclose(d1.numpy(), d0, rtol=1e-6)


@pytest.mark.parametrize("dist,sway", [(0.0, 0.0), (3.0, 0.2), (17.5, -0.3), (33.0, 0.1)])
def test_street_matches_probe(dist, sway):
    pose = so.drive_pose(dist, sway)
    rgb0, d0 = so.raycast_outdoor(pose, 80, 32)
    rgb1, d1 = scenes.raycast_street(scenes.probe_street(), torch.as_tensor(pose, dtype=F64), 80, 32, 40.0)
    # the rays' float64 products may round apart in the last bit, and the
    # depth with them; the colours are the same
    np.testing.assert_array_equal(rgb1.numpy(), rgb0)
    np.testing.assert_allclose(d1.numpy(), d0, rtol=1e-6)


def test_scan_matches_probe():
    """The probe's scan from its own draws: the copy's rays and ranges give
    its points."""
    pose, n, seed = so.drive_pose(5.0, 0.1), 4000, 3
    want = so.lidar_scan(pose, n, seed=seed)
    rng = np.random.default_rng(seed)
    n_az = scenes.scan_azimuths(n)
    el = rng.normal(0, 1e-3, (scenes.HDL64_BEAMS, n_az))
    az = rng.uniform(0, 1, (scenes.HDL64_BEAMS, n_az))
    d_l = scenes.scan_rays(torch.as_tensor(el), torch.as_tensor(az))
    rng_t = scenes.cast_scan(scenes.probe_street(), torch.as_tensor(pose, dtype=F64), d_l)
    hits = np.flatnonzero(np.isfinite(rng_t.numpy()))
    keep = np.sort(rng.choice(hits, n, replace=False))
    got = (d_l[keep] * rng_t[keep, None]).to(torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _street():
    spec = harness.load_spec("kitti_lidar.drive")
    t = spec["traffic"]
    return scenes.periodic_street(torch.Generator().manual_seed(4), t["period_m"], t["boxes"], t["ground_y_m"]), t


def test_street_repeats_one_period_on():
    street, t = _street()
    for z in (0.0, 31.3, 77.9):
        a = scenes.raycast_street(street, scenes.drive_pose(z, 0.2), 96, 30, 55.0)
        b = scenes.raycast_street(street, scenes.drive_pose(z + t["period_m"], 0.2), 96, 30, 55.0)
        np.testing.assert_allclose(b[0].numpy(), a[0].numpy(), rtol=0, atol=1e-6)
        fin = np.isfinite(a[1].numpy())
        assert (np.isfinite(b[1].numpy()) == fin).all()
        np.testing.assert_allclose(b[1].numpy()[fin], a[1].numpy()[fin], rtol=1e-6)
        el = torch.zeros((scenes.HDL64_BEAMS, 50), dtype=F64)
        d_l = scenes.scan_rays(el, torch.full_like(el, 0.5))
        ra = scenes.cast_scan(street, scenes.drive_pose(z, 0.2), d_l)
        rb = scenes.cast_scan(street, scenes.drive_pose(z + t["period_m"], 0.2), d_l)
        np.testing.assert_allclose(rb.numpy(), ra.numpy(), rtol=1e-9)


def test_stream_repeats_one_period_on():
    spec = tiny_spec("kitti_lidar.drive")
    s = generator.make_stream(spec["config"], spec["traffic"], 9, 10**6, "cpu")
    per = s._period
    a, b = s.frame(3), s.frame(3 + 2 * per)
    assert a.image is b.image and a.scan is b.scan
    shift = b.t_wc.astype(np.float64) - a.t_wc.astype(np.float64)
    np.testing.assert_allclose(shift[2, 3], 2 * spec["traffic"]["period_m"], rtol=1e-6)
    np.testing.assert_array_equal(shift[:, :3], 0)


def test_seed_boxes_are_a_permutation():
    spec = harness.load_spec("kitti_lidar.drive")
    t = spec["traffic"]
    sizes = []
    for seed in (1, 2):
        st = scenes.periodic_street(torch.Generator().manual_seed(seed), t["period_m"], t["boxes"], t["ground_y_m"])
        ext = (st.boxes[:, 3:] - st.boxes[:, :3]).numpy()
        sizes.append(np.sort(ext, axis=0))
        assert int((st.boxes[:, 0] < 0).sum()) == t["boxes"]["count"] // 2
    np.testing.assert_allclose(sizes[0], sizes[1], rtol=1e-12)


@pytest.mark.parametrize("workload", ["kitti_lidar.drive", "replica_rgbd.room", MONO])
def test_one_seed_gives_the_same_frames(workload):
    spec = tiny_spec(workload)
    n = spec["traffic"]["warm_keyframes"] + 4
    a, b = (generator.make_stream(spec["config"], spec["traffic"], 2**31 + 5, n, "cpu") for _ in range(2))
    c = generator.make_stream(spec["config"], spec["traffic"], 2**31 + 6, n, "cpu")
    differ = False
    for k in range(n):
        fa, fb, fc = a.frame(k), b.frame(k), c.frame(k)
        for name in ("t_wc", "image", "depth", "scan", "lidar_pose", "points", "colors"):
            x, y = getattr(fa, name), getattr(fb, name)
            if x is not None:
                np.testing.assert_array_equal(x, y)
                differ |= not np.array_equal(x, getattr(fc, name))
    assert differ


def _mono_and_room_streams(seed: int = 2**31 + 3):
    """The tiny monocular stream and the same stream without the tracker."""
    spec = tiny_spec(MONO)
    plain = copy.deepcopy(spec["config"])
    del plain["sensors"]["tracker"]
    n = spec["traffic"]["warm_keyframes"] + 4
    make = lambda config: generator.make_stream(config, spec["traffic"], seed, n, "cpu")
    return make(spec["config"]), make(plain), n


def test_tracker_leaves_the_room_frames():
    """With the tracker sensor a room frame keeps its pose and image, gains
    the tracker's points and carries no depth."""
    mono, room, n = _mono_and_room_streams()
    for k in range(n):
        fm, fr = mono.frame(k), room.frame(k)
        np.testing.assert_array_equal(fm.t_wc, fr.t_wc)
        np.testing.assert_array_equal(fm.image, fr.image)
        assert fm.depth is None and fr.depth is not None
        assert fm.points.shape == fm.colors.shape == (100, 3) and fr.points is None


def test_tracker_points_lie_at_the_raycast_depth():
    """Each tracker point projects onto a pixel of its frame at that
    pixel's raycast depth, with that pixel's colour."""
    mono, room, n = _mono_and_room_streams()
    c = mono.calib
    for k in range(n):
        fm, depth = mono.frame(k), room.frame(k).depth
        t_cw = np.linalg.inv(fm.t_wc.astype(np.float64))
        p = fm.points.astype(np.float64) @ t_cw[:3, :3].T + t_cw[:3, 3]
        u = c["fx"] * p[:, 0] / p[:, 2] + c["cx"]
        v = c["fy"] * p[:, 1] / p[:, 2] + c["cy"]
        x, y = np.rint(u).astype(int), np.rint(v).astype(int)
        np.testing.assert_allclose(u, x, atol=1e-3)
        np.testing.assert_allclose(v, y, atol=1e-3)
        np.testing.assert_allclose(p[:, 2], depth[y, x], rtol=1e-5)
        np.testing.assert_array_equal(fm.colors, fm.image[y, x])
        assert len(set(zip(x, y))) == len(x)


def test_traffic_files_are_data():
    for name in ("drive", "room", "polish"):
        json.loads((harness.HERE / "traffic" / f"{name}.json").read_text())
