"""Port parity: the data plane (`gsdf_slam_tpu_torch/data/`, the
colouriser, `engine/camera_undistort.py`) against the JAX package on the
JAX tests' own synthetic files, built under tmp_path.

Bars: the parsers, readers, backprojections and undistortion maps are
numpy copies, so their outputs must be equal. The colouriser is a torch op
on the CPU against the JAX package's jitted XLA op: the validity mask
exactly, and the colours of the valid points exactly (a colour is copied
from the pixel its point lands on); the world points to 1e-6 relative
(and 1e-6 absolute near zero): each coordinate is the same four-term sum
in the same order, which XLA's fused loop rounds differently by one unit
in the last place in a few percent of the coordinates.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_data import fake_kitti  # noqa: F401  (fixture)
from test_euroc import fake_euroc  # noqa: F401  (fixture)
from torch_port_helpers import write_tum_sequence

from gsdf_slam_tpu import data as jdata
from gsdf_slam_tpu.data import base_parser as jbase
from gsdf_slam_tpu.engine import camera_undistort as jund
from gsdf_slam_tpu.io import write_ply
from gsdf_slam_tpu.ops.colorize import colorize_pointcloud as j_colorize
from gsdf_slam_tpu_torch import data as tdata
from gsdf_slam_tpu_torch.data import base_parser as tbase
from gsdf_slam_tpu_torch.engine import camera_undistort as tund
from gsdf_slam_tpu_torch.ops.colorize import colorize_pointcloud

POINT_RTOL = POINT_ATOL = 1e-6


def _same(a, b):
    """Equal nested outputs: arrays, lists of paths, dataclasses, tuples."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    else:
        assert a == b


# ---- parsers and readers


@pytest.mark.parametrize("pose_type", [0, 1, 2, 3])
@pytest.mark.parametrize("with_head", [False, True])
def test_load_poses_every_format(tmp_path, pose_type, with_head):
    rng = np.random.default_rng(pose_type)
    mats = rng.normal(size=(3, 4, 4))
    if pose_type == 0:
        text = "\n".join(" ".join(repr(float(v)) for v in row) for m in mats for row in m)
    elif pose_type == 1:
        text = "\n".join(" ".join(repr(float(v)) for v in m.reshape(-1)) for m in mats)
    elif pose_type == 2:
        text = "\n".join(" ".join(repr(float(v)) for v in m[:3].reshape(-1)) for m in mats)
    else:
        text = "\n".join(
            f"{100.5 + i} {m[0, 3]} {m[1, 3]} {m[2, 3]} " + " ".join(repr(float(v)) for v in rng.normal(size=4))
            for i, m in enumerate(mats)
        )
    f = tmp_path / "poses.txt"
    f.write_text(("# header\n3\n" if with_head else "# comment\n") + text + "\n")
    _same(jbase.load_poses(f, pose_type, with_head=with_head), tbase.load_poses(f, pose_type, with_head=with_head))


def test_list_files_and_align_by_timestamp(tmp_path):
    for t in (1.0, 1.5, 2.02, 3.0):
        (tmp_path / f"{t:.2f}.png").write_bytes(b"")
    (tmp_path / "notes.png").write_bytes(b"")
    files = jbase.list_files(tmp_path, ".png")
    assert files == tbase.list_files(tmp_path, ".png")
    poses = np.random.default_rng(0).normal(size=(3, 4, 4)).astype(np.float32)
    stamps = np.array([1.01, 2.0, 2.99])
    _same(jbase.align_by_timestamp(files, poses, stamps, 0.03), tbase.align_by_timestamp(files, poses, stamps, 0.03))


def test_kitti_bin_ply_and_pcd_readers(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(257, 4)).astype(np.float32)
    pts.tofile(tmp_path / "000000.bin")
    xyz = rng.normal(size=(33, 3)).astype(np.float32)
    write_ply(tmp_path / "cloud.ply", {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
                                       "red": np.arange(33, dtype=np.uint8)})
    (tmp_path / "a.pcd").write_text(
        "# .PCD v0.7\nVERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
        "COUNT 1 1 1\nWIDTH 2\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
        "POINTS 2\nDATA ascii\n1 2 3\n4 5 6\n"
    )
    rec = np.zeros(5, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("intensity", "<f4"), ("ring", "<u2")])
    for k in ("x", "y", "z", "intensity"):
        rec[k] = rng.normal(size=5)
    header = ("# .PCD v0.7\nVERSION 0.7\nFIELDS x y z intensity ring\nSIZE 4 4 4 4 2\nTYPE F F F F U\n"
              "COUNT 1 1 1 1 1\nWIDTH 5\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS 5\nDATA binary\n")
    (tmp_path / "b.pcd").write_bytes(header.encode() + rec.tobytes())
    for name in ("000000.bin", "cloud.ply", "a.pcd", "b.pcd"):
        want = jdata.read_points(tmp_path / name)
        _same(want, tdata.read_points(tmp_path / name))
        assert len(want) in (257, 33, 2, 5)


@pytest.mark.parametrize("stride", [1, 3])
def test_backproject_depth(stride):
    rng = np.random.default_rng(stride)
    depth = rng.uniform(0.5, 4.0, (37, 53)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.3] = 0.0
    intr = jdata.CameraIntrinsics(fx=41.0, fy=39.5, cx=26.0, cy=18.5, width=53, height=37)
    tintr = tdata.CameraIntrinsics(fx=41.0, fy=39.5, cx=26.0, cy=18.5, width=53, height=37)
    _same(jdata.backproject_depth(depth, intr, stride), tdata.backproject_depth(depth, tintr, stride))


def test_intrinsics_from_yaml(tmp_path):
    f = tmp_path / "cam.yaml"
    f.write_text(
        '%YAML:1.0\nCamera.type: "KannalaBrandt8"\nCamera1.fx: 190.9\nCamera1.fy: 190.9\n'
        "Camera1.cx: 254.9\nCamera1.cy: 256.8\nCamera1.k1: 0.0034\nCamera1.k2: 0.0007\n"
        "Camera1.k3: -0.0039\nCamera1.k4: 0.0005\nCamera.width: 512\nCamera.height: 512\n"
    )
    _same(jbase.intrinsics_from_yaml(f), tbase.intrinsics_from_yaml(f))


# ---- the colouriser


def _scan(n=4000, seed=0):
    """A seeded scan around a KITTI-like rig: points in the LiDAR frame on
    every side, some behind the camera, some on the z = 0.2 and image
    borders; P of a 1226x370 camera, a rotated Tr and a LiDAR pose."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    pts[: n // 8, 0] = rng.uniform(0.1, 0.3, n // 8)  # around z = 0.2 in the camera
    proj = np.array([[707.0912, 0, 601.8873, 46.88783], [0, 707.0912, 183.1104, 0.1178601],
                     [0, 0, 1, 0.006203223]], np.float32)
    tr = np.array([[0.000427, -0.999967, -0.008084, -0.011985], [-0.007211, 0.008081, -0.999941, -0.054040],
                   [0.999974, 0.000486, -0.007207, -0.292197], [0, 0, 0, 1]], np.float32)
    lidar_pose = np.eye(4, dtype=np.float32)
    lidar_pose[:3, 3] = rng.normal(size=3)
    image = rng.uniform(0, 1, (370, 1226, 3)).astype(np.float32)
    return pts, image, proj, tr, lidar_pose


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_colorize_pointcloud_matches_jax(seed):
    args = _scan(seed=seed)
    want = jax.jit(j_colorize)(*(jnp.asarray(a) for a in args))
    got = colorize_pointcloud(*(torch.from_numpy(a) for a in args))
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert 0 < valid.sum() < len(valid)
    np.testing.assert_allclose(got.points_world.numpy(), np.asarray(want.points_world), rtol=POINT_RTOL, atol=POINT_ATOL)
    np.testing.assert_array_equal(got.colors.numpy()[valid], np.asarray(want.colors)[valid])
    # numpy inputs run on the device asked for
    got_np = colorize_pointcloud(*args, device="cpu")
    for a, b in zip(got_np, got):
        assert torch.equal(a, b)


def test_colorize_frame_compacts_like_the_jax_loader():
    pts, image, proj, tr, lidar_pose = _scan(seed=3)
    cam_pose = np.eye(4, dtype=np.float32)
    fr = tdata.colorize_frame(image, pts, proj, tr, cam_pose, lidar_pose, device="cpu")
    want = jax.jit(j_colorize)(*(jnp.asarray(a) for a in (pts, image, proj, tr, lidar_pose)))
    valid = np.asarray(want.valid)
    np.testing.assert_allclose(fr.points, np.asarray(want.points_world)[valid], rtol=POINT_RTOL, atol=POINT_ATOL)
    np.testing.assert_array_equal(fr.colors, np.asarray(want.colors)[valid])
    assert fr.image is image and fr.cam_pose is cam_pose


# ---- loaders over the same directories


def _frames_equal(want, got):
    assert got.points.dtype == np.float32 and got.colors.dtype == np.float32
    np.testing.assert_array_equal(got.cam_pose, want.cam_pose)
    np.testing.assert_array_equal(got.image, want.image)
    np.testing.assert_allclose(got.points, want.points, rtol=POINT_RTOL, atol=POINT_ATOL)
    np.testing.assert_array_equal(got.colors, want.colors)


@pytest.mark.parametrize("capacity", [16, 1])
def test_kitti_loader_frame(fake_kitti, capacity):  # noqa: F811
    j = jdata.DataLoader(fake_kitti, "kitti", cloud_capacity=capacity)
    t = tdata.DataLoader(fake_kitti, "kitti", cloud_capacity=capacity, device="cpu")
    assert len(j) == len(t) == 1
    _same(j.frames, t.frames)
    want, got = j.get_item(0), t.get_item(0)
    _frames_equal(want, got)
    assert len(got.points) == 1  # the point in front of the camera, if within the capacity


@pytest.fixture
def big_kitti(tmp_path):
    """A KITTI layout with a real calib's P2 and Tr, two frames of 5000
    seeded points and seeded images."""
    cv2 = pytest.importorskip("cv2")
    base = tmp_path / "kitti_big"
    (base / "image_2").mkdir(parents=True)
    (base / "velodyne").mkdir()
    pts, _, proj, tr, _ = _scan(n=5000, seed=4)
    fmt = lambda m: " ".join(repr(float(v)) for v in m.reshape(-1))
    (base / "calib.txt").write_text(f"P0: {fmt(proj)}\nP2: {fmt(proj)}\nTr: {fmt(tr[:3])}\n")
    (base / "poses.txt").write_text("1 0 0 0.5 0 1 0 0 0 0 1 2\n1 0 0 0.6 0 1 0 0 0 0 1 3\n")
    rng = np.random.default_rng(5)
    for i in range(2):
        cv2.imwrite(str(base / "image_2" / f"{i:06d}.png"), rng.integers(0, 256, (370, 1226, 3), dtype=np.uint8))
        np.concatenate([pts + i, np.ones((len(pts), 1), np.float32)], 1).astype(np.float32).tofile(
            base / "velodyne" / f"{i:06d}.bin")
    return base


@pytest.mark.parametrize("capacity, stride", [(1 << 17, 1), (3000, 2)])
def test_kitti_loader_big_frames(big_kitti, capacity, stride):
    j = jdata.DataLoader(big_kitti, "kitti", cloud_capacity=capacity, cloud_stride=stride)
    t = tdata.DataLoader(big_kitti, "kitti", cloud_capacity=capacity, cloud_stride=stride, device="cpu")
    for i in range(len(j)):
        want, got = j.get_item(i), t.get_item(i)
        _frames_equal(want, got)
        assert len(got.points) > 50
    np.testing.assert_array_equal(t.get_pose(1), j.get_pose(1))


def test_spires_loader_projects_through_the_poses(tmp_path):
    """Spires: PCD clouds, the generic K projection through
    inv(T_W_C) @ T_W_L."""
    cv2 = pytest.importorskip("cv2")
    base = tmp_path / "spires"
    (base / "undistorted_images" / "cam0").mkdir(parents=True)
    (base / "lidar-clouds").mkdir()
    rng = np.random.default_rng(6)
    cam = np.eye(4)
    lidar = np.eye(4)
    lidar[:3, 3] = [0.1, -0.2, 0.05]
    (base / "color_poses.txt").write_text(" ".join(repr(float(v)) for v in cam.reshape(-1)) + "\n")
    (base / "depth_poses.txt").write_text(" ".join(repr(float(v)) for v in lidar.reshape(-1)) + "\n")
    cv2.imwrite(str(base / "undistorted_images" / "cam0" / "0.png"),
                rng.integers(0, 256, (720, 1280, 3), dtype=np.uint8))
    pts = np.stack([rng.uniform(-5, 5, 800), rng.uniform(-3, 3, 800), rng.uniform(-2, 10, 800)], -1)
    body = "\n".join(" ".join(f"{v:.6f}" for v in p) for p in pts)
    (base / "lidar-clouds" / "0.pcd").write_text(
        "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\nWIDTH 800\nHEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\nPOINTS 800\nDATA ascii\n" + body + "\n")
    j = jdata.DataLoader(base, "spires")
    t = tdata.DataLoader(base, "spires", device="cpu")
    want, got = j.get_item(0), t.get_item(0)
    _frames_equal(want, got)
    assert 100 < len(got.points) < 800


def test_replica_and_tum_rgbd_loaders(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(7)
    # Replica: results/frame*.jpg, depth*.png (uint16, 6553.5 counts a metre), traj.txt
    rep = tmp_path / "replica"
    (rep / "results").mkdir(parents=True)
    poses = []
    for i in range(2):
        cv2.imwrite(str(rep / "results" / f"frame{i:06d}.jpg"), rng.integers(0, 256, (68, 120, 3), dtype=np.uint8))
        d = rng.integers(0, 30000, (68, 120)).astype(np.uint16)
        d[rng.uniform(size=d.shape) < 0.2] = 0
        cv2.imwrite(str(rep / "results" / f"depth{i:06d}.png"), d)
        m = np.eye(4)
        m[:3, 3] = rng.normal(size=3)
        poses.append(" ".join(repr(float(v)) for v in m.reshape(-1)))
    (rep / "traj.txt").write_text("\n".join(poses) + "\n")
    j = jdata.DataLoader(rep, "replica", cloud_stride=2)
    t = tdata.DataLoader(rep, "replica", cloud_stride=2, device="cpu")
    for i in range(2):
        _frames_equal(j.get_item(i), t.get_item(i))

    # TUM: rgb.txt, depth.txt, groundtruth.txt, fr1 intrinsics
    seq = write_tum_sequence(tmp_path / "tum", rng)
    j = jdata.DataLoader(seq, "tum", cloud_stride=8)
    t = tdata.DataLoader(seq, "tum", cloud_stride=8, device="cpu")
    _same(j.frames, t.frames)
    for i in range(len(j)):
        _frames_equal(j.get_item(i), t.get_item(i))


def test_euroc_stereo_loader(fake_euroc):  # noqa: F811
    pytest.importorskip("yaml")
    seq = fake_euroc
    j = jdata.DataLoader(seq, "euroc", cloud_stride=8)
    t = tdata.DataLoader(seq, "euroc", cloud_stride=8, device="cpu")
    _same(j.frames, t.frames)
    want, got = j.get_item(0), t.get_item(0)
    _frames_equal(want, got)
    assert len(got.points) > 500


# ---- undistortion


@pytest.mark.parametrize("model, dist", [
    ("pinhole", np.array([0.2624, -0.9531, -0.0054, 0.0026, 1.1633])),
    ("fisheye", np.array([0.0034, 0.0007, -0.0039, 0.0005])),
])
def test_undistort_rectifier(model, dist):
    pytest.importorskip("cv2")
    k = np.array([[80.0, 0, 63.5], [0, 80.0, 47.5], [0, 0, 1.0]])
    j = jund.UndistortRectifier(k, dist, 128, 96, model=model)
    t = tund.UndistortRectifier(k, dist, 128, 96, model=model)
    _same(j.maps, t.maps)
    _same(j.mask, t.mask)
    rng = np.random.default_rng(8)
    image = rng.uniform(0, 1, (96, 128, 3)).astype(np.float32)
    _same(j.undistort(image), t.undistort(image))
    depth = rng.uniform(1.0, 3.0, (96, 128)).astype(np.float32)
    depth[::7] = 0.0
    _same(j.backproject_depth(depth, stride=4), t.backproject_depth(depth, stride=4))
    _same(j.pyramid_masks([0.5, 0.25]), t.pyramid_masks([0.5, 0.25]))
    assert tund.model_name(2) == jund.model_name(2) == "fisheye"
