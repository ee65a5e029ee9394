"""Port parity: the mapper's host modules against the JAX package's.

se3, the Lie groups and the coordinate conversions on seeded tangents and
points; the keyframe's camera matrices; `Scene.nerfpp_norm`; the settings
of every mapper YAML in `cfg/`, field by field; PLY files written by both
packages from one model, byte for byte, and read back; the variable
parameters' fields. The port's copies of numpy code give the same floats,
so every comparison is exact.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import gsdf_slam_tpu.utils as j_utils
from gsdf_slam_tpu.engine import keyframe as j_keyframe
from gsdf_slam_tpu.engine import scene as j_scene
from gsdf_slam_tpu.engine import settings as j_settings
from gsdf_slam_tpu.engine import variable_params as j_vp
from gsdf_slam_tpu.io import ply as j_ply
from gsdf_slam_tpu_torch import utils
from gsdf_slam_tpu_torch.engine import keyframe, scene, settings, variable_params
from gsdf_slam_tpu_torch.io import ply
from gsdf_slam_tpu_torch.models import GaussianModel

CFG = Path(__file__).resolve().parent.parent / "cfg"
MAPPER_YAMLS = sorted(CFG.glob("gaussian_mapper/**/*.yaml")) + sorted(CFG.glob("*.yaml"))
# the JAX package's fixed-capacity sizing, which the port has no use for
JAX_ONLY_SETTINGS = {"presize_capacity", "presize_max_pairs", "auto_size_pairs_setting"}


def _tangents(n, dim, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    out = scale * rng.normal(size=(n, dim))
    out[0] = 0.0  # the small-angle branches
    out[1, :] = 1e-12
    return out


def _rotations(seed):
    r = [j_utils.so3_exp(w) for w in _tangents(8, 3, seed)]
    return r + [j_utils.so3_exp(np.array([np.pi - 1e-8, 0.0, 0.0]))]  # near pi


def test_se3_functions_match():
    for w in _tangents(12, 3, 0, 2.0):
        np.testing.assert_array_equal(utils.so3_exp(w), j_utils.so3_exp(w))
    for r in _rotations(1):
        np.testing.assert_array_equal(utils.so3_log(r), j_utils.so3_log(r))
        assert utils.rotation_angle(r) == j_utils.rotation_angle(r)
    for xi in _tangents(12, 6, 2):
        t = utils.se3_exp(xi)
        np.testing.assert_array_equal(t, j_utils.se3_exp(xi))
        np.testing.assert_array_equal(utils.se3_log(t), j_utils.se3_log(t))
        np.testing.assert_array_equal(utils.se3_inverse(t), j_utils.se3_inverse(t))
        np.testing.assert_allclose(utils.se3_log(t), xi, atol=1e-9)


@pytest.mark.parametrize("group, dim", [("SO3", 3), ("SE3", 6), ("RxSO3", 4), ("Sim3", 7)])
def test_lie_groups_match(group, dim):
    ours, ref = getattr(utils, group), getattr(j_utils, group)
    tan = _tangents(6, dim, 3, 0.7)
    pts = np.random.default_rng(4).normal(size=(5, 3))
    for a_t, b_t in zip(tan[:-1], tan[1:]):
        a, b, ja, jb = ours.exp(a_t), ours.exp(b_t), ref.exp(a_t), ref.exp(b_t)
        np.testing.assert_array_equal(a.matrix(), ja.matrix())
        np.testing.assert_array_equal(a.log(), ja.log())
        np.testing.assert_array_equal((a * b).matrix(), (ja * jb).matrix())
        np.testing.assert_array_equal(a.inverse().matrix(), ja.inverse().matrix())
        np.testing.assert_array_equal(a.act(pts), ja.act(pts))
        got, want = utils.interpolate(a, b, 0.3), j_utils.interpolate(ja, jb, 0.3)
        np.testing.assert_array_equal(got.matrix(), want.matrix())
        if group in ("SO3", "SE3"):
            np.testing.assert_array_equal(a.quaternion(), ja.quaternion())


def test_lie_constructors_match():
    q, t = np.array([0.3, -0.5, 0.2, 0.78]), np.array([1.0, -2.0, 0.5])
    np.testing.assert_array_equal(utils.SE3.from_quat_trans(q, t).matrix(),
                                  j_utils.SE3.from_quat_trans(q, t).matrix())
    s_ours, s_ref = utils.Sim3.from_scale_quat_trans(1.7, q, t), j_utils.Sim3.from_scale_quat_trans(1.7, q, t)
    np.testing.assert_array_equal(s_ours.matrix(), s_ref.matrix())
    np.testing.assert_array_equal(s_ours.to_se3().matrix(), s_ref.to_se3().matrix())
    np.testing.assert_array_equal(utils.SO3.from_quaternion(q).matrix(), j_utils.SO3.from_quaternion(q).matrix())


SYSTEMS = ("opencv", "opengl", "blender", "kitti_lidar")


@pytest.mark.parametrize("src", SYSTEMS)
def test_coordinates_match(src):
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(20, 3))
    poses = np.stack([utils.se3_exp(xi) for xi in rng.normal(size=(4, 6))])
    for dst in SYSTEMS:
        np.testing.assert_array_equal(utils.convert_points(pts, src, dst), j_utils.convert_points(pts, src, dst))
        np.testing.assert_array_equal(utils.convert_pose(poses[0], src, dst),
                                      j_utils.convert_pose(poses[0], src, dst))
        np.testing.assert_array_equal(utils.change_world_system(poses, src, dst),
                                      j_utils.change_world_system(poses, src, dst))


def _keyframes(pkg, n=4):
    rng = np.random.default_rng(6)
    cam = pkg.Camera(camera_id=0, fx=600.0, fy=610.0, cx=600.0, cy=340.0, width=1200, height=680)
    out = []
    for fid in range(n):
        t_cw = utils.se3_exp(0.3 * rng.normal(size=6)).astype(np.float32)
        out.append(pkg.Keyframe(fid=fid, camera=cam, t_cw=t_cw, image=np.zeros((2, 2, 3), np.float32)))
    return out


def test_keyframe_camera_matrices_match():
    for ours, ref in zip(_keyframes(keyframe), _keyframes(j_keyframe)):
        got = ours.camera_matrices(0.01, 100.0, device="cpu")
        want = ref.camera_matrices(0.01, 100.0)
        for field in ("view", "full_proj", "campos", "tanfovx", "tanfovy"):
            np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)))
        assert got.view.device.type == "cpu"
        assert ours.camera_matrices(device="cpu") is got  # kept, as the JAX package keeps it
        np.testing.assert_array_equal(ours.camera_center, ref.camera_center)
        assert (ours.camera.fovx, ours.camera.fovy) == (ref.camera.fovx, ref.camera.fovy)
        rot = ours.t_cw[:3, :3]
        np.testing.assert_array_equal(keyframe.rot_to_quat_wxyz(rot), j_keyframe.rot_to_quat_wxyz(rot))


def test_keyframe_pyramid_level_matches():
    ours, ref = _keyframes(keyframe, 1)[0], _keyframes(j_keyframe, 1)[0]
    ours.pyramid_times_of_use, ref.pyramid_times_of_use = [2, 0, 1], [2, 0, 1]
    assert [ours.current_pyramid_level() for _ in range(5)] == [ref.current_pyramid_level() for _ in range(5)]


def test_scene_nerfpp_norm_matches():
    s, js = scene.Scene(), j_scene.Scene()
    for kf, jkf in zip(_keyframes(keyframe), _keyframes(j_keyframe)):
        s.add_keyframe(kf)
        s.add_camera(kf.camera)
        js.add_keyframe(jkf)
    translate, radius = s.nerfpp_norm()
    j_translate, j_radius = js.nerfpp_norm()
    np.testing.assert_array_equal(translate, j_translate)
    assert radius == j_radius > 0


@pytest.mark.parametrize("path", MAPPER_YAMLS, ids=lambda p: str(p.relative_to(CFG)))
def test_mapper_settings_match_field_by_field(path):
    ours = dataclasses.asdict(settings.MapperSettings.from_yaml(path))
    ref = dataclasses.asdict(j_settings.MapperSettings.from_yaml(path))
    assert set(ref) - set(ours) == JAX_ONLY_SETTINGS and set(ours) <= set(ref)
    for k, v in ours.items():
        assert v == ref[k] and type(v) is type(ref[k]), k
    assert settings.parse_opencv_yaml(path) == j_settings.parse_opencv_yaml(path)


def test_settings_keep_the_densify_from_iter_quirk(tmp_path):
    p = tmp_path / "m.yaml"
    p.write_text("%YAML:1.0\nOptimization.densify_from_iter: 500\nOptimization.densify_from_iter_: 7\n")
    assert settings.MapperSettings.from_yaml(p).opt.densify_from_iter == 7
    p.write_text("%YAML:1.0\nOptimization.densify_from_iter: 500\n")
    assert settings.MapperSettings.from_yaml(p).opt.densify_from_iter == 500


def test_variable_parameters_fields_match():
    ours = [(f.name, f.type, f.default) for f in dataclasses.fields(variable_params.VariableParameters)]
    ref = [(f.name, f.type, f.default) for f in dataclasses.fields(j_vp.VariableParameters)]
    assert ours == ref


def _model(n=33, n_rest=15):
    rng = np.random.default_rng(7)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    return GaussianModel({"xyz": f(n, 3), "f_dc": f(n, 1, 3), "f_rest": f(n, n_rest, 3), "opacity": f(n, 1),
                          "scaling": f(n, 3), "rotation": f(n, 4)})


@pytest.mark.parametrize("n_rest", [15, 3, 0])
def test_ply_checkpoint_byte_equal_and_read_back(tmp_path, n_rest):
    model = _model(n_rest=n_rest)
    p = {k: t.detach().numpy() for k, t in model.params().items()}
    ply.write_ply(tmp_path / "port.ply", ply.gaussians_to_ply_dict(model))
    j_ply.write_ply(tmp_path / "jax.ply", j_ply.gaussians_to_ply_dict(
        p["xyz"], p["f_dc"], p["f_rest"], p["opacity"], p["scaling"], p["rotation"]))
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    props = ply.read_ply(tmp_path / "port.ply")
    j_props = j_ply.read_ply(tmp_path / "port.ply")
    assert list(props) == list(j_props)
    for k in props:
        np.testing.assert_array_equal(props[k], j_props[k])
    back = ply.ply_dict_to_gaussians(props, device="cpu")
    want = j_ply.ply_dict_to_gaussians(j_props)
    for k, w in zip(("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation"), want):
        got = getattr(back, k).detach().numpy()
        if n_rest == 0 and k == "f_rest":
            assert got.shape == w.shape == (33, 15, 3) and not got.any()
            continue
        np.testing.assert_array_equal(got, w)
        np.testing.assert_array_equal(got, p[k])
    assert back.count == 33 and not back.denom.any()


def test_sparse_points_ply_byte_equal(tmp_path):
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(17, 3)).astype(np.float32)
    col = rng.uniform(0, 1, (17, 3)).astype(np.float32)
    ply.write_sparse_points_ply(tmp_path / "port.ply", xyz, col)
    j_ply.write_sparse_points_ply(tmp_path / "jax.ply", xyz, col)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    props = ply.read_ply(tmp_path / "port.ply")
    assert props["red"].dtype == np.uint8


def test_read_ascii_ply_matches(tmp_path):
    p = tmp_path / "a.ply"
    p.write_text("ply\nformat ascii 1.0\nelement vertex 3\nproperty float x\nproperty float y\n"
                 "property uchar red\nend_header\n1 2 3\n4 5 6\n7 8 9\n")
    got, want = ply.read_ply(p), j_ply.read_ply(p)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
