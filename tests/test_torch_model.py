"""Port parity: Adam, the lr schedule, densification stats, model creation
and carrying state across from the JAX package."""

import ctypes
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsdf_slam_tpu.config import OptimizationParams as JOpt
from gsdf_slam_tpu.models import AdamState as JAdam
from gsdf_slam_tpu.models import adam_step as j_adam_step
from gsdf_slam_tpu.models import create_from_pcd as j_create
from gsdf_slam_tpu.models import optimizer as j_optimizer
from gsdf_slam_tpu.models.gaussian_model import add_densification_stats as j_stats
from gsdf_slam_tpu.models.optimizer import expon_lr as j_expon_lr
from gsdf_slam_tpu.models.optimizer import group_lrs as j_group_lrs
from gsdf_slam_tpu_torch import kernels
from gsdf_slam_tpu_torch.config import OptimizationParams
from gsdf_slam_tpu_torch.convert import from_jax_adam, from_jax_state, to_numpy_state
from gsdf_slam_tpu_torch.models import AdamState, GaussianModel, adam_step, expon_lr, group_lrs
from gsdf_slam_tpu_torch.models import optimizer
from gsdf_slam_tpu_torch.models.optimizer import PARAM_GROUPS, bias_corrections

SHAPES = {"xyz": (11, 3), "f_dc": (11, 1, 3), "f_rest": (11, 15, 3), "opacity": (11, 1),
          "scaling": (11, 3), "rotation": (11, 4)}


def test_adam_matches_jax_over_steps():
    """Five steps with per-group lrs given as host float32 numbers, as
    train_step gives them: parameters and moments to 1e-7 (same op order,
    float32 throughout)."""
    rng = np.random.default_rng(3)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    lr = {k: np.float32(v) for k, v in zip(PARAM_GROUPS, (1e-3, 2.5e-3, 1.25e-4, 5e-2, 5e-3, 1e-3))}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = JAdam.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = AdamState.init(tp)
    for _ in range(5):
        g = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
        jp, js = j_adam_step(jp, {k: jnp.asarray(v) for k, v in g.items()}, js,
                             {k: jnp.float32(v) for k, v in lr.items()})
        adam_step(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts, lr)
    assert ts.step == int(js.step) == 5
    for k in PARAM_GROUPS:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-7, rtol=0)
        np.testing.assert_allclose(ts.m[k].numpy(), np.asarray(js.m[k]), atol=1e-7, rtol=0)
        np.testing.assert_allclose(ts.v[k].numpy(), np.asarray(js.v[k]), atol=1e-7, rtol=0)


@pytest.mark.parametrize("iteration", [0, 1, 777, 29_999, 40_000])
def test_group_lrs_match(iteration):
    want = j_group_lrs(JOpt(), 2.5, jnp.int32(iteration))
    got = group_lrs(OptimizationParams(), 2.5, iteration)
    for k in PARAM_GROUPS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)
    d = dict(lr_delay_steps=100, lr_delay_mult=0.01, max_steps=1000)
    np.testing.assert_allclose(
        float(expon_lr(iteration % 1000, 1e-3, 1e-5, **d)),
        float(j_expon_lr(jnp.float32(iteration % 1000), 1e-3, 1e-5, **d)), rtol=1e-6,
    )


def _bits(x) -> int:
    return int(np.asarray(x, np.float32).view(np.int32))


def _ulps(got, want) -> int:
    """Two float32 values' distance in units in the last place (same sign)."""
    return abs(_bits(got) - _bits(want))


@pytest.mark.parametrize("t", [1, 2, 10, 777, 30_100])
def test_adam_host_scalars_match_jax(t):
    """The Adam step's host scalars against the JAX package's formulas in
    float32 (`adam_step`: bc = 1 - beta ** t, sqrt(bc2), lr / bc1):
    bit-equal. glibc's powf and XLA's pow agree on these powers; sqrt and
    the division are IEEE on both sides."""
    bc1, bc2, sqrt_bc2 = bias_corrections(t)
    jt = jnp.float32(t)
    j_bc1, j_bc2 = 1.0 - j_optimizer.BETA1**jt, 1.0 - j_optimizer.BETA2**jt
    assert all(isinstance(x, np.float32) for x in (bc1, bc2, sqrt_bc2))
    assert _bits(bc1) == _bits(j_bc1)
    assert _bits(bc2) == _bits(j_bc2)
    assert _bits(sqrt_bc2) == _bits(jnp.sqrt(j_bc2))
    for lr in (1.6e-4 * 2.5, 0.0025, 0.05, 0.0):
        assert _bits(np.float32(lr) / bc1) == _bits(jnp.float32(lr) / j_bc1)


def _zero_lrs(opt):
    return dataclasses.replace(opt, position_lr_init=0.0, position_lr_final=0.0, feature_lr=0.0, opacity_lr=0.0,
                               scaling_lr=0.0, rotation_lr=0.0)


@pytest.mark.parametrize("iteration", [0, 1, 777, 29_999, 40_000])
@pytest.mark.parametrize("delay", [False, True])
def test_host_lr_schedule_matches_jax(iteration, delay):
    """`expon_lr` and `group_lrs` against the JAX package's, with and
    without the delay, and with zero lrs: float32 host numbers. The
    constant groups bit-equal; the schedule within 1 ulp, where numpy's
    logf, expf and sinf (glibc's) and XLA's own log, exp and sin differ in
    the last bit."""
    d = dict(lr_delay_steps=100, lr_delay_mult=0.01, max_steps=1000) if delay else {}
    step = iteration % 1000 if delay else iteration
    got = expon_lr(step, 1e-3, 1e-5, **d)
    assert isinstance(got, np.float32)
    assert _ulps(got, j_expon_lr(jnp.float32(step), 1e-3, 1e-5, **d)) <= 1
    assert expon_lr(step, 0.0, 0.0, **d) == 0.0 == float(j_expon_lr(jnp.float32(step), 0.0, 0.0, **d))
    got_g = group_lrs(OptimizationParams(), 2.5, iteration)
    want_g = j_group_lrs(JOpt(), 2.5, jnp.int32(iteration))
    assert all(isinstance(v, np.float32) for v in got_g.values())
    assert _ulps(got_g["xyz"], want_g["xyz"]) <= 1
    for k in PARAM_GROUPS[1:]:
        assert _bits(got_g[k]) == _bits(want_g[k])
    want_z = j_group_lrs(_zero_lrs(JOpt()), 2.5, jnp.int32(iteration))
    for k, v in group_lrs(_zero_lrs(OptimizationParams()), 2.5, iteration).items():
        assert v == 0.0 == float(want_z[k])


def test_add_densification_stats_matches():
    rng = np.random.default_rng(5)
    n = 40
    grad = rng.normal(size=(n, 2)).astype(np.float32) * 1e-3
    radii = rng.integers(-1, 5, n).clip(0).astype(np.int32)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    js = j_create(jnp.asarray(pts), jnp.asarray(cols), jnp.ones(n, bool), n)
    model = GaussianModel.create_from_pcd(pts, cols, device="cpu")
    for _ in range(2):
        js = j_stats(js, jnp.asarray(grad), jnp.asarray(radii), 64, 48)
        model.add_densification_stats(torch.from_numpy(grad), torch.from_numpy(radii), 64, 48)
    for k in ("xyz_grad_accum", "denom", "max_radii2d"):
        np.testing.assert_allclose(getattr(model, k).numpy(), np.asarray(getattr(js, k)), rtol=1e-6)


def test_create_from_pcd_matches():
    """Exact 3-NN scales, identity rotations, opacity 0.1, no dedup of the
    first cloud (two points in one voxel both stay)."""
    rng = np.random.default_rng(6)
    pts = rng.uniform(-1, 1, (30, 3)).astype(np.float32)
    pts[1] = pts[0] + 1e-3
    cols = rng.uniform(0, 1, (30, 3)).astype(np.float32)
    valid = np.ones(30, bool)
    valid[7] = False
    js = j_create(jnp.asarray(pts), jnp.asarray(cols), jnp.asarray(valid), 64)
    model = GaussianModel.create_from_pcd(pts, cols, valid, device="cpu")
    assert model.count == int(js.count) == 29
    for k, p in model.params().items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(getattr(js, k))[:29], atol=1e-6)
    np.testing.assert_allclose(model.opacity_act().detach().numpy(), 0.1, atol=1e-6)


def test_from_jax_state_round_trip():
    rng = np.random.default_rng(8)
    pts = rng.uniform(-1, 1, (20, 3)).astype(np.float32)
    js = j_create(jnp.asarray(pts), jnp.asarray(rng.uniform(0, 1, (20, 3)).astype(np.float32)),
                  jnp.ones(20, bool), 32)
    js = js.replace(denom=js.denom.at[:20].set(3.0), max_radii2d=js.max_radii2d.at[4].set(7.0))
    fields = {k: np.asarray(getattr(js, k)) for k in PARAM_GROUPS + ("denom", "max_radii2d",
                                                                      "xyz_grad_accum", "exist_since_iter")}
    model = from_jax_state(fields, int(js.count), device="cpu")
    back = to_numpy_state(model)
    assert model.count == 20
    for k, v in back.items():
        np.testing.assert_array_equal(v, fields[k][:20])
    ja = JAdam.init(js.params())
    m = {k: np.asarray(v) + 1.0 for k, v in ja.m.items()}
    v = {k: np.asarray(x) + 2.0 for k, x in ja.v.items()}
    adam = from_jax_adam(m, v, 4, 20, device="cpu")
    assert adam.step == 4
    for k in PARAM_GROUPS:
        np.testing.assert_array_equal(adam.m[k].numpy(), m[k][:20])
        np.testing.assert_array_equal(adam.v[k].numpy(), v[k][:20])


def test_copy_state_is_independent():
    """copy_state copies every parameter, statistic and moment, and the
    generation; the copy shares no storage with the original."""
    from gsdf_slam_tpu_torch.convert import copy_state
    from gsdf_slam_tpu_torch.models.gaussian_model import STATS

    rng = np.random.default_rng(9)
    model = GaussianModel.create_from_pcd(rng.uniform(-1, 1, (12, 3)), rng.uniform(0, 1, (12, 3)), device="cpu")
    model.denom.fill_(2.0)
    model.generation = 4
    adam = AdamState.init(model.params())
    adam.m["xyz"] += 1.0
    adam.step = 3
    m2, a2 = copy_state(model, adam)
    assert m2.generation == 4 and a2.step == 3
    for k in PARAM_GROUPS:
        assert torch.equal(getattr(m2, k), getattr(model, k))
        assert getattr(m2, k).data_ptr() != getattr(model, k).data_ptr()
        assert torch.equal(a2.m[k], adam.m[k]) and a2.m[k].data_ptr() != adam.m[k].data_ptr()
    for k in STATS:
        assert torch.equal(getattr(m2, k), getattr(model, k))
    m2.denom.zero_()
    assert float(model.denom.sum()) == 24.0


@pytest.mark.parametrize("n", [1, 3, 11, 1001])
def test_plain_adam_is_the_kernels_arithmetic(n):
    """`adam_step_plain` against csrc/adam.cu's formula written out in numpy
    float32, one rounding an op: m = b1 m + (1 - b1) g, v = b2 v +
    ((1 - b2) g) g, p - (lr/bc1 m) / (sqrt(v) / sqrt(bc2) + eps), with the
    constants the kernel is given. Bit-equal, on each group's shape and on
    counts that are not a multiple of 4 (the kernel's ragged end). The
    square root is torch's: on the CPU it is not always the correctly
    rounded one (numpy's, and sqrtf on the card), off by 1 ulp on ~0.6% of
    inputs."""
    rng = np.random.default_rng(n)
    b1, omb1, b2, omb2, eps = (np.float32(c) for c in optimizer._CONSTS)
    assert (b1, omb1, b2, omb2, eps) == (np.float32(0.9), np.float32(0.1), np.float32(0.999), np.float32(0.001),
                                         np.float32(1e-15))
    _, _, sqrt_bc2 = bias_corrections(7)
    lr_bc1 = np.float32(2.5e-3) / bias_corrections(7)[0]
    for k, s in SHAPES.items():
        shape = (n,) + s[1:]
        p, g, m = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
        v = np.abs(rng.normal(size=shape)).astype(np.float32) * np.float32(1e-3)
        m_k = b1 * m + omb1 * g
        v_k = b2 * v + (omb2 * g) * g
        p_k = p - (lr_bc1 * m_k) / (torch.sqrt(torch.from_numpy(v_k)).numpy() / sqrt_bc2 + eps)
        tp = torch.from_numpy(p.copy())
        tm, tv = optimizer.adam_step_plain(tp, torch.from_numpy(g), torch.from_numpy(m), torch.from_numpy(v),
                                           float(lr_bc1), float(sqrt_bc2))
        for got, want in ((tp, p_k), (tm, m_k), (tv, v_k)):
            assert got.numpy().view(np.int32).tolist() == want.view(np.int32).tolist(), k


def test_adam_group_struct_layout():
    """The host side of the kernel's argument: `_Group` laid out as
    csrc/adam.cu's GsdfAdamGroup (four pointers, the count, lr / bc1)."""
    g = optimizer._Group
    assert [getattr(g, f).offset for f in ("p", "g", "m", "v", "n", "lr_bc1")] == [0, 8, 16, 24, 32, 40]
    assert ctypes.sizeof(g) == 48


def test_adam_step_on_the_cpu_runs_the_plain_version():
    """CPU tensors take the plain version: no launch, new moment tensors in
    the state, the parameters updated in place, the step counted."""
    rng = np.random.default_rng(4)
    params = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32)) for k, s in SHAPES.items()}
    state = AdamState.init(params)
    m0 = dict(state.m)
    ptrs = {k: p.data_ptr() for k, p in params.items()}
    kernels.reset_launch_counts()
    adam_step(params, {k: torch.ones_like(p) for k, p in params.items()}, state,
              group_lrs(OptimizationParams(), 1.0, 0))
    assert kernels.LAUNCHES["adam_step"] == 0 and state.step == 1
    assert all(params[k].data_ptr() == ptrs[k] for k in params)
    assert all(state.m[k] is not m0[k] and float(m0[k].abs().max()) == 0.0 for k in params)
