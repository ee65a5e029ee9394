"""Port parity: Adam, the lr schedule, densification stats, model creation
and carrying state across from the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsdf_slam_tpu.config import OptimizationParams as JOpt
from gsdf_slam_tpu.models import AdamState as JAdam
from gsdf_slam_tpu.models import adam_step as j_adam_step
from gsdf_slam_tpu.models import create_from_pcd as j_create
from gsdf_slam_tpu.models.gaussian_model import add_densification_stats as j_stats
from gsdf_slam_tpu.models.optimizer import expon_lr as j_expon_lr
from gsdf_slam_tpu.models.optimizer import group_lrs as j_group_lrs
from gsdf_slam_tpu_torch.config import OptimizationParams
from gsdf_slam_tpu_torch.convert import from_jax_adam, from_jax_state, to_numpy_state
from gsdf_slam_tpu_torch.models import AdamState, GaussianModel, adam_step, expon_lr, group_lrs
from gsdf_slam_tpu_torch.models.optimizer import PARAM_GROUPS

SHAPES = {"xyz": (11, 3), "f_dc": (11, 1, 3), "f_rest": (11, 15, 3), "opacity": (11, 1),
          "scaling": (11, 3), "rotation": (11, 4)}


def test_adam_matches_jax_over_steps():
    """Five steps with per-group lrs: parameters and moments to 1e-7 (same
    op order, float32 throughout)."""
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
        adam_step(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts,
                  {k: torch.tensor(v) for k, v in lr.items()})
    assert ts.step == int(js.step) == 5
    for k in PARAM_GROUPS:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-7, rtol=0)
        np.testing.assert_allclose(ts.m[k].numpy(), np.asarray(js.m[k]), atol=1e-7, rtol=0)
        np.testing.assert_allclose(ts.v[k].numpy(), np.asarray(js.v[k]), atol=1e-7, rtol=0)


@pytest.mark.parametrize("iteration", [0, 1, 777, 29_999, 40_000])
def test_group_lrs_match(iteration):
    want = j_group_lrs(JOpt(), 2.5, jnp.int32(iteration))
    got = group_lrs(OptimizationParams(), 2.5, iteration, device="cpu")
    for k in PARAM_GROUPS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)
    d = dict(lr_delay_steps=100, lr_delay_mult=0.01, max_steps=1000)
    np.testing.assert_allclose(
        float(expon_lr(iteration % 1000, 1e-3, 1e-5, **d, device="cpu")),
        float(j_expon_lr(jnp.float32(iteration % 1000), 1e-3, 1e-5, **d)), rtol=1e-6,
    )


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
