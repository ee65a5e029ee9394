"""Port parity: model surgery (`_append`/`_prune`, `voxel_hash`,
`increase_pcd`, `densify_and_prune`, `reset_opacity`, `prune_young`), a
train -> densify -> train sequence, and the binning cache's generation.

Both packages start from one state: a JAX `GaussianState` with seeded
parameters, statistics and Adam moments, carried across by
`convert.from_jax_state`/`from_jax_adam`; the split takes JAX's own noise
rows (the same key splits), since torch cannot draw them.

Bars: exact for counts, row orders, exist_since_iter, hashes, the
statistics and every row that a surgery only moves (parameters and Adam
moments); 1e-6 of the field's largest magnitude for values a surgery
computes with exp, log, sigmoid or a rotation (the split children's xyz
and scaling, the reset opacity, the new points' scales); for the
sequence, the bars of test_torch_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import assert_scaled_close, jax_camera, scene_arrays, torch_camera

from gsdf_slam_tpu.config import OptimizationParams as JOpt
from gsdf_slam_tpu.engine import train_step as j_train_step
from gsdf_slam_tpu.models import AdamState as JAdam
from gsdf_slam_tpu.models import GaussianState
from gsdf_slam_tpu.models import gaussian_model as jg
from gsdf_slam_tpu.ops import RasterizeConfig as JCfg
from gsdf_slam_tpu_torch.config import OptimizationParams
from gsdf_slam_tpu_torch.convert import from_jax_adam, from_jax_state
from gsdf_slam_tpu_torch.engine import train_step
from gsdf_slam_tpu_torch.models import AdamState
from gsdf_slam_tpu_torch.models import gaussian_model as tg
from gsdf_slam_tpu_torch.models.optimizer import PARAM_GROUPS
from gsdf_slam_tpu_torch.ops import RasterizeConfig

STATS = ("max_radii2d", "xyz_grad_accum", "denom", "exist_since_iter")
COMPUTED_RTOL = 1e-6


def _jax_pair(n=40, cap=128, seed=0):
    """A seeded JAX state and Adam state of n live rows (capacity cap),
    with non-trivial statistics and moments, and the port's counterparts."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    fields = {
        "xyz": f32(rng.uniform(-2, 2, (cap, 3))),
        "f_dc": f32(rng.normal(size=(cap, 1, 3))),
        "f_rest": f32(0.1 * rng.normal(size=(cap, 15, 3))),
        "opacity": f32(rng.normal(size=(cap, 1))),
        "scaling": f32(rng.uniform(-5, -1, (cap, 3))),
        "rotation": f32(rng.normal(size=(cap, 4))),
        "max_radii2d": f32(rng.integers(0, 40, cap)),
        "xyz_grad_accum": f32(rng.uniform(0, 1e-3, cap)),
        "denom": f32(rng.integers(0, 3, cap)),
        "exist_since_iter": rng.integers(0, 50, cap).astype(np.int32),
    }
    m = {k: f32(rng.normal(size=fields[k].shape)) for k in PARAM_GROUPS}
    v = {k: f32(rng.uniform(0, 1, fields[k].shape)) for k in PARAM_GROUPS}
    jstate = GaussianState(**{k: jnp.asarray(a) for k, a in fields.items()}, count=jnp.int32(n))
    jadam = JAdam(m={k: jnp.asarray(a) for k, a in m.items()}, v={k: jnp.asarray(a) for k, a in v.items()},
                  step=jnp.int32(7))
    model = from_jax_state(fields, n, device="cpu")
    adam = from_jax_adam(m, v, 7, n, device="cpu")
    return jstate, jadam, model, adam


def _assert_same(jstate, jadam, model, adam, computed=None):
    """The port's model and Adam state against the JAX live prefix: exact,
    except the rows `computed` (a boolean mask or None) of xyz, scaling
    and opacity, which are held to COMPUTED_RTOL of the largest magnitude
    among them."""
    n = int(jstate.count)
    assert model.count == n
    assert adam.step == int(jadam.step)
    for k in PARAM_GROUPS:
        want = np.asarray(getattr(jstate, k))[:n]
        got = getattr(model, k).detach().numpy()
        if computed is not None and k in ("xyz", "scaling", "opacity"):
            assert_scaled_close(want[computed], got[computed], COMPUTED_RTOL, k)
            got, want = got[~computed], want[~computed]
        np.testing.assert_array_equal(got, want, err_msg=k)
        np.testing.assert_array_equal(adam.m[k].numpy(), np.asarray(jadam.m[k])[:n], err_msg=f"m {k}")
        np.testing.assert_array_equal(adam.v[k].numpy(), np.asarray(jadam.v[k])[:n], err_msg=f"v {k}")
    for k in STATS:
        np.testing.assert_array_equal(getattr(model, k).numpy(), np.asarray(getattr(jstate, k))[:n], err_msg=k)


def test_append_and_prune_order():
    """_append puts the new rows after the live ones in their order with
    zero moments and zeroes every row's statistics; _prune keeps the rest
    in order with their moments (tests/test_model.py's recipe)."""
    jstate, jadam, model, adam = _jax_pair(n=10, cap=32)
    cap = 32
    new_p = {k: jnp.full_like(v, 7.0) + jnp.arange(cap, dtype=jnp.float32).reshape((cap,) + (1,) * (v.ndim - 1))
             for k, v in jstate.params().items()}
    sel = np.zeros(cap, bool)
    sel[[2, 5, 11]] = True
    j2, ja2, aux = jg._append(jstate, jadam, new_p, jstate.exist_since_iter, jnp.asarray(sel))
    assert int(aux.dropped_for_capacity) == 0
    idx = torch.from_numpy(np.flatnonzero(sel))
    tg._append(model, adam, {k: torch.tensor(np.asarray(v))[idx] for k, v in new_p.items()},
               torch.tensor(np.asarray(jstate.exist_since_iter))[idx])
    _assert_same(j2, ja2, model, adam)
    assert model.count == 13 and float(model.denom.abs().sum()) == 0.0

    drop = np.zeros(cap, bool)
    drop[[0, 3, 11]] = True
    j3, ja3 = jg._prune(j2, ja2, jnp.asarray(drop))
    tg._prune(model, adam, torch.from_numpy(drop[:13]))
    _assert_same(j3, ja3, model, adam)
    assert model.count == 10


def test_voxel_hash_wraps_in_int32_like_jax():
    """Hashes bit-equal to the JAX package's, including coordinates whose
    products overflow int32 (+-500 m) and points on voxel boundaries."""
    rng = np.random.default_rng(1)
    grid = np.round(rng.uniform(-3, 3, (4000, 3)) / 0.05) * 0.05
    pts = np.concatenate([
        rng.uniform(-500, 500, (4000, 3)), rng.uniform(-3, 3, (4000, 3)), grid, grid * (1 + 1e-7),
        [[500.0, -500.0, 499.99], [-0.0, 0.0, -1e-9]],
    ]).astype(np.float32)
    want = np.asarray(jg.voxel_hash(jnp.asarray(pts)))
    got = tg.voxel_hash(torch.from_numpy(pts)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    vi = np.floor(pts / np.float32(0.05)).astype(np.int64)
    exact = vi @ np.array([73856093, 19349663, 83492791], np.int64)
    assert (np.abs(exact) > 2**31).mean() > 0.3  # the wrap is exercised


def test_increase_pcd_dedups_and_takes_knn_scales():
    """Points in an existing Gaussian's voxel are dropped; the rest join
    with exist_since_iter = iteration and scales from the exact 3-NN among
    the kept points only (not the existing Gaussians)."""
    jstate, jadam, model, adam = _jax_pair(n=30, cap=128, seed=2)
    rng = np.random.default_rng(3)
    xyz = np.asarray(jstate.xyz)[:30]
    new = np.concatenate([xyz[:12] + rng.uniform(-1e-3, 1e-3, (12, 3)),  # same voxel: most dedup
                          rng.uniform(3, 6, (20, 3))]).astype(np.float32)
    cols = rng.uniform(0, 1, new.shape).astype(np.float32)
    valid = np.ones(len(new), bool)
    valid[-1] = False
    j2, ja2, aux = jg.increase_pcd(jstate, jadam, jnp.asarray(new), jnp.asarray(cols), jnp.asarray(valid),
                                   jnp.int32(42))
    kept = tg.increase_pcd(model, adam, new, cols, valid, iteration=42)
    assert int(aux.dropped_for_capacity) == 0
    assert kept == int(j2.count) - 30
    assert 19 <= kept < 31  # the far points and the jitter that left its voxel
    computed = np.arange(model.count) >= 30
    _assert_same(j2, ja2, model, adam, computed=computed)
    assert np.all(model.exist_since_iter.numpy()[30:] == 42)


def _densify_state():
    """A state where every branch fires: large gradients on small and large
    Gaussians, transparent and huge rows, and large screen radii (which the
    screen-size prune never reads after a densify: the appends zeroed
    them)."""
    jstate, jadam, model, adam = _jax_pair(n=60, cap=256, seed=4)
    rng = np.random.default_rng(5)
    cap = 256
    accum = np.where(rng.uniform(size=cap) < 0.5, 5e-3, 1e-5).astype(np.float32)
    scaling = np.asarray(jstate.scaling).copy()
    scaling[::3] = np.log(0.5)  # large: split (0.01 * extent 5 = 0.05)
    scaling[7] = np.log(1.0)  # huge in the world: > 0.1 * extent
    opacity = np.asarray(jstate.opacity).copy()
    opacity[[4, 9]] = -8.0  # sigmoid < 0.005
    radii = np.full(cap, 50.0, np.float32)  # > max_screen_size 20 everywhere
    jstate = jstate.replace(xyz_grad_accum=jnp.asarray(accum), denom=jnp.ones(cap), scaling=jnp.asarray(scaling),
                            opacity=jnp.asarray(opacity), max_radii2d=jnp.asarray(radii))
    fields = {k: np.asarray(getattr(jstate, k)) for k in PARAM_GROUPS + STATS}
    return jstate, jadam, from_jax_state(fields, 60, device="cpu"), adam


def _jax_noise(key, n, cap, split_n=2):
    """The standard normal rows jax draws for each split block (the key
    splits of densify_and_prune), live prefix only."""
    rows = []
    for _ in range(split_n):
        key, sub = jax.random.split(key)
        rows.append(np.asarray(jax.random.normal(sub, (cap, 3)))[:n])
    return torch.from_numpy(np.stack(rows))


@pytest.mark.parametrize("max_screen_size", [0, 20])
def test_densify_and_prune_every_branch(max_screen_size):
    jstate, jadam, model, adam = _densify_state()
    key = jax.random.PRNGKey(11)
    kw = dict(max_grad=0.0002, min_opacity=0.005, extent=5.0, max_screen_size=max_screen_size,
              percent_dense=0.01)
    j2, ja2, aux = jg.densify_and_prune(jstate, jadam, key, **kw)
    counts = tg.densify_and_prune(model, adam, **kw, noise=_jax_noise(key, 60, 256))
    assert int(aux.dropped_for_capacity) == 0
    assert counts.cloned > 0 and counts.split > 0 and counts.pruned > 0, counts
    assert model.count == int(j2.count) == 60 + counts.cloned + counts.split - counts.pruned
    # the split children are the rows whose centre no pre-surgery row has:
    # their xyz and scaling are computed, every other value only moved
    before = {tuple(r) for r in np.asarray(jstate.xyz)[:60]}
    children = np.array([tuple(r) not in before for r in np.asarray(j2.xyz)[: model.count]])
    assert children.sum() > 0
    _assert_same(j2, ja2, model, adam, computed=children)
    # every radius was 50 > 20, yet the screen-size prune read the zeros the
    # appends left: only transparent and huge-in-the-world rows went
    assert model.count > 60


def test_densify_noise_enters_through_split_xyz():
    """split_xyz is the JAX package's R(q) (noise * exp(s)) + xyz."""
    rng = np.random.default_rng(6)
    xyz, scaling = rng.normal(size=(50, 3)), rng.uniform(-3, 0, (50, 3))
    rot, noise = rng.normal(size=(50, 4)), rng.normal(size=(50, 3))
    f = lambda a: np.asarray(a, np.float32)
    q = f(rot) / np.sqrt((f(rot) ** 2).sum(-1, keepdims=True))
    from gsdf_slam_tpu.ops.transforms import quat_to_rotmat as j_rotmat

    want = np.einsum("nij,nj->ni", np.asarray(j_rotmat(jnp.asarray(q))), f(noise) * np.exp(f(scaling))) + f(xyz)
    got = tg.split_xyz(*(torch.from_numpy(f(a)) for a in (xyz, scaling, rot, noise))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_reset_opacity():
    jstate, jadam, model, adam = _jax_pair(seed=7)
    j2, ja2 = jg.reset_opacity(jstate, jadam)
    tg.reset_opacity(model, adam)
    _assert_same(j2, ja2, model, adam, computed=np.ones(40, bool))
    assert float(model.opacity_act().detach().max()) <= 0.01 + 1e-7
    assert float(adam.m["opacity"].abs().max()) == 0.0 and adam.step == 7


@pytest.mark.parametrize("stable", [0, 10, 100])
def test_prune_young(stable):
    jstate, jadam, model, adam = _jax_pair(seed=8)
    j2, ja2 = jg.prune_young(jstate, jadam, jnp.int32(45), jnp.int32(stable))
    dropped = tg.prune_young(model, adam, 45, stable)
    _assert_same(j2, ja2, model, adam)
    assert dropped == 40 - int(j2.count)


# ---- the binning cache's generation


def _small_model():
    s = scene_arrays(p=40, seed=3)
    n = int(s["alive"].sum())
    opac = s["opac"]
    fields = {"xyz": s["means"], "f_dc": s["dc"], "f_rest": s["sh_rest"],
              "opacity": np.log(opac / (1.0 - opac)).astype(np.float32)[:, None],
              "scaling": np.log(s["scales"]).astype(np.float32), "rotation": s["quats"]}
    model = from_jax_state(fields, n, device="cpu")
    return model, AdamState.init(model.params())


SURGERIES = {
    "reset_opacity": lambda m, a: tg.reset_opacity(m, a),
    "prune_young_none_young": lambda m, a: tg.prune_young(m, a, 100, 3),
    "densify_selects_nothing": lambda m, a: tg.densify_and_prune(
        m, a, max_grad=1e9, min_opacity=0.0, extent=1.0, max_screen_size=0, generator=torch.Generator()),
    "increase_pcd_all_deduped": lambda m, a: tg.increase_pcd(
        m, a, m.xyz.detach().numpy(), np.zeros((m.count, 3), np.float32), iteration=5),
}


@pytest.mark.parametrize("surgery", list(SURGERIES))
def test_every_surgery_invalidates_a_binning_cache(surgery):
    """Each surgery keeps the count here, so only the generation tells the
    stale cache; a cache of the new generation trains."""
    model, adam = _small_model()
    cfg, cam = RasterizeConfig(height=32, width=32), torch_camera()
    gt, bg = torch.full((32, 32, 3), 0.5), torch.zeros(3)
    step = lambda i, **kw: train_step(model, adam, cam, gt, None, bg, i, 1.0, cfg, OptimizationParams(), **kw)
    _, cache = step(0, export_binning_cache=True)
    step(1, binning_cache=cache)  # the same generation: accepted
    n, gen = model.count, model.generation
    SURGERIES[surgery](model, adam)
    assert model.count == n and model.generation > gen
    with pytest.raises(ValueError, match="generation"):
        step(2, binning_cache=cache)
    _, cache = step(3, export_binning_cache=True)
    assert cache.generation == model.generation
    assert np.isfinite(float(step(4, binning_cache=cache).loss))


# ---- train -> densify -> train against the JAX mapper's order


def _gap_threshold(values, lo_q=0.3, hi_q=0.9):
    """A threshold in the widest relative gap between sorted values between
    two quantiles: float noise in the inputs cannot move a row across it."""
    v = np.sort(values[values > 0])
    lo, hi = int(lo_q * len(v)), int(hi_q * len(v))
    ratio = v[lo + 1:hi + 1] / v[lo:hi]
    i = lo + int(np.argmax(ratio))
    return float(np.sqrt(v[i] * v[i + 1])), float(ratio.max())


@pytest.fixture(scope="module")
def sequence():
    """Three training steps with densification statistics, densify_and_prune
    (noise from JAX's key), two more steps; on both packages, in the JAX
    mapper's order (engine/mapper.py:1198-1265), at 64x64."""
    s = scene_arrays()
    n = int(s["alive"].sum())
    cap = 4 * len(s["opac"])
    gt = np.random.default_rng(2).uniform(0, 1, (64, 64, 3)).astype(np.float32)
    opac = s["opac"]
    raw = {"xyz": s["means"], "f_dc": s["dc"], "f_rest": s["sh_rest"],
           "opacity": np.log(opac / (1.0 - opac)).astype(np.float32)[:, None],
           "scaling": np.log(s["scales"]).astype(np.float32), "rotation": s["quats"]}
    pad = lambda a: np.concatenate([a, np.zeros((cap - len(a),) + a.shape[1:], a.dtype)])
    jstate = GaussianState(
        **{k: jnp.asarray(pad(v)) for k, v in raw.items()}, count=jnp.int32(n),
        exist_since_iter=jnp.zeros(cap, jnp.int32), max_radii2d=jnp.zeros(cap), xyz_grad_accum=jnp.zeros(cap),
        denom=jnp.zeros(cap))
    jadam = JAdam.init(jstate.params())
    model = from_jax_state({k: np.asarray(v) for k, v in jstate.params().items()}, n, device="cpu")
    adam = AdamState.init(model.params())
    cfg, jcfg = RasterizeConfig(height=64, width=64), JCfg(height=64, width=64, max_pairs=1 << 14, chunk=128,
                                                          backend="xla")
    cam, jcam = torch_camera(), jax_camera()
    out = {"port": {"loss": []}, "jax": {"loss": []}}

    def steps(its):
        for it in its:
            m = train_step(model, adam, cam, torch.from_numpy(gt), None, torch.from_numpy(s["bg"]), it, 1.0, cfg,
                           OptimizationParams())
            out["port"]["loss"].append(float(m.loss))
            nonlocal jstate, jadam
            jstate, jadam, jm = j_train_step(jstate, jadam, jcam, jnp.asarray(gt), None, jnp.asarray(s["bg"]),
                                             jnp.int32(it), jnp.float32(1.0), jcfg, JOpt())
            out["jax"]["loss"].append(float(jm.loss))
            assert int(jm.total_pairs) < jcfg.max_pairs

    steps(range(3))
    # thresholds in gaps of this run's gradients and scales, so that the
    # stats' float noise between the packages cannot flip a selection
    denom = model.denom.numpy()
    grads = np.where(denom > 0, model.xyz_grad_accum.numpy() / np.maximum(denom, 1), 0)
    max_grad, grad_gap = _gap_threshold(grads)
    scale_cut, scale_gap = _gap_threshold(model.scaling_act().amax(1).detach().numpy(), 0.2, 0.8)
    kw = dict(max_grad=max_grad, min_opacity=0.005, extent=scale_cut / 0.01, max_screen_size=0)
    key = jax.random.PRNGKey(3)
    out["counts"] = tg.densify_and_prune(model, adam, **kw, noise=_jax_noise(key, n, cap))
    jstate, jadam, aux = jg.densify_and_prune(jstate, jadam, key, **kw)
    out["dropped"] = int(aux.dropped_for_capacity)
    out["after_densify"] = (model.count, int(jstate.count))
    out["gaps"] = (grad_gap, scale_gap)
    steps(range(3, 5))
    n = int(jstate.count)
    out["port"].update(count=model.count, params={k: p.detach().numpy() for k, p in model.params().items()},
                       m={k: v.numpy() for k, v in adam.m.items()}, v={k: v.numpy() for k, v in adam.v.items()},
                       exist=model.exist_since_iter.numpy())
    out["jax"].update(count=n, params={k: np.asarray(v)[:n] for k, v in jstate.params().items()},
                      m={k: np.asarray(v)[:n] for k, v in jadam.m.items()},
                      v={k: np.asarray(v)[:n] for k, v in jadam.v.items()},
                      exist=np.asarray(jstate.exist_since_iter)[:n])
    return out


LR = {"xyz": 1.6e-4, "f_dc": 2.5e-3, "f_rest": 1.25e-4, "opacity": 5e-2, "scaling": 5e-3, "rotation": 1e-3}


def test_sequence_counts_and_losses(sequence):
    assert sequence["dropped"] == 0  # the JAX capacity held every appended row
    c = sequence["counts"]
    assert c.cloned > 0 and c.split > 0, c
    assert sequence["after_densify"][0] == sequence["after_densify"][1]
    assert min(sequence["gaps"]) > 1.01, sequence["gaps"]
    assert sequence["port"]["count"] == sequence["jax"]["count"]
    np.testing.assert_array_equal(sequence["port"]["exist"], sequence["jax"]["exist"])
    np.testing.assert_allclose(sequence["port"]["loss"], sequence["jax"]["loss"], atol=1e-6)


def test_sequence_parameters_and_moments(sequence):
    """Parameters to 0.05 lr after the steps (test_torch_train.py's bar);
    Adam's moments to 2e-5 scaled per group (the gradient bar)."""
    port, want = sequence["port"], sequence["jax"]
    for k in PARAM_GROUPS:
        err = float(np.abs(port["params"][k] - want["params"][k]).max()) / LR[k]
        assert err < 0.05, f"{k}: {err:.3g} lr"
        assert_scaled_close(want["m"][k], port["m"][k], 2e-5, f"m {k}")
        assert_scaled_close(want["v"][k], port["v"][k], 2e-5, f"v {k}")
