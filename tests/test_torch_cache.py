"""Port parity of the cached-binning cadence: the export render (K4's
plain version and the pruned `BinningCache`), the cached render
(`CachedBlend`) and the cadence of `train_step`, against the JAX package's
grouped Pallas path (`backend="pallas", pallas_group=8`, interpret mode),
as tests/test_binning_cache.py runs it.

Bars: images 5e-6 absolute and gradients 2e-5 after scaling
(tests/test_pallas_blend.py); the kept (tile, Gaussian) sequence of the
export step exactly; the cadence's losses to 1e-6, step-1 gradients to
2e-5 scaled and parameters to 0.05 lr units (tests/test_torch_train.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_binning_cache import _saturating_scene
from test_torch_train import LR, _jax_state
from torch_port_helpers import assert_scaled_close, jax_args, jax_camera, scene_arrays, torch_camera

from gsdf_slam_tpu.config import OptimizationParams as JOpt
from gsdf_slam_tpu.engine import train_step as j_train_step
from gsdf_slam_tpu.models import AdamState as JAdam
from gsdf_slam_tpu.ops import RasterizeConfig as JCfg
from gsdf_slam_tpu.ops import render as j_render
from gsdf_slam_tpu_torch.config import OptimizationParams
from gsdf_slam_tpu_torch.convert import from_jax_cache, from_jax_state
from gsdf_slam_tpu_torch.engine import train_step
from gsdf_slam_tpu_torch.models import AdamState
from gsdf_slam_tpu_torch.models.optimizer import PARAM_GROUPS
from gsdf_slam_tpu_torch.ops import CameraMatrices, RasterizeConfig, render
from gsdf_slam_tpu_torch.ops.binning import Binned
from gsdf_slam_tpu_torch.ops.blend import pair_tiles
from gsdf_slam_tpu_torch.ops.tile_blend import build_pruned_cache

JCFG = JCfg(height=64, width=64, max_pairs=4096, chunk=128, backend="pallas", pallas_group=8)
JCFG32 = dataclasses.replace(JCFG, height=32, width=32)


def _jax_cache_arrays(cache):
    return {k: np.asarray(getattr(cache, k)) for k in ("ranges", "gid", "slot", "total_pairs")}


def _pairs(cache):
    """The cache's (tile, Gaussian) sequence, in its order."""
    tile, _ = pair_tiles(cache.ranges, cache.gid.shape[0])
    return tile.tolist(), cache.gid.tolist()


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _loss(out):
    return (out.image ** 2).sum() + 0.1 * out.final_t.sum()


def _port_grads(params, cam, bg, cfg, **kw):
    """Image, final T and the gradients of `_loss` wrt the six parameters."""
    params = [p.clone().requires_grad_(True) for p in params]
    out = render(*params, cam, bg, cfg, **kw)
    grads = torch.autograd.grad(_loss(out), params)
    return out.image.detach(), out.final_t.detach(), [g.numpy() for g in grads]


# ------------------------------------------------------------------ layout
def test_build_pruned_cache_layout():
    """Counts, ranges, order-preserving compaction of gid, total_pairs
    passed through; keep=None exports the binning unpruned (the port's
    counterpart of test_build_pruned_cache_layout_invariants)."""
    rng = np.random.default_rng(0)
    counts = np.array([200, 0, 150, 37])
    ends = np.cumsum(counts)
    ranges = np.stack([ends - counts, ends], 1)
    ranges[counts == 0] = 0
    m = int(counts.sum())
    gid = rng.integers(0, 10, m).astype(np.int32)
    keep = rng.random(m) < 0.6
    keep[ranges[3, 0]:ranges[3, 1]] = False  # a tile that loses every pair
    binned = Binned(
        ranges=torch.from_numpy(ranges.astype(np.int32)), gid=torch.from_numpy(gid),
        payload=torch.zeros((9, m)), total_pairs=500,
    )
    cache = build_pruned_cache(binned, torch.from_numpy(keep), num_gaussians=10, image_size=(32, 32))
    new = cache.ranges.numpy()
    assert cache.ranges.dtype == torch.int32 and cache.gid.dtype == torch.int32
    kept = np.array([int(keep[s:e].sum()) for s, e in ranges])
    want = np.stack([np.cumsum(kept) - kept, np.cumsum(kept)], 1)
    want[counts == 0] = 0  # an empty tile keeps its (0, 0)
    np.testing.assert_array_equal(new, want)
    for (s, e), (ns, ne) in zip(ranges, new):
        np.testing.assert_array_equal(cache.gid.numpy()[ns:ne], gid[s:e][keep[s:e]])
    assert cache.total_pairs == 500 and cache.gid.shape[0] == int(keep.sum())
    assert (cache.num_gaussians, cache.image_size) == (10, (32, 32))

    full = build_pruned_cache(binned, None, num_gaussians=10, image_size=(32, 32))
    assert torch.equal(full.ranges, binned.ranges) and torch.equal(full.gid, binned.gid)
    assert full.total_pairs == 500


# ------------------------------------------------------- export, saturating
@pytest.fixture(scope="module")
def saturating():
    scene = _saturating_scene()
    jexp = jax.jit(lambda s: j_render(*s, JCFG32, export_binning_cache=True))(scene)
    params = [_t(a) for a in scene[:6]]
    cam = CameraMatrices.from_pose(np.array([1.0, 0, 0, 0]), np.zeros(3), np.pi / 2, np.pi / 2, device="cpu")
    return dict(jexp=jexp, params=params, cam=cam, bg=_t(scene[8]), n=scene[0].shape[0])


def test_export_render_and_pruned_cache_match_jax(saturating):
    s = saturating
    out = render(*s["params"], s["cam"], s["bg"], RasterizeConfig(32, 32), export_binning_cache=True)
    jexp = s["jexp"]
    np.testing.assert_allclose(out.image.numpy(), np.asarray(jexp.image), atol=5e-6)
    np.testing.assert_allclose(out.final_t.numpy(), np.asarray(jexp.final_t), atol=5e-6)
    cache = out.binning_cache
    want = from_jax_cache(_jax_cache_arrays(jexp.binning_cache), s["n"], (32, 32), device="cpu")
    assert _pairs(cache) == _pairs(want)
    assert cache.total_pairs == want.total_pairs == int(out.total_pairs)
    unpruned = render(*s["params"], s["cam"], s["bg"], RasterizeConfig(32, 32, cache_prune_margin=0.0),
                      export_binning_cache=True).binning_cache
    assert 0 < cache.gid.shape[0] < unpruned.gid.shape[0], "the saturating scene must prune pairs"


def test_pruned_cache_exact_at_export_params(saturating):
    """At export parameters the pruned cache renders, and differentiates,
    like the unpruned one (margin 0): dead pairs add nothing."""
    s = saturating
    runs = []
    for margin in (10.0, 0.0):
        cfg = RasterizeConfig(32, 32, cache_prune_margin=margin)
        cache = render(*s["params"], s["cam"], s["bg"], cfg, export_binning_cache=True).binning_cache
        runs.append(_port_grads(s["params"], s["cam"], s["bg"], cfg, binning_cache=cache))
    (img_p, ft_p, g_p), (img_f, ft_f, g_f) = runs
    np.testing.assert_allclose(img_p.numpy(), img_f.numpy(), atol=1e-6)
    np.testing.assert_allclose(ft_p.numpy(), ft_f.numpy(), atol=1e-6)
    for name, a, b in zip(("means", "scales", "quats", "opac", "dc", "sh_rest"), g_f, g_p):
        assert_scaled_close(a, b, 2e-5, name)


# -------------------------------------------------- cached render, 64x64
@pytest.fixture(scope="module")
def exported():
    s = scene_arrays(seed=6)
    jexp = jax.jit(lambda *a: j_render(*a, JCFG, export_binning_cache=True))(
        *jax_args(s), jax_camera(), jnp.asarray(s["bg"]))
    n = int(s["alive"].sum())
    return dict(s=s, n=n, jcache=jexp.binning_cache,
                cache=from_jax_cache(_jax_cache_arrays(jexp.binning_cache), n, (64, 64), device="cpu"))


def _moved(s, case):
    means, opac = s["means"].copy(), s["opac"].copy()
    if case == "nudged":
        means = means + np.float32(1e-4)  # ~0.03 px: the cadence's drift
    else:
        means[4:10, 2] = -3.0  # behind the camera: non-finite projection payload
        opac[10:16] = 1e-4  # below the 1/255 contribution floor
    return dict(s, means=means, opac=opac)


@pytest.mark.parametrize("case", ["nudged", "invalidated"])
def test_cached_render_and_gradients_match_jax(exported, case):
    e = exported
    s, n = _moved(e["s"], case), e["n"]

    def jloss(params, cache):
        out = j_render(*params, jnp.asarray(s["alive"]), jax_camera(), jnp.asarray(s["bg"]), JCFG,
                       binning_cache=cache)
        return jnp.sum(out.image ** 2) + 0.1 * jnp.sum(out.final_t), out

    jparams = jax_args(s)[:6]
    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams, e["jcache"])
    img, ft, grads = _port_grads([torch.from_numpy(np.asarray(a)[:n].copy()) for a in jparams],
                                 torch_camera(), _t(s["bg"]), RasterizeConfig(64, 64),
                                 binning_cache=e["cache"])
    assert torch.isfinite(img).all() and all(np.isfinite(g).all() for g in grads)
    np.testing.assert_allclose(img.numpy(), np.asarray(jout.image), atol=5e-6)
    np.testing.assert_allclose(ft.numpy(), np.asarray(jout.final_t), atol=5e-6)
    for name, a, b in zip(("means", "scales", "quats", "opac", "dc", "sh_rest"), jgrads, grads):
        assert_scaled_close(np.asarray(a)[:n], b, 2e-5, name)
    if case == "invalidated":
        assert np.abs(grads[0][4:10]).max() == 0.0
        assert np.abs(grads[3][10:16]).max() == 0.0


# ------------------------------------------------------------ the cadence
@pytest.fixture(scope="module")
def cadence():
    """1 export step and 2 cached steps on each side, from one state."""
    s = scene_arrays()
    n = int(s["alive"].sum())
    gt = np.random.default_rng(2).uniform(0, 1, (64, 64, 3)).astype(np.float32)
    jstate = _jax_state(s)

    model = from_jax_state({k: np.asarray(v) for k, v in jstate.params().items()}, n, device="cpu")
    adam = AdamState.init(model.params())
    port = {"loss": []}
    cache = None
    for it in range(3):
        kw = dict(binning_cache=cache) if cache is not None else dict(export_binning_cache=True)
        m = train_step(model, adam, torch_camera(), torch.from_numpy(gt), None, torch.from_numpy(s["bg"]),
                       it, 1.0, RasterizeConfig(64, 64), OptimizationParams(), **kw)
        if cache is None:
            m, cache = m
            port["m1"] = {k: v.clone().numpy() for k, v in adam.m.items()}
            port["cache_pairs"] = cache.gid.shape[0]
        port["loss"].append(float(m.loss))
    port["params"] = {k: p.detach().numpy() for k, p in model.params().items()}
    port["stats"] = {k: getattr(model, k).numpy() for k in ("xyz_grad_accum", "denom", "max_radii2d")}

    st, ad = jstate, JAdam.init(jstate.params())
    want = {"loss": []}
    jcache = None
    args = lambda it: (jax_camera(), jnp.asarray(gt), None, jnp.asarray(s["bg"]), jnp.int32(it),
                       jnp.float32(1.0), JCFG, JOpt())
    for it in range(3):
        if jcache is None:
            st, ad, met, jcache = j_train_step(st, ad, *args(it), export_binning_cache=True)
            want["m1"] = {k: np.asarray(v)[:n] for k, v in ad.m.items()}
        else:
            st, ad, met = j_train_step(st, ad, *args(it), binning_cache=jcache)
        want["loss"].append(float(met.loss))
    want["params"] = {k: np.asarray(v)[:n] for k, v in st.params().items()}
    want["stats"] = {k: np.asarray(getattr(st, k))[:n] for k in ("xyz_grad_accum", "denom", "max_radii2d")}
    want["cache_pairs"] = int(np.asarray(jcache.ranges)[1].sum())
    return port, want


def test_cadence_matches_jax(cadence):
    port, want = cadence
    assert port["cache_pairs"] == want["cache_pairs"]
    np.testing.assert_allclose(port["loss"], want["loss"], atol=1e-6)
    for k in PARAM_GROUPS:
        assert_scaled_close(want["m1"][k], port["m1"][k], 2e-5, k)
        err = float(np.abs(port["params"][k] - want["params"][k]).max()) / LR[k]
        assert err < 0.05, f"{k}: {err:.3g} lr"
    for k, v in want["stats"].items():
        np.testing.assert_allclose(port["stats"][k], v, rtol=1e-4, atol=1e-9, err_msg=k)


# ----------------------------------------------------------------- misuse
def test_bad_margin_and_mismatched_cache_raise(saturating):
    for margin in (0.5, 1e-3, -1.0):
        with pytest.raises(ValueError, match="cache_prune_margin"):
            RasterizeConfig(32, 32, cache_prune_margin=margin)
    RasterizeConfig(32, 32, cache_prune_margin=0.0)
    RasterizeConfig(32, 32, cache_prune_margin=1.0)

    s = saturating
    cfg = RasterizeConfig(32, 32)
    cache = render(*s["params"], s["cam"], s["bg"], cfg, export_binning_cache=True).binning_cache
    fewer = [p[:-1] for p in s["params"]]
    with pytest.raises(ValueError, match="Gaussians"):
        render(*fewer, s["cam"], s["bg"], cfg, binning_cache=cache)
    with pytest.raises(ValueError, match="image"):
        render(*s["params"], s["cam"], s["bg"], RasterizeConfig(32, 48), binning_cache=cache)
