"""Port parity of the probe path: each plain version of
`gsdf_slam_tpu_torch/ops/blend_probe.py` against its JAX body in
`benchmarks/kernel_probe.py` and `benchmarks/expand_probe.py` (loaded by
path; Pallas interpret mode), on the same binning: `sort_expand_pack` at
`group=1`, turned into the port's layout by `convert.from_jax_pairs`.

Scenes: `tests/test_render.py::make_scene(p=96, seed=1)` at 64x64, where no
tile's raw T falls below 1e-4, and the opaque wall of
`probes/scene.py` at 32x32, where the chunk exit fires. Chunks of 128 and 16
pairs (at 16 tiles span several chunks).

Bars, those of the card checks in chip_smoke.py: accum and T = exp(log T),
effective and raw, within 5e-6 absolute (the image bar of
tests/test_pallas_blend.py); n_done exact; gradients within 2e-5 scaled per
field (mean, conic, opacity, colour). Where accum is not an image (the
`nocarry` stand-in applies every pair and sums to ~20), its bar is 5e-6 of
its largest value: 5e-6 absolute is 2 ulps there.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import assert_scaled_close, jax_args, jax_camera, scene_arrays

from gsdf_slam_tpu.ops import CameraMatrices as JCam
from gsdf_slam_tpu.ops import projection as jproj
from gsdf_slam_tpu.ops.pallas_binning import sort_expand_pack
from gsdf_slam_tpu_torch.convert import from_jax_pairs
from gsdf_slam_tpu_torch.ops import blend, blend_probe
from gsdf_slam_tpu_torch.probes import checks, expand_probe
from gsdf_slam_tpu_torch.probes.scene import WALL_SIZE, wall_arrays

REPO = Path(__file__).resolve().parent.parent
BAR = checks.FWD_SMALL
GRAD_BAR = checks.BWD_SMALL
FIELDS = checks.FIELDS
# JAX body of run_fwd_variant -> the port's mode
BODIES = {
    "floor": "floor",
    "nomxu": "nocarry",
    "novpu": "notrans",
    "noterm": "noexit",
    "opt": "chunk_exit",
    "roll": "chunk_exit",
    "unroll2": "unroll2",
}


@functools.cache
def _jax_module(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _body(kp, name):
    if name in ("nomxu", "novpu"):
        return kp._fwd_kernel_variant(name)
    return getattr(kp, f"_fwd_kernel_{name}")


@functools.cache
def _binned(scene, chunk):
    """The scene's `sort_expand_pack(group=1)` for both packages."""
    if scene == "render":
        size, args, cam = 64, jax_args(scene_arrays(p=96, seed=1)), jax_camera()
    else:
        w = wall_arrays()
        size = WALL_SIZE
        args = tuple(jnp.asarray(w[k]) for k in ("means", "scales", "quats", "opac", "dc", "sh_rest"))
        args += (jnp.ones(w["opac"].shape[0], bool),)
        cam = JCam.from_pose(np.array([1.0, 0, 0, 0]), np.zeros(3), np.pi / 2, np.pi / 2)
    pre = jax.jit(lambda *a: jproj.preprocess(*a[:7], a[7], width=size, height=size, sh_degree=3))(*args, cam)
    gw = gh = size // 16
    sp = sort_expand_pack(pre.depths, pre.rect_min, pre.rect_max, pre.tiles_touched, pre.means2d,
                          pre.conics, args[3], pre.colors, grid_w=gw, grid_h=gh, max_pairs=4096,
                          chunk=chunk, group=1)
    ranges, payload = from_jax_pairs(np.asarray(sp.ranges), np.asarray(sp.pairs), device="cpu")
    return dict(jr=sp.ranges, jp=sp.pairs, gw=gw, gh=gh, nt=gw * gh, ranges=ranges, payload=payload)


def _tiles(out, nt):
    """A JAX probe's (accum, teff, traw, ndone) at group 1 as [T, ...] numpy."""
    acc, teff, traw, nd = (np.asarray(x) for x in out)
    return acc.reshape(nt, 256, 3), teff.reshape(nt, 256), traw.reshape(nt, 256), nd.reshape(nt)


@functools.cache
def _jax_fwd(body, scene, chunk):
    kp = _jax_module("kernel_probe")
    b = _binned(scene, chunk)
    args = (b["jr"], b["jp"], b["nt"], b["gw"], chunk, 1)
    if body == "production":
        out = kp._run_fwd(*args)
    elif body == "pair2":
        out = kp.run_fwd_pair2(*args)
    else:
        out = kp.run_fwd_variant(_body(kp, body), *args, nbuf=4 if body == "unroll2" else 2)
    return _tiles(out, b["nt"])


def _assert_fwd_close(got, want, tiles=slice(None), what=""):
    acc, teff, traw, nd = (np.asarray(x)[tiles] for x in got)
    w_acc, w_teff, w_traw, w_nd = (x[tiles] for x in want)
    scale = max(1.0, float(np.abs(w_acc).max(initial=0.0)))
    np.testing.assert_allclose(acc, w_acc, atol=BAR * scale, rtol=0, err_msg=f"{what} accum")
    np.testing.assert_allclose(np.exp(teff), np.exp(w_teff), atol=BAR, rtol=0, err_msg=f"{what} T_eff")
    np.testing.assert_allclose(np.exp(traw), np.exp(w_traw), atol=BAR, rtol=0, err_msg=f"{what} T_raw")
    np.testing.assert_array_equal(nd, w_nd, err_msg=f"{what} n_done")


def _port_fwd(b, mode, chunk):
    return blend_probe.blend_probe_fwd(b["ranges"], b["payload"], b["gw"], b["gh"], mode, chunk)


@pytest.mark.parametrize("chunk", [128, 16])
@pytest.mark.parametrize("scene", ["render", "wall"])
@pytest.mark.parametrize("body", list(BODIES))
def test_fwd_body_matches_jax(body, scene, chunk):
    b = _binned(scene, chunk)
    got = _port_fwd(b, BODIES[body], chunk)
    want = _jax_fwd(body, scene, chunk)
    if body == "floor":
        # The TPU sum reads the whole chunk, padding lanes included, which
        # hold the neighbours' pairs: log_t_eff is held to its definition,
        # the sum over chunks of 1e-30 x the tile's mean x, instead.
        acc, teff, traw, nd = (x.numpy() for x in got)
        mx = b["payload"][0].double().numpy()
        r = b["ranges"].numpy()
        n_chunks = -(-(r[:, 1] - r[:, 0]) // chunk)
        sums = np.array([sum(mx[s0 + c * chunk:min(s0 + (c + 1) * chunk, e0)].sum() * 1e-30
                             for c in range(nc)) for (s0, e0), nc in zip(r, n_chunks)])
        np.testing.assert_allclose(teff, np.repeat(sums[:, None], 256, 1), rtol=1e-5, atol=0)
        assert np.all(acc == 0) and np.all(traw == 0) and np.all(want[0] == 0) and np.all(want[2] == 0)
        np.testing.assert_array_equal(nd, want[3])
        np.testing.assert_array_equal(nd, n_chunks)
        return
    if body == "unroll2":
        # The TPU body applies two chunks per iteration and reads the second
        # slot even where no DMA filled it (a walk ending on an odd chunk):
        # compare only where its output is finite, and hold accum and
        # log_t_eff on every tile against the production kernel.
        finite = np.isfinite(want[0]).all((1, 2)) & np.isfinite(want[1]).all(1)
        _assert_fwd_close(got, want, finite, "unroll2 vs JAX")
        prod = _jax_fwd("production", scene, chunk)
        np.testing.assert_allclose(got[0].numpy(), prod[0], atol=BAR, rtol=0)
        np.testing.assert_allclose(np.exp(got[1].numpy()), np.exp(prod[1]), atol=BAR, rtol=0)
        assert np.all(got[3].numpy() >= prod[3])
        return
    _assert_fwd_close(got, want, what=body)


def test_wall_fires_the_chunk_exit():
    """At chunk 16 the production kernel stops some tile of the wall before
    its last chunk, and the port's chunk_exit stops it at the same chunk."""
    b = _binned("wall", 16)
    r = b["ranges"].numpy()
    n_chunks = -(-(r[:, 1] - r[:, 0]) // 16)
    prod = _jax_fwd("production", "wall", 16)
    assert np.any(prod[3] < n_chunks), (prod[3], n_chunks)
    np.testing.assert_array_equal(_port_fwd(b, "chunk_exit", 16)[3].numpy(), prod[3])


@pytest.mark.parametrize("chunk", [128, 16])
@pytest.mark.parametrize("scene", ["render", "wall"])
def test_pair2_matches_jax(scene, chunk):
    """pair2 against its JAX body, and both against chunk_exit / production:
    the same accum and log T, and n_done the larger of the pair's."""
    b = _binned(scene, chunk)
    got = blend_probe.blend_probe_fwd_pair2(b["ranges"], b["payload"], b["gw"], b["gh"], chunk)
    want = _jax_fwd("pair2", scene, chunk)
    _assert_fwd_close(got, want, what="pair2")
    single = _port_fwd(b, "chunk_exit", chunk)
    for g, s in zip(got[:3], single[:3]):
        assert torch.equal(g, s)
    pair_max = np.maximum(single[3].numpy()[0::2], single[3].numpy()[1::2]).repeat(2)
    np.testing.assert_array_equal(got[3].numpy(), pair_max)
    prod = _jax_fwd("production", scene, chunk)
    np.testing.assert_allclose(want[0], prod[0], atol=BAR, rtol=0)
    np.testing.assert_array_equal(want[3], np.maximum(prod[3][0::2], prod[3][1::2]).repeat(2))


@functools.cache
def _jax_bwd(scene, chunk):
    """`_bwd_kernel_opt`'s per-pair gradients [9, M] from the production
    forward's ndone and raw log T, and the port's inputs for the same walk."""
    kp = _jax_module("kernel_probe")
    b = _binned(scene, chunk)
    nt = b["nt"]
    acc, teff, traw, nd = _jax_fwd("production", scene, chunk)
    rng = np.random.default_rng(0)
    ct_a = rng.standard_normal((nt, 256, 3)).astype(np.float32)
    ct_t = rng.standard_normal((nt, 256)).astype(np.float32)
    ranges3 = jnp.concatenate([b["jr"], jnp.asarray(nd)[None, :]], axis=0)
    jg = kp.run_bwd_variant(
        kp._bwd_kernel_opt, ranges3, b["jp"], jnp.asarray(traw[:, :, None]),
        jnp.asarray(ct_a[:, :, None, :]), jnp.asarray(ct_t[:, :, None]), b["jp"].shape[1], nt,
        b["gw"], chunk, 1,
    )
    starts, counts = np.asarray(b["jr"])
    lanes = np.concatenate([np.arange(s, s + n) for s, n in zip(starts, counts)])
    t = torch.from_numpy
    args = (b["ranges"], b["payload"], t(nd.astype(np.int32)), t(traw.copy()), t(ct_a), t(ct_t),
            b["gw"], b["gh"], chunk)
    return np.asarray(jg)[:9, lanes], args


@pytest.mark.parametrize("chunk", [128, 16])
@pytest.mark.parametrize("scene", ["render", "wall"])
def test_bwd_opt_matches_jax(scene, chunk):
    """blend_probe_bwd against `_bwd_kernel_opt` from the production
    forward's ndone and raw log T, on per-pair gradients."""
    want, args = _jax_bwd(scene, chunk)
    got = blend_probe.blend_probe_bwd(*args).numpy()
    assert np.abs(want).max() > 0
    for name, rows in FIELDS.items():
        assert_scaled_close(want[rows], got[rows], GRAD_BAR, name)


@pytest.mark.parametrize("chunk", [128, 16])
@pytest.mark.parametrize("scene", ["render", "wall"])
def test_bwd_chunk_carry32_matches_jax(scene, chunk):
    """The plain backward with the JAX body's carry (float32, rounded once
    per chunk), the variant chip_smoke.py sets beside the float64 carry at
    the headline, against `_bwd_kernel_opt`; on these scenes it applies the
    same pairs as the float64 carry."""
    want, args = _jax_bwd(scene, chunk)
    got, applied32 = blend_probe.blend_probe_bwd_plain(*args, chunk_carry32=True, with_applied=True)
    for name, rows in FIELDS.items():
        assert_scaled_close(want[rows], got.numpy()[rows], GRAD_BAR, name)
    _, applied = blend_probe.blend_probe_bwd_plain(*args, with_applied=True)
    assert int(applied.sum()) > 0
    assert torch.equal(applied32, applied)


@pytest.mark.parametrize("fault", ["none", "reordered", "wrong_field", "last_chunk_dropped", "zero"])
def test_floor_check_catches_faults(fault):
    """The card check of `floor` (probes/checks.py) on outputs that a faulty
    kernel would write: summing mean y, dropping each tile's partial last
    chunk, or writing 0 all leave T = exp(log_t_eff) at 1 and pass the
    image bars; the check of log_t_eff / 1e-30 fails them, and passes the
    same sums taken in float64."""
    b = _binned("render", 16)
    ranges, payload, g = b["ranges"], b["payload"], b["gw"]
    want = blend_probe.blend_probe_fwd_plain(ranges, payload, g, g, "floor", 16)
    acc, teff, traw, nd = want
    if fault == "reordered":
        cs = torch.cat([torch.zeros(1, dtype=torch.float64), torch.cumsum(payload[0].double(), 0)])
        teff = ((cs[ranges[:, 1].long()] - cs[ranges[:, 0].long()]) * blend_probe.FLOOR_SCALE).float()
        teff = teff[:, None].expand_as(want[1])
    elif fault == "wrong_field":
        teff = blend_probe.blend_probe_fwd_plain(ranges, payload[[1, 0, *range(2, 9)]], g, g, "floor", 16)[1]
    elif fault == "last_chunk_dropped":
        n = ranges[:, 1] - ranges[:, 0]
        assert bool((n % 16 != 0).any())
        cut = torch.stack([ranges[:, 0], ranges[:, 0] + n // 16 * 16], 1)
        teff = blend_probe.blend_probe_fwd_plain(cut, payload, g, g, "floor", 16)[1]
    elif fault == "zero":
        teff = torch.zeros_like(teff)
    errs, failed = checks.fwd_check("floor", (acc, teff, traw, nd), want, payload, ranges, checks.FWD_SMALL)
    assert errs["t_eff"] <= checks.FWD_SMALL
    assert failed == ([] if fault in ("none", "reordered") else ["floor-sum"]), errs


@pytest.mark.parametrize("chunk", [128, 16])
@pytest.mark.parametrize("scene", ["render", "wall"])
def test_from_jax_pairs_gives_the_jax_image(scene, chunk):
    """The converted binning drives K1's plain version to the production
    `_run_fwd` image at group 1."""
    b = _binned(scene, chunk)
    r = b["ranges"].numpy()
    assert r[0, 0] == 0 and np.all(r[1:, 0] == r[:-1, 1]) and r[-1, 1] == b["payload"].shape[1]
    acc, lte, *_ = blend.blend_fwd_plain(b["ranges"], b["payload"], b["gw"], b["gh"])
    prod = _jax_fwd("production", scene, chunk)
    np.testing.assert_allclose(acc.numpy(), prod[0], atol=BAR, rtol=0)
    np.testing.assert_allclose(np.exp(lte.numpy()), np.exp(prod[1]), atol=BAR, rtol=0)


@pytest.mark.parametrize("body", ["mm", "dg"])
def test_expand_matches_jax(body):
    """expand_gather's plain version bit-equal to `make_expand` with either
    JAX body, on the probe's own synthetic expansion (mp 4096, p 1500)."""
    ep = _jax_module("expand_probe")
    mp, p = 4096, 1500
    table, rank, g0, lr, p_lanes = expand_probe.build(mp, p)
    j_table, j_rank, j_g0, j_lr, j_lanes = ep.build(mp, p)
    assert p_lanes == j_lanes
    for a, ja in ((table, j_table), (rank, j_rank), (g0, j_g0), (lr, j_lr[0])):
        np.testing.assert_array_equal(a, np.asarray(ja))
    (want,) = ep.make_expand(getattr(ep, f"_expand_kernel_{body}"), mp, p_lanes)(j_g0, j_lr, j_table)
    got = blend_probe.expand_gather(torch.from_numpy(table), torch.from_numpy(g0), torch.from_numpy(lr))
    np.testing.assert_array_equal(got.numpy().view(np.int32), np.asarray(want).view(np.int32))
    np.testing.assert_array_equal(got.numpy().view(np.int32), table[:, rank].view(np.int32))


@pytest.mark.parametrize("chunk", [128, 16])
@pytest.mark.parametrize("scene", ["render", "wall"])
def test_bwd_opt_folded_matches_k2(scene, chunk):
    """The probe's per-pair gradients, summed per Gaussian, are K2's: the
    walk back from chunk_exit's raw log T applies the pairs that K2's walk
    from n_contrib applies."""
    b = _binned(scene, chunk)
    gid = torch.from_numpy(np.asarray(b["jp"])[10].view(np.int32)[
        np.concatenate([np.arange(s, s + n) for s, n in np.asarray(b["jr"]).T])].copy())
    acc, lte, nc, ckpt = blend.blend_fwd_plain(b["ranges"], b["payload"], b["gw"], b["gh"])
    rng = np.random.default_rng(0)
    ct_a = torch.from_numpy(rng.standard_normal(acc.shape).astype(np.float32))
    ct_t = torch.from_numpy(rng.standard_normal(lte.shape).astype(np.float32))
    p = int(gid.max()) + 1
    k2 = blend.blend_bwd_plain(b["ranges"], b["payload"], gid, acc, nc, ckpt, ct_a, ct_t, p, b["gw"], b["gh"])
    _, _, raw, nd = _port_fwd(b, "chunk_exit", chunk)
    pair = blend_probe.blend_probe_bwd(b["ranges"], b["payload"], nd, raw, ct_a, ct_t, b["gw"], b["gh"], chunk)
    folded = torch.zeros_like(k2).index_add_(0, gid.to(torch.int64), pair.t())
    for name, rows in FIELDS.items():
        assert_scaled_close(k2[:, rows].numpy(), folded[:, rows].numpy(), GRAD_BAR, name)
