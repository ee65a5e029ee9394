"""Shared inputs for the port's parity tests (tests/test_torch_*.py).

Scenes are built with numpy from a seed and handed to both packages: the
JAX package (the reference) and `gsdf_slam_tpu_torch` (the port).
"""

import numpy as np
import torch

torch.set_num_threads(2)  # six test workers share the machine


def scene_arrays(p=96, seed=1, opacity_max=0.95, spread=2.0):
    """`tests/test_render.py::make_scene`'s recipe as numpy arrays: a
    64x64 view at the origin looking down +z, 90-degree FoV. The last three
    Gaussians are dead slots for the JAX package; the port gets the live
    prefix only."""
    rng = np.random.default_rng(seed)
    means = np.stack(
        [rng.uniform(-spread, spread, p), rng.uniform(-spread, spread, p), rng.uniform(2.0, 6.0, p)],
        axis=-1,
    ).astype(np.float32)
    means[0, 2] = -1.0
    means[1, 2] = 0.1
    scales = np.exp(rng.uniform(-2.5, -0.5, (p, 3))).astype(np.float32)
    quats = rng.normal(size=(p, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rng.uniform(0.2, opacity_max, p).astype(np.float32)
    dc = rng.uniform(-1.0, 1.0, (p, 1, 3)).astype(np.float32)
    sh_rest = (0.1 * rng.normal(size=(p, 15, 3))).astype(np.float32)
    alive = np.ones(p, bool)
    alive[-3:] = False
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    return dict(means=means, scales=scales, quats=quats, opac=opac, dc=dc, sh_rest=sh_rest, alive=alive, bg=bg)


FOV = np.pi / 2
POSE = (np.array([1.0, 0, 0, 0]), np.zeros(3))


def jax_camera():
    from gsdf_slam_tpu.ops import CameraMatrices

    return CameraMatrices.from_pose(q=POSE[0], t=POSE[1], fovx=FOV, fovy=FOV)


def torch_camera():
    from gsdf_slam_tpu_torch.ops import CameraMatrices

    return CameraMatrices.from_pose(q=POSE[0], t=POSE[1], fovx=FOV, fovy=FOV, device="cpu")


def live(s, key):
    """The port's tensor for a scene field: the live prefix."""
    return torch.from_numpy(s[key][: int(s["alive"].sum())].copy())


def jax_args(s):
    import jax.numpy as jnp

    return tuple(jnp.asarray(s[k]) for k in ("means", "scales", "quats", "opac", "dc", "sh_rest", "alive"))


def torch_args(s):
    return tuple(live(s, k) for k in ("means", "scales", "quats", "opac", "dc", "sh_rest"))


def assert_scaled_close(a, b, atol, name=""):
    """|a - b| / max|a| <= atol (the gradient bar of tests/test_pallas_blend.py)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    scale = max(float(np.abs(a).max()), 1e-4)
    err = float(np.abs(a - b).max()) / scale
    assert err <= atol, f"{name}: scaled error {err:.3g} > {atol}"


def synthetic_binning(counts, grid_w, seed=0, opacity=(0.05, 0.3), sigma=(1.0, 2.5)):
    """A binning built directly, tile by tile, in the port's layout: tile t
    holds counts[t] small Gaussians (standard deviations in `sigma` pixels,
    opacity uniform in `opacity`) centred in or near the tile, with more
    pairs than Gaussians so that several pairs fold into one Gaussian.
    Returns ranges [T, 2] int32, payload [9, M] float32 (mean x, y; conic
    a, b, c; opacity; rgb), gid [M] int32 and the Gaussian count."""
    rng = np.random.default_rng(seed)
    counts = np.asarray(counts, np.int64)
    m = int(counts.sum())
    ends = np.cumsum(counts)
    tile = np.repeat(np.arange(len(counts)), counts)
    mx = (tile % grid_w) * 16 + rng.uniform(-2.0, 18.0, m)
    my = (tile // grid_w) * 16 + rng.uniform(-2.0, 18.0, m)
    s1, s2 = rng.uniform(*sigma, (2, m))
    th = rng.uniform(0.0, np.pi, m)
    cos, sin = np.cos(th), np.sin(th)
    cxx = cos**2 * s1**2 + sin**2 * s2**2
    cyy = sin**2 * s1**2 + cos**2 * s2**2
    cxy = cos * sin * (s1**2 - s2**2)
    det = cxx * cyy - cxy**2
    payload = np.stack([
        mx, my, cyy / det, -cxy / det, cxx / det, rng.uniform(*opacity, m), *rng.uniform(0.0, 1.0, (3, m)),
    ]).astype(np.float32)
    p = max(m // 2, 1)
    ranges = np.stack([ends - counts, ends], 1).astype(np.int32)
    gid = rng.integers(0, p, m).astype(np.int32)
    return torch.from_numpy(ranges), torch.from_numpy(payload), torch.from_numpy(gid), p


# K4's walk across batches, one tile each (synthetic_binning keywords):
# "switch", 600 faint wide Gaussians, whose pixels pass T = 1e-4 inside the
# first 256-pair batch and the relaxed exit of margin 10 in the second;
# "early_exit", 800 opaque wide Gaussians, which every pixel has passed
# within the first batch, so the block exits with three batches unwalked.
EXPORT_BINNINGS = {
    "switch": dict(counts=(600,), opacity=(0.035, 0.045), sigma=(30.0, 40.0)),
    "early_exit": dict(counts=(800,), opacity=(0.9, 0.99), sigma=(30.0, 40.0)),
}


def export_binning(name):
    """synthetic_binning of an EXPORT_BINNINGS entry, on a 1x1 tile grid."""
    kw = dict(EXPORT_BINNINGS[name])
    return synthetic_binning(kw.pop("counts"), 1, **kw)


def pair2_binning():
    """Three one-tile binnings side by side on a 3x1 tile grid, for the lock
    step of blend_probe_fwd_pair2: tile 0 is EXPORT_BINNINGS' `early_exit`
    (every pixel done within a few dozen pairs, so its chunk exit fires
    first), tile 1 `switch` (its partner, which walks on after tile 0 is
    done) and tile 2 a lone tile of 33 pairs, which has no partner. Returns
    ranges [3, 2] int32 and payload [9, M] float32."""
    parts = [export_binning("early_exit"), export_binning("switch"), synthetic_binning((33,), 1, seed=3)]
    ranges, payloads, n = [], [], 0
    for t, (_, pl, _, _) in enumerate(parts):
        pl = pl.clone()
        pl[0] += 16 * t  # into tile t of the row
        ranges.append([n, n + pl.shape[1]])
        payloads.append(pl)
        n += pl.shape[1]
    return torch.tensor(ranges, dtype=torch.int32), torch.cat(payloads, 1)


# Edge cases of the window gathers (window_edge_case), each at the rows
# layout's window and chunk unless it names its own:
# "outside", one chunk whose window starts past all its lanes' ranks;
# "bad_ranks", negative ranks and ranks >= lanes inside their windows, and
#   the int32 extremes;
# "special", a table holding -0.0, +-inf, NaNs of several payloads
#   (signalling included) and denormals at the gathered lanes;
# "odd_lanes", a table whose lane count is odd;
# "ragged", MP 480 in 96-lane chunks with a 128-lane window: MP is not a
#   multiple of a 256-lane block, and some lanes leave their window.
WINDOW_EDGE_CASES = ("outside", "bad_ranks", "special", "odd_lanes", "ragged")


def window_edge_case(name):
    """(ws, table, ranks, win, cpc) numpy inputs of a WINDOW_EDGE_CASES entry."""
    from gsdf_slam_tpu_torch.ops import pair_table
    from gsdf_slam_tpu_torch.probes import microbench

    win, cpc = pair_table.WIN_ROWS, pair_table.CPC_ROWS
    if name == "ragged":
        win, cpc = 128, 96
        return (*microbench.window_inputs(300, 480, win, cpc), win, cpc)
    ws, table, ranks = microbench.window_inputs(2048, 8192, win, cpc)
    lanes = table.shape[1]
    if name == "outside":
        ws[1] += 5000
    elif name == "bad_ranks":
        ws[0] = -256
        ranks[:300:3] = -np.arange(1, 101)
        ws[-1] = lanes - 128
        ranks[-1024::5] = lanes + np.arange(205)
        ranks[5], ranks[-7] = -(2**31), 2**31 - 1
    elif name == "special":
        bits = table.view(np.uint32)
        table[:, ::3] = -0.0
        table[::2, 1::5] = np.inf
        table[1::2, 1::5] = -np.inf
        for k, pattern in enumerate((0x7FC00000, 0xFFC00001, 0x7F800001, 0x00000001, 0x807FFFFF)):
            bits[k::5, 2::7] = pattern
    elif name == "odd_lanes":
        table = np.ascontiguousarray(table[:, : lanes - 1])
        assert table.shape[1] % 2 == 1
    else:
        raise ValueError(name)
    return ws, table, ranks, win, cpc


def window_gather_reference(ws, table, ranks, win, cpc, fill):
    """table[:, ranks] as [16, MP] numpy where a lane's rank lies in its
    chunk's window and in the table, else `fill`: one lane at a time."""
    out = np.full((table.shape[0], len(ranks)), fill, np.float32)
    for i, r in enumerate(ranks.astype(np.int64)):
        if 0 <= r - ws[i // cpc] < win and 0 <= r < table.shape[1]:
            out[:, i] = table[:, r]
    return out
