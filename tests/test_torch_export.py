"""K4's walk, on the CPU: `ops/blend.py::export_walk_counts` and the plain
keep flags against a brute-force walk of every pixel, pair by pair.

K4 (`csrc/blend_fwd_export.cu`) walks each pixel past its T = 1e-4
frontier down to the relaxed exit log(1e-4) - log(margin). The count of
that walk bounds K4 in `chip_smoke.py`; here it is held, pixel by pixel, to
a walk written out in float64 numpy: a pixel walks a pair while its raw log
T before the pair is at or above the exit, a walked live pair is kept, and
at margin 1 the walk is K1's, the frontier pair included.

Binnings: those of tests/test_torch_buckets.py (K3's binning of the
opaque 64x64 test scene, of the wall and of the saturating scene; direct
binnings with tiles of 1, 32, 33 and 300 pairs at two opacities) and the
two one-tile binnings of the card tests (`torch_port_helpers.
EXPORT_BINNINGS`): a frontier in the first 256-pair batch with the exit in
the second, and every pixel done within the first batch.
"""

import numpy as np
import pytest
import torch
from test_torch_buckets import _binned as _bucket_binned
from torch_port_helpers import EXPORT_BINNINGS, export_binning

from gsdf_slam_tpu_torch.ops import blend, tile_blend

MARGINS = (1.0, 10.0, 1e4)


def _binned(name):
    """(ranges, payload, grid_w, grid_h) of a binning."""
    if name in EXPORT_BINNINGS:
        ranges, payload, _, _ = export_binning(name)
        return ranges, payload, 1, 1
    ranges, payload, _, _, g = _bucket_binned(name)
    return ranges, payload, g, g


def _brute_walk(ranges, payload, grid_w, margin):
    """Every pixel walks its tile's pairs in order, in float64. Returns
    walked and live-walked pairs per pixel [T, 256], K1's walk per pixel
    (up to and including the frontier pair) and keep [M]."""
    r = ranges.numpy()
    pl = payload.numpy().astype(np.float64)
    log_exit = np.log(blend.T_EPS) - np.log(margin)
    pix = np.arange(256)
    walked = np.zeros((len(r), 256), np.int64)
    live_n = np.zeros_like(walked)
    k1 = np.zeros_like(walked)
    keep = np.zeros(pl.shape[1], bool)
    for t, (s, e) in enumerate(r):
        x = (t % grid_w) * 16 + pix % 16
        y = (t // grid_w) * 16 + pix // 16
        log_raw = np.zeros(256)
        for i in range(s, e):
            walking = log_raw >= log_exit
            k1[t] += log_raw >= np.log(blend.T_EPS)
            mx, my, a, b, c, op = pl[:6, i]
            dx, dy = mx - x, my - y
            power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
            alpha = np.minimum(blend.ALPHA_MAX, op * np.exp(power))
            live = (power <= 0.0) & (alpha >= blend.ALPHA_MIN)
            walked[t] += walking
            live_n[t] += walking & live
            keep[i] = (walking & live).any()
            log_raw += np.where(live, np.log1p(-alpha), 0.0)
    return walked, live_n, k1, keep


@pytest.mark.parametrize("margin", MARGINS)
@pytest.mark.parametrize("name", ["render64", "wall", "saturating", "sparse", "dense", *EXPORT_BINNINGS])
def test_walk_counts_match_brute_force(name, margin):
    ranges, payload, gw, gh = _binned(name)
    walked, live_n = blend.export_walk_counts(ranges, payload, gw, margin)
    want_walked, want_live, k1_walk, want_keep = _brute_walk(ranges, payload, gw, margin)
    np.testing.assert_array_equal(walked.numpy(), want_walked)
    np.testing.assert_array_equal(live_n.numpy(), want_live)
    # the plain keep flags: a pair is kept iff it is live in some pixel's walk
    keep = blend.blend_fwd_plain(ranges, payload, gw, gh, keep_margin=margin)[-1]
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    # at margin 1 the walk is K1's, the frontier pair included
    np.testing.assert_array_equal(blend.export_walk_counts(ranges, payload, gw, 1.0)[0].numpy(), k1_walk)
    assert (walked >= live_n).all() and (walked.numpy() >= k1_walk).all()
    if name == "switch" and margin == 10.0:
        # some pixel passes its frontier in the first batch and exits in the second
        assert ((k1_walk <= 256) & (want_walked > 256)).any()
    if name == "early_exit":
        # every pixel is done within the first batch
        assert want_walked.max() < 256


def test_walk_grows_with_the_margin():
    """The band widens with the margin: at 1e4 it runs to the tile's end at
    some pixel of the 300-pair tile, which margin 1 never reaches."""
    ranges, payload, gw, _ = _binned("dense")
    walks = [blend.export_walk_counts(ranges, payload, gw, m)[0] for m in MARGINS]
    assert all((a <= b).all() for a, b in zip(walks, walks[1:]))
    assert (walks[0] < walks[1]).any()
    count = (ranges[:, 1] - ranges[:, 0]).to(torch.int64)[:, None]
    assert (walks[-1] == count).sum() > (walks[0] == count).sum()


def test_margin_below_one_raises():
    ranges, payload, gw, gh = _binned("sparse")
    with pytest.raises(ValueError, match="margin"):
        tile_blend.blend_fwd_export(ranges, payload, gw, gh, 0.5)
