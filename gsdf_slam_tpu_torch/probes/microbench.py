"""Microbenchmarks of the pair-table primitives on the card.

    python -m gsdf_slam_tpu_torch.probes.microbench [--p P] [--mp MP] [name ...]

Port of benchmarks/microbench.py: the building blocks around the blend
that move the pair table (scatter-adds, gathers, sorts, searchsorted,
cumsums, the realign and the expansion), each at P Gaussians (default
262,144) and MP pair lanes (default 393,216; MPA = MP + 404 x 128 with the
group padding), on the bench's own seeded inputs. Each XLA experiment
becomes the torch op it times; the four Pallas experiments (`realign`,
`wingather`, `wingather_dg`, `expand_pallas`) call the port's kernels in
`ops/pair_table.py`, each first checked bit-equal to its plain version.
Eager torch runs every op, so no output is folded back into its input
against dead-code elimination as the JAX bench does.

Each line gives the op's mean ms over 20 calls after a warm-up, on CUDA
events, and over the same 20 calls replayed from a CUDA graph (the
device's time, without the host's cost per call), or "not captured" for an
op that a graph cannot hold. With no names every experiment runs. The
entry point needs a CUDA device and exits 1 if a kernel differs from its
plain version.
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..ops import pair_table
from ..ops.pair_table import CHUNK, CPC_COLS, CPC_ROWS, WIN_COLS, WIN_ROWS
from .checks import bit_equal
from .timing import cuda_ms, graph_ms, require_cuda

DEFAULT_P = 1 << 18
DEFAULT_MP = 3 << 17
NG = 404  # tile groups at 1200x680 / group 8 (microbench.NG)
SORT_TILES = 3226  # tiles of the sort and searchsorted keys


@dataclass
class Case:
    """One timed op: `fn()` runs it on its inputs; for a kernel, `plain()`
    runs its plain version on the same inputs."""

    label: str
    fn: Callable[[], object]
    plain: Callable[[], object] | None = None


def _mpa(mp: int) -> int:
    return mp + NG * CHUNK


def _dev(a, device, long=False):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device, torch.int64 if long else t.dtype)


def rng_arrays(p: int, mp: int, seed: int = 0):
    """microbench.rng_arrays: idx [MPA] int32 in [0, P), vals [MPA, 16] and
    table [P + 1, 16] float32."""
    r = np.random.default_rng(seed)
    idx = r.integers(0, p, _mpa(mp)).astype(np.int32)
    vals = r.standard_normal((_mpa(mp), 16)).astype(np.float32)
    table = r.standard_normal((p + 1, 16)).astype(np.float32)
    return idx, vals, table


def realign_inputs(mp: int, ng: int = NG, seed: int = 7):
    """bench_realign_dma's set-up: tbl [3, ng] int32 (src0, dst0 128-aligned,
    nch) of ng groups whose counts sum to mp - ng, src [16, mp + 128]
    float32, and mpa = mp + 128 ng."""
    r = np.random.default_rng(seed)
    src = r.standard_normal((16, mp + CHUNK)).astype(np.float32)
    counts = r.multinomial(mp - ng, np.ones(ng) / ng)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    gsizes = (counts + CHUNK - 1) // CHUNK * CHUNK
    dsts = np.concatenate([[0], np.cumsum(gsizes)[:-1]])
    nch = (counts + CHUNK - 1) // CHUNK
    return np.stack([starts, dsts, nch]).astype(np.int32), src, mp + ng * CHUNK


def window_inputs(p: int, mp: int, win: int, cpc: int, seed: int = 8):
    """bench_windowed_gather(_dg)'s set-up: dense monotone ranks [mp] (a
    visible ordinal, < P), the 128-aligned window start of each cpc-lane
    chunk ws [mp / cpc] and table [16, P + win] float32."""
    if mp % cpc:
        raise ValueError(f"mp must be a multiple of {cpc}, got {mp}")
    r = np.random.default_rng(seed)
    steps = r.random(mp) < (p / mp / 2)
    ranks = np.minimum(np.cumsum(steps).astype(np.int32), p - 1)
    ws = (ranks.reshape(mp // cpc, cpc)[:, 0] // 128 * 128).astype(np.int32)
    table = r.standard_normal((16, p + win)).astype(np.float32)
    return ws, table, ranks


def xpose_inputs(mp: int, seed: int = 13):
    """bench_expand_xpose_cumsum_pallas's input: [mp, 16] int32, uniform
    over all 32-bit patterns."""
    r = np.random.default_rng(seed)
    return r.integers(-(2**31), 2**31, (mp, 16)).astype(np.int64).astype(np.int32)


def _expand_inputs(p: int, mp: int, seed: int = 11):
    """microbench._expand_inputs: tiles and starts [P], a monotone rank [MP]
    and a table of random bits [P, 16] int32."""
    r = np.random.default_rng(seed)
    tiles = r.integers(0, 6, p).astype(np.int64)
    tiles = (tiles * (0.95 * mp / max(tiles.sum(), 1))).astype(np.int32)
    starts = (np.cumsum(tiles) - tiles).astype(np.int32)
    rank = np.zeros(mp, np.int32)
    pos = starts[tiles > 0]
    np.add.at(rank, pos.clip(0, mp - 1), 1)
    rank = np.maximum(np.cumsum(rank) - 1, 0).astype(np.int32)
    table_bits = r.integers(-(2**31), 2**31, (p, 16)).astype(np.int64).astype(np.int32)
    return tiles, starts, rank, table_bits


def _orderable(d):
    """float32 -> int64 in [0, 2**32) with the float's order: flip every bit
    of a negative, the sign bit of a positive. -0.0 is first made +0.0, as
    the JAX sort holds them equal."""
    bits = (d + 0.0).view(torch.int32).to(torch.int64)
    return (bits ^ ((bits >> 31) | 0x80000000)) & 0xFFFFFFFF


def sort_two_keys(tile, depth, payload):
    """A stable 2-key sort of (tile, depth) as one stable sort of the 64-bit
    key tile << 32 | the depth's orderable bits (ops/binning.py:117), then
    the payload rows [n, MP] gathered by the permutation."""
    key = (tile.to(torch.int64) << 32) | _orderable(depth)
    sorted_key, perm = torch.sort(key, stable=True)
    return sorted_key, payload[:, perm]


# ------------------------------------------------------------- experiments
def _null(p, mp, dev):
    v = _dev(rng_arrays(p, mp)[1], dev)
    return [Case("null chain [MPA,16]", lambda: v * 1.000001)]


def _backsort(p, mp, dev):
    r = np.random.default_rng(3)
    key = _dev(r.permutation(_mpa(mp)).astype(np.int32), dev)
    rows = _dev(np.stack([r.standard_normal(_mpa(mp)).astype(np.float32) for _ in range(9)]), dev)

    def op():
        k, perm = torch.sort(key)
        return k, rows[:, perm]

    return [Case("back-sort 1key+9payload [MPA]", op)]


def _fold_v2(p, mp, dev):
    r = np.random.default_rng(5)
    vals = _dev(r.standard_normal((_mpa(mp), 16)).astype(np.float32), dev)
    t = r.integers(0, 7, p).astype(np.int64)
    t = (t * (0.9 * mp / max(t.sum(), 1))).astype(np.int64)
    ends = _dev((np.cumsum(t) - 1).clip(0, _mpa(mp) - 1), dev, long=True)
    zero = torch.zeros((1, 16), device=dev)

    def op():
        return torch.diff(torch.cumsum(vals, 0)[ends], dim=0, prepend=zero)

    return [Case("fold-v2 cumsum+ends-gather+diff", op)]


def _fold_op(p, dev, idx, vals):
    return lambda: torch.zeros((p + 1, 16), device=dev).index_add_(0, idx, vals)


def _fold(p, mp, dev):
    idx, vals, _ = rng_arrays(p, mp)
    return [Case("fold index_add_ [MPA,16]->[P,16]", _fold_op(p, dev, _dev(idx, dev, True), _dev(vals, dev)))]


def _sorted_idx(p, mp, dev):
    r = np.random.default_rng(11)
    return _dev(np.sort(r.integers(0, p, _mpa(mp))), dev, long=True)


def _fold_sorted(p, mp, dev):
    vals = _dev(rng_arrays(p, mp)[1], dev)
    return [Case("fold index_add_ SORTED idx", _fold_op(p, dev, _sorted_idx(p, mp, dev), vals))]


def _segsum(p, mp, dev):
    vals = _dev(rng_arrays(p, mp)[1], dev)
    return [Case("segment sum (index_add_) sorted [MPA,16]->[P,16]",
                 _fold_op(p, dev, _sorted_idx(p, mp, dev), vals))]


def _gather_wide(p, mp, dev):
    idx, _, table = rng_arrays(p, mp)
    i, t = _dev(idx, dev, True), _dev(table, dev)
    return [Case("gather [P,16] by [MPA] random idx", lambda: t[i])]


def _gather_narrow(p, mp, dev):
    idx, _, table = rng_arrays(p, mp)
    i, t4 = _dev(idx, dev, True), _dev(table[:, :4], dev)
    return [Case("gather [P,4] by [MPA] random idx", lambda: t4[i])]


def _scatter_narrow(p, mp, dev):
    r = np.random.default_rng(2)
    pos = _dev(r.choice(mp, p, replace=False), dev, long=True)
    val = _dev(np.arange(p, dtype=np.int32), dev)
    return [Case("scatter-max [P]->[MP] narrow",
                 lambda: torch.zeros(mp, dtype=torch.int32, device=dev).scatter_reduce_(0, pos % mp, val, "amax"))]


def _monotone_positions(mp, r):
    return np.sort(r.choice(_mpa(mp), mp, replace=False))


def _scatter_wide_mp(p, mp, dev):
    r = np.random.default_rng(12)
    pos = _dev(_monotone_positions(mp, r), dev, long=True)
    src = _dev(r.standard_normal((mp, 16)).astype(np.float32), dev)

    def op():
        out = torch.zeros((_mpa(mp), 16), device=dev)
        out[pos] = src
        return out

    return [Case("scatter-set [MP,16]->[MPA,16] monotone", op)]


def _scatter_narrow_mp(p, mp, dev):
    r = np.random.default_rng(12)
    pos = _dev(_monotone_positions(mp, r), dev, long=True)
    src = _dev(r.integers(0, p, mp).astype(np.int32), dev)

    def op():
        out = torch.full((_mpa(mp),), p, dtype=torch.int32, device=dev)
        out[pos] = src
        return out

    return [Case("scatter-set [MP]->[MPA] narrow monotone", op)]


def _cummax(p, mp, dev):
    x = _dev(np.random.default_rng(3).integers(0, p, mp).astype(np.int32), dev)
    return [Case("cummax [MP] int32", lambda: torch.cummax(x, 0).values)]


def _sorts(p, mp, dev):
    cases = []
    for n_payload, ops in ((1, 3), (6, 8), (14, 16)):
        r = np.random.default_rng(4)
        keys = _dev(r.integers(0, SORT_TILES, mp).astype(np.int32), dev)
        d = r.standard_normal(mp).astype(np.float32)
        cols = [r.standard_normal(mp).astype(np.float32) for _ in range(n_payload)]
        depth, payload = _dev(d, dev), _dev(np.stack([d, *cols]), dev)
        cases.append(Case(f"2-key stable sort, {ops} ops [MP]",
                          lambda k=keys, dp=depth, pl=payload: sort_two_keys(k % SORT_TILES, dp, pl)))
    return cases


def _realign(p, mp, dev):
    tbl, src, mpa = realign_inputs(mp)
    tbl, src = _dev(tbl, dev), _dev(src, dev)
    return [Case(f"realign_copy kernel {NG} groups [16,MPA]", lambda: pair_table.realign_copy(tbl, src, mpa),
                 lambda: pair_table.realign_copy_plain(tbl, src, mpa))]


def _wingather(p, mp, dev):
    ws, table, ranks = (_dev(a, dev) for a in window_inputs(p, mp, WIN_ROWS, CPC_ROWS))
    args = (ws, table, ranks)
    return [Case("window_gather_rows kernel [MP,16]", lambda: pair_table.window_gather_rows(*args),
                 lambda: pair_table.window_gather_rows_plain(*args))]


def _wingather_dg(p, mp, dev):
    ws, table, ranks = (_dev(a, dev) for a in window_inputs(p, mp, WIN_COLS, CPC_COLS))
    args = (ws, table, ranks)
    return [Case("window_gather_cols kernel [16,MP]", lambda: pair_table.window_gather_cols(*args),
                 lambda: pair_table.window_gather_cols_plain(*args))]


def _searchsorted(p, mp, dev):
    r = np.random.default_rng(9)
    pt = _dev(np.sort(r.integers(0, SORT_TILES, mp)).astype(np.int32), dev)
    q = torch.arange(SORT_TILES, dtype=torch.int32, device=dev)
    return [Case(f"searchsorted {SORT_TILES} queries in [MP]", lambda: torch.searchsorted(pt, q, side="left"))]


def _cumsum_p(p, mp, dev):
    x = _dev(np.random.default_rng(10).integers(0, 4, p).astype(np.int32), dev)
    return [Case("cumsum [P] int32", lambda: torch.cumsum(x, 0, dtype=torch.int32))]


def _segment_sums(sgid_order, rows, ends_of, dev):
    """Fold-v3/v4's tail: rows [9, MPA] in gid order, prefix-summed, read
    at each Gaussian's end and differenced."""
    g = rows[:, sgid_order].t()
    zero = torch.zeros((1, 9), device=dev)
    cs = torch.cat([zero, torch.cumsum(g, 0)])
    return torch.diff(cs[ends_of], dim=0, prepend=zero)


def _fold_v3(p, mp, dev):
    r = np.random.default_rng(7)
    gid = np.sort(r.integers(0, p, _mpa(mp))).astype(np.int32)
    gid = _dev(gid[r.permutation(_mpa(mp))], dev)
    rows = _dev(np.stack([r.standard_normal(_mpa(mp)).astype(np.float32) for _ in range(9)]), dev)
    q = torch.arange(p, dtype=torch.int32, device=dev)

    def op():
        sgid, order = torch.sort(gid)
        return _segment_sums(order, rows, torch.searchsorted(sgid, q, right=True), dev)

    return [Case("fold-v3 sort+cumsum+searchsorted+diff", op)]


def _searchsorted_p(p, mp, dev):
    r = np.random.default_rng(7)
    sgid = _dev(np.sort(r.integers(0, p, _mpa(mp))).astype(np.int32), dev)
    q = torch.arange(p, dtype=torch.int32, device=dev)
    return [Case("searchsorted P-into-MPA", lambda: torch.searchsorted(sgid, q, right=True))]


def _fold_v4(p, mp, dev):
    r = np.random.default_rng(7)
    mpa = _mpa(mp)
    gc = r.integers(0, 2 * mp // NG, NG).astype(np.int64)
    gc = (gc * (0.9 * mp / max(gc.sum(), 1))).astype(np.int32)
    gs = ((gc + CHUNK - 1) // CHUNK * CHUNK).astype(np.int32)
    gstarts = (np.cumsum(gs) - gs).astype(np.int32)
    gid = _dev(r.integers(0, p, mpa).astype(np.int32), dev)
    rows = _dev(np.stack([r.standard_normal(mpa).astype(np.float32) for _ in range(9)]), dev)
    kc = r.integers(0, 5, p).astype(np.int64)
    kc = (kc * (0.9 * mp / max(kc.sum(), 1))).astype(np.int32)
    ends = _dev(np.cumsum(kc).clip(0, mpa), dev, long=True)
    g_start, g_end = _dev(gstarts, dev, True), _dev(gstarts + gc, dev, True)
    ones = torch.ones(NG, dtype=torch.int32, device=dev)

    def op():
        bnd = torch.zeros(mpa + 1, dtype=torch.int32, device=dev)
        bnd.index_add_(0, g_end, ones).index_add_(0, g_start, -ones)
        lvl = torch.cumsum(bnd[:mpa], 0, dtype=torch.int32)
        masked = torch.where(lvl == -1, gid, 0x7FFFFF00)
        _, order = torch.sort(masked)
        return _segment_sums(order, rows, ends, dev)

    return [Case("fold-v4 mask+sort+cumsum+analytic-ends", op)]


def _expand_table(p, mp, dev):
    _, _, rank, table = _expand_inputs(p, mp)
    return _dev(table, dev).view(torch.float32), _dev(rank, dev, long=True)


def _expand_gather(p, mp, dev):
    tf, rank = _expand_table(p, mp, dev)
    return [Case("expand row-gather [P,16]->[MP,16]", lambda: tf[rank])]


def _expand_fused(p, mp, dev):
    tf, rank = _expand_table(p, mp, dev)
    return [Case("expand gather into [16,MP] (one index op)", lambda: tf.t()[:, rank])]


def _expand_split(p, mp, dev):
    tf, rank = _expand_table(p, mp, dev)
    return [Case("expand gather, then transpose copy", lambda: tf[rank].t().contiguous())]


def _expand_transpose(p, mp, dev):
    x = _dev(np.random.default_rng(12).standard_normal((mp, 16)).astype(np.float32), dev)
    return [Case("expand transpose [MP,16]->[16,MP]", lambda: x.t().contiguous())]


def _expand_scatter(p, mp, dev):
    _, starts, _, table = _expand_inputs(p, mp)
    delta = np.diff(table.astype(np.int64), axis=0, prepend=0)
    delta = _dev(((delta + 2**31) % 2**32 - 2**31).astype(np.int32), dev)
    # scatter mode "drop": a start at or past MP lands in a spare row
    at = _dev(np.minimum(starts, mp), dev, long=True)
    return [Case("expand delta-scatter [P,16]-rows->[MP,16]",
                 lambda: torch.zeros((mp + 1, 16), dtype=torch.int32, device=dev).index_add_(0, at, delta)[:mp])]


def _expand_cumsum(p, mp, dev):
    x = _dev(xpose_inputs(mp), dev)
    return [Case("expand int32 cumsum [MP,16] axis0", lambda: torch.cumsum(x, 0, dtype=torch.int32))]


def _expand_pallas(p, mp, dev):
    x = _dev(xpose_inputs(mp), dev)
    return [Case("xpose_cumsum kernel [MP,16]->[16,MP]", lambda: pair_table.xpose_cumsum(x),
                 lambda: pair_table.xpose_cumsum_plain(x))]


# the names and order of microbench.ALL
EXPERIMENTS = {
    "null": _null,
    "backsort": _backsort,
    "fold_v2": _fold_v2,
    "fold": _fold,
    "fold_sorted": _fold_sorted,
    "segsum": _segsum,
    "gather_wide": _gather_wide,
    "gather_narrow": _gather_narrow,
    "scatter_narrow": _scatter_narrow,
    "scatter_wide_mp": _scatter_wide_mp,
    "scatter_narrow_mp": _scatter_narrow_mp,
    "cummax": _cummax,
    "sorts": _sorts,
    "realign": _realign,
    "wingather": _wingather,
    "wingather_dg": _wingather_dg,
    "searchsorted": _searchsorted,
    "cumsum_p": _cumsum_p,
    "fold_v3": _fold_v3,
    "searchsorted_p": _searchsorted_p,
    "fold_v4": _fold_v4,
    "expand_gather": _expand_gather,
    "expand_transpose": _expand_transpose,
    "expand_scatter": _expand_scatter,
    "expand_cumsum": _expand_cumsum,
    "expand_pallas": _expand_pallas,
    "expand_fused": _expand_fused,
    "expand_split": _expand_split,
}


def build(name: str, p: int, mp: int, device) -> list[Case]:
    """Experiment `name`'s inputs on `device` and its timed ops."""
    return EXPERIMENTS[name](p, mp, torch.device(device))


def _graph_ms_or_none(fn):
    try:
        return graph_ms(fn)
    except RuntimeError:  # the op synchronises or otherwise cannot be captured
        torch.cuda.synchronize()
        return None


def main(argv=None) -> dict:
    """Run the named experiments (all without names) on the card; print one
    line per op; return {label: {"ms", "graph_ms", "bit_equal"}}, with
    "bit_equal" for the four kernels only."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", help=f"any of {', '.join(EXPERIMENTS)}")
    ap.add_argument("--p", type=int, default=DEFAULT_P, help="Gaussians")
    ap.add_argument("--mp", type=int, default=DEFAULT_MP, help="pair lanes (a multiple of 2048)")
    args = ap.parse_args(argv)
    unknown = set(args.names) - set(EXPERIMENTS)
    if unknown:
        ap.error(f"unknown experiments {sorted(unknown)}")
    smi = require_cuda()
    dev = torch.device("cuda", 0)
    print(f"--- microbench p={args.p} mp={args.mp} mpa={_mpa(args.mp)} on {smi}: ms/op on CUDA events, "
          f"and replayed from a CUDA graph ---", flush=True)
    results = {}
    for name in args.names or EXPERIMENTS:
        for case in build(name, args.p, args.mp, dev):
            res = {}
            if case.plain is not None:
                res["bit_equal"] = bit_equal(case.fn(), case.plain())
            res["ms"] = cuda_ms(case.fn)
            res["graph_ms"] = _graph_ms_or_none(case.fn)
            graph = "not captured" if res["graph_ms"] is None else f"{res['graph_ms']:10.4f}"
            check = "" if case.plain is None else f"  bit-equal to its plain version: {res['bit_equal']}"
            print(f"{name:18s} {case.label:48s} {res['ms']:10.4f} {graph}{check}", flush=True)
            results[case.label] = res
    return results


if __name__ == "__main__":
    res = main(sys.argv[1:])
    sys.exit(0 if all(r.get("bit_equal", True) for r in res.values()) else 1)
