"""Port parity of the pair-table kernels: each plain version of
`gsdf_slam_tpu_torch/ops/pair_table.py` against its Pallas body in
`benchmarks/microbench.py` (loaded by path, run in interpret mode with its
bench's grid spec), on the bench's seeded inputs at small sizes. All four
move 32-bit words or add integers, so the bar is bit-equality, on the lanes
the JAX body defines: the written lanes of the realign and the in-window
lanes of `take_along_axis`. Then every experiment of
`probes.microbench` runs once on the CPU at a tiny size.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gsdf_slam_tpu_torch.ops import pair_table
from gsdf_slam_tpu_torch.probes import checks, microbench

REPO = Path(__file__).resolve().parent.parent
CHUNK = pair_table.CHUNK
# the small sizes of the parity cases
REALIGN_NG, REALIGN_MP = 6, 2048
GATHER_P, GATHER_MP = 2048, 8192
XPOSE_BLOCKS = 4
# the tiny size of the experiment runs (mp a multiple of both gathers' chunks)
TINY_P, TINY_MP = 2048, 4096


@functools.cache
def _jax_microbench():
    spec = importlib.util.spec_from_file_location("jax_microbench", REPO / "benchmarks" / "microbench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bits(a):
    return np.asarray(a).view(np.int32)


@functools.cache
def _realign_case():
    """(tbl, src, mpa, the JAX body's output) for NG 6, MP 2048."""
    mb = _jax_microbench()
    tbl, src, mpa = microbench.realign_inputs(REALIGN_MP, ng=REALIGN_NG)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(REALIGN_NG,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        scratch_shapes=[
            pltpu.VMEM((16, 2 * CHUNK), jnp.float32),
            pltpu.VMEM((16, CHUNK), jnp.float32),
            pltpu.SemaphoreType.DMA,
            pltpu.SemaphoreType.DMA,
        ],
    )
    call = pl.pallas_call(
        mb._realign_kernel2, grid_spec=grid_spec,
        out_shape=[jax.ShapeDtypeStruct((16, mpa), jnp.float32)],
        compiler_params=pltpu.CompilerParams(has_side_effects=True), interpret=True,
    )
    (out,) = call(jnp.asarray(tbl), jnp.asarray(src))
    return tbl, src, mpa, np.asarray(out)


def _written_lanes(tbl, mpa):
    written = np.zeros(mpa, bool)
    for _, d0, n in tbl.T:
        written[d0:d0 + n * CHUNK] = True
    return written


def test_realign_plain_matches_jax_on_written_lanes():
    tbl, src, mpa, want = _realign_case()
    got = pair_table.realign_copy(torch.from_numpy(tbl), torch.from_numpy(src), mpa).numpy()
    written = _written_lanes(tbl, mpa)
    assert written.sum() == (tbl[2] * CHUNK).sum() and not written.all()
    np.testing.assert_array_equal(_bits(got)[:, written], _bits(want)[:, written])
    # the lanes no group covers, which the TPU leaves unwritten, are 0
    assert not got[:, ~written].any()


def test_realign_plain_reads_zero_past_the_source():
    """A group whose last chunk runs past the end of src reads 0 there, and
    a group past mpa is dropped."""
    src = np.arange(16 * 300, dtype=np.float32).reshape(16, 300) + 1.0
    tbl = np.array([[250, 0, 1], [40, 128, 1], [0, 512, 1]], np.int32).T  # src0, dst0, nch rows
    got = pair_table.realign_copy(torch.from_numpy(np.ascontiguousarray(tbl)), torch.from_numpy(src), 384).numpy()
    np.testing.assert_array_equal(got[:, :50], src[:, 250:300])
    assert not got[:, 50:128].any()
    np.testing.assert_array_equal(got[:, 128:256], src[:, 40:168])
    assert not got[:, 256:].any()


def _window_call(body, win, cpc, nchunks, out_spec, out_shape):
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(nchunks,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY), pl.BlockSpec((cpc,), lambda i, ws: (i,))],
        out_specs=out_spec,
        scratch_shapes=[pltpu.VMEM((16, win), jnp.float32), pltpu.SemaphoreType.DMA],
    )
    return pl.pallas_call(functools.partial(body, win=win, cpc=cpc), grid_spec=grid_spec,
                          out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32), interpret=True)


def test_window_gather_rows_plain_matches_jax():
    mb = _jax_microbench()
    win, cpc = pair_table.WIN_ROWS, pair_table.CPC_ROWS
    ws, table, ranks = microbench.window_inputs(GATHER_P, GATHER_MP, win, cpc)
    n = GATHER_MP // cpc
    call = _window_call(mb._wingather_kernel, win, cpc, n, pl.BlockSpec((cpc, 16), lambda i, ws: (i, 0)),
                        (GATHER_MP, 16))
    want = np.asarray(call(jnp.asarray(ws), jnp.asarray(table), jnp.asarray(ranks)))
    got = pair_table.window_gather_rows(*(torch.from_numpy(a) for a in (ws, table, ranks))).numpy()
    assert got.shape == (GATHER_MP, 16)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(got, table[:, ranks].T)


def test_window_gather_cols_plain_matches_jax_in_the_window():
    mb = _jax_microbench()
    win, cpc = pair_table.WIN_COLS, pair_table.CPC_COLS
    ws, table, ranks = microbench.window_inputs(GATHER_P, GATHER_MP, win, cpc)
    n = GATHER_MP // cpc
    call = _window_call(mb._wingather_dg_kernel, win, cpc, n, pl.BlockSpec((16, cpc), lambda i, ws: (0, i)),
                        (16, GATHER_MP))
    want = np.asarray(call(jnp.asarray(ws), jnp.asarray(table), jnp.asarray(ranks)))
    got = pair_table.window_gather_cols(*(torch.from_numpy(a) for a in (ws, table, ranks))).numpy()
    local = ranks - np.repeat(ws, cpc)
    inside = (local >= 0) & (local < win)
    assert inside.all()  # dense monotone ranks: every chunk spans under cpc ranks
    np.testing.assert_array_equal(_bits(got)[:, inside], _bits(want)[:, inside])


def test_window_gathers_outside_the_window():
    """Out of its chunk's window (or past the table) a lane gets 0 in the
    rows layout, as the one-hot product gives, and NaN in the cols layout."""
    table = torch.arange(16 * 40, dtype=torch.float32).reshape(16, 40)
    ws = torch.tensor([0, 20], dtype=torch.int32)
    ranks = torch.tensor([0, 7, 8, -1, 20, 27, 28, 45], dtype=torch.int32)
    rows = pair_table.window_gather_rows(ws, table, ranks, win=8, cpc=4)
    cols = pair_table.window_gather_cols(ws, table, ranks, win=8, cpc=4)
    inside = torch.tensor([1, 1, 0, 0, 1, 1, 0, 0], dtype=torch.bool)
    r = ranks.clamp(0, 39).long()
    torch.testing.assert_close(rows[inside], table[:, r[inside]].t(), rtol=0, atol=0)
    assert not rows[~inside].any()
    torch.testing.assert_close(cols[:, inside], table[:, r[inside]], rtol=0, atol=0)
    assert torch.isnan(cols[:, ~inside]).all()
    assert (cols[:, ~inside].view(torch.int32) == 0x7FC00000).all()


def test_xpose_cumsum_plain_matches_jax():
    mb = _jax_microbench()
    blk = mb.XP_BLK
    mp = XPOSE_BLOCKS * blk
    x = microbench.xpose_inputs(mp)
    call = pl.pallas_call(
        mb._xpose_cumsum_kernel, grid=(XPOSE_BLOCKS,),
        in_specs=[pl.BlockSpec((blk, 16), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((16, blk), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((16, mp), jnp.int32),
        scratch_shapes=[pltpu.VMEM((16, 128), jnp.int32)], interpret=True,
    )
    want = np.asarray(call(jnp.asarray(x)))
    got = pair_table.xpose_cumsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    exact = np.cumsum(x.astype(np.int64), axis=0).T
    np.testing.assert_array_equal(got, ((exact + 2**31) % 2**32 - 2**31).astype(np.int32))


def test_sorts_key_orders_as_the_two_key_sort():
    """`sorts`'s one 64-bit key orders (tile, depth) as the JAX bench's
    2-key stable sort, negative and zero depths included."""
    r = np.random.default_rng(4)
    tile = r.integers(0, 5, 4000).astype(np.int32)
    depth = r.standard_normal(4000).astype(np.float32)
    depth[:10] = 0.0
    depth[10:20] = -0.0
    depth[20:40] = depth[40:60]  # ties keep their order
    payload = np.stack([depth, np.arange(4000, dtype=np.float32)])
    _, got = microbench.sort_two_keys(torch.from_numpy(tile), torch.from_numpy(depth), torch.from_numpy(payload))
    (_, d_sorted, idx_sorted) = jax.lax.sort(
        (jnp.asarray(tile), jnp.asarray(depth), jnp.arange(4000, dtype=jnp.float32)), num_keys=2, is_stable=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(idx_sorted))
    np.testing.assert_array_equal(_bits(got[0].numpy()), _bits(d_sorted))


@pytest.mark.parametrize("name", list(microbench.EXPERIMENTS))
def test_experiment_runs_on_cpu(name):
    """Every experiment of the entry point builds and runs once on the CPU;
    each kernel's wrapper is bit-equal to its plain version."""
    cases = microbench.build(name, TINY_P, TINY_MP, "cpu")
    assert cases
    for case in cases:
        out = case.fn()
        for t in out if isinstance(out, tuple) else (out,):
            assert t.device.type == "cpu" and t.numel() > 0
        if case.plain is not None:
            assert checks.bit_equal(out, case.plain()), case.label


def test_experiments_are_those_of_the_jax_bench():
    assert list(microbench.EXPERIMENTS) == list(_jax_microbench().ALL)
