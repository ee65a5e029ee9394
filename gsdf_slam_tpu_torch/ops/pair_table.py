"""Pair-table kernels of the microbenchmarks, with their plain versions.

Port of the four Pallas kernels of `benchmarks/microbench.py`, each of
which moves the `[16, lanes]` pair table the blend reads:

- `realign_copy` (`bench_realign_dma`, body `_realign_kernel2`): group
  runs of sorted pairs copied to chunk-aligned starts;
- `window_gather_rows` (`bench_windowed_gather`, body `_wingather_kernel`)
  and `window_gather_cols` (`bench_windowed_gather_dg`, body
  `_wingather_dg_kernel`): `table[:, ranks]` for a dense monotone rank,
  read through a window per chunk of output lanes, written as [MP, 16] or
  [16, MP];
- `xpose_cumsum` (`bench_expand_xpose_cumsum_pallas`, body
  `_xpose_cumsum_kernel`): the inclusive int32 cumsum of [MP, 16] along
  MP, modulo 2**32, written transposed as [16, MP].

The kernels are in `csrc/pair_table.cu`. All four move 32-bit words or add
integers, so each kernel is bit-equal to its plain version. On a CPU tensor
each wrapper takes its plain version; on a CUDA tensor it launches its
kernel or raises.
"""

from __future__ import annotations

import torch

from .. import kernels

FIELDS = 16  # rows of the pair table
CHUNK = 128  # lanes per realign chunk (microbench.CHUNK)
WIN_ROWS, CPC_ROWS = 1152, 1024  # window and chunk of `bench_windowed_gather`
WIN_COLS, CPC_COLS = 2176, 2048  # of `bench_windowed_gather_dg`
XPOSE_BLOCK = 512  # lanes per block of the xpose_cumsum kernel (csrc/pair_table.cu kXBlk)


def realign_copy_plain(tbl, src, mpa: int):
    """Plain version of `realign_copy`: one scatter of every group's lanes."""
    dev = src.device
    lanes = src.shape[1]
    src0, dst0, nch = tbl.to(torch.int64)
    n = nch.clamp_min(0) * CHUNK
    total = int(n.sum())
    g = torch.repeat_interleave(torch.arange(tbl.shape[1], device=dev), n, output_size=total)
    k = torch.arange(total, device=dev) - (torch.cumsum(n, 0) - n)[g]
    s = src0[g] + k
    d = dst0[g] + k
    vals = torch.where((s >= 0) & (s < lanes), src[:, s.clamp(0, max(lanes - 1, 0))], 0.0)
    out = torch.zeros((FIELDS, mpa), dtype=torch.float32, device=dev)
    keep = (d >= 0) & (d < mpa)
    out[:, d[keep]] = vals[:, keep]
    return out


def realign_copy(tbl, src, mpa: int):
    """dst [16, mpa] float32 with dst[:, dst0[g] + k] = src[:, src0[g] + k]
    for every group g and k < 128 nch[g], from tbl [3, NG] int32 (rows
    src0, dst0, nch) and src [16, L] float32; a source lane outside [0, L)
    reads 0, and a lane that no group covers is 0 (the TPU leaves it
    unwritten). dst0 must be multiples of 128, ascending, with each group's
    lanes ending at or before the next group's dst0, as the TPU's group
    layout is; the kernel reads each output chunk from the last group whose
    dst0 is at or before it. Replaces `bench_realign_dma` of
    benchmarks/microbench.py."""
    if kernels.runs_plain(src):
        return realign_copy_plain(tbl, src, mpa)
    kernels.library()  # builds on first use; raises where it cannot
    dev = src.device
    if mpa % 4:
        raise ValueError(f"mpa must be a multiple of 4, got {mpa}")
    kernels.check("tbl", tbl, torch.int32, (3, -1), dev)
    kernels.check("src", src, torch.float32, (FIELDS, -1), dev)
    out = torch.empty((FIELDS, mpa), dtype=torch.float32, device=dev)
    kernels.LAUNCHES["realign_copy"] += 1
    kernels.launch("gsdf_realign_copy", tbl.data_ptr(), tbl.shape[1], src.data_ptr(), src.shape[1],
                   mpa, out.data_ptr())
    return out


def _window_gather_plain(ws, table, ranks, win: int, cpc: int, fill: float):
    """table[:, ranks] [16, MP] where lane i's rank lies in its chunk's
    window [ws[i // cpc], ws[i // cpc] + win) and in the table; else fill."""
    r = ranks.to(torch.int64)
    local = r - ws.to(torch.int64).repeat_interleave(cpc)
    inside = (local >= 0) & (local < win) & (r >= 0) & (r < table.shape[1])
    vals = table[:, torch.where(inside, r, 0)]
    return torch.where(inside, vals, fill)


def window_gather_rows_plain(ws, table, ranks, win: int = WIN_ROWS, cpc: int = CPC_ROWS):
    """Plain version of `window_gather_rows`."""
    return _window_gather_plain(ws, table, ranks, win, cpc, 0.0).t().contiguous()


def window_gather_cols_plain(ws, table, ranks, win: int = WIN_COLS, cpc: int = CPC_COLS):
    """Plain version of `window_gather_cols`."""
    return _window_gather_plain(ws, table, ranks, win, cpc, float("nan"))


def _window_gather(name, entry, ws, table, ranks, win, cpc, rows):
    kernels.library()  # builds on first use; raises where it cannot
    dev = table.device
    mp = ranks.shape[0]
    if win <= 0 or cpc <= 0 or mp % cpc:
        raise ValueError(f"ranks: length must be a multiple of cpc {cpc} (win {win}), got {mp}")
    kernels.check("ws", ws, torch.int32, (mp // cpc,), dev)
    kernels.check("table", table, torch.float32, (FIELDS, -1), dev)
    kernels.check("ranks", ranks, torch.int32, (mp,), dev)
    out = torch.empty((mp, FIELDS) if rows else (FIELDS, mp), dtype=torch.float32, device=dev)
    kernels.LAUNCHES[name] += 1
    kernels.launch(entry, ws.data_ptr(), table.data_ptr(), table.shape[1], ranks.data_ptr(), mp,
                   win, cpc, out.data_ptr())
    return out


def window_gather_rows(ws, table, ranks, win: int = WIN_ROWS, cpc: int = CPC_ROWS):
    """out [MP, 16] float32 with out[i] = table[:, ranks[i]] where 0 <=
    ranks[i] - ws[i // cpc] < win (and the rank lies in the table), else 0,
    as the TPU's one-hot product gives, for table [16, lanes] float32, ws
    [MP / cpc] and ranks [MP] int32. The copy keeps every bit; the TPU's
    product turns -0.0 into +0.0 and spreads a NaN or inf of the window.
    Replaces `bench_windowed_gather` of benchmarks/microbench.py."""
    if kernels.runs_plain(table):
        return window_gather_rows_plain(ws, table, ranks, win, cpc)
    return _window_gather("window_gather_rows", "gsdf_window_gather_rows", ws, table, ranks, win, cpc, True)


def window_gather_cols(ws, table, ranks, win: int = WIN_COLS, cpc: int = CPC_COLS):
    """out [16, MP] float32 with out[:, i] = table[:, ranks[i]] inside the
    window as in `window_gather_rows`, and NaN (bits 0x7fc00000) outside,
    where the TPU's `take_along_axis` is undefined. Replaces
    `bench_windowed_gather_dg` of benchmarks/microbench.py."""
    if kernels.runs_plain(table):
        return window_gather_cols_plain(ws, table, ranks, win, cpc)
    return _window_gather("window_gather_cols", "gsdf_window_gather_cols", ws, table, ranks, win, cpc, False)


def xpose_cumsum_plain(x):
    """Plain version of `xpose_cumsum`: the sum in int64, wrapped to int32."""
    s = torch.cumsum(x.to(torch.int64), 0) & 0xFFFFFFFF
    return torch.where(s >= 2**31, s - 2**32, s).to(torch.int32).t().contiguous()


def xpose_cumsum(x):
    """out [16, MP] int32 with out[f, i] = sum of x[j, f] over j <= i,
    modulo 2**32, for x [MP, 16] int32. Replaces
    `bench_expand_xpose_cumsum_pallas` of benchmarks/microbench.py."""
    if kernels.runs_plain(x):
        return xpose_cumsum_plain(x)
    kernels.library()  # builds on first use; raises where it cannot
    dev = x.device
    kernels.check("x", x, torch.int32, (-1, FIELDS), dev)
    if x.data_ptr() % 16:
        raise ValueError("x: the kernel reads 16-byte words; its data must be 16-byte aligned")
    mp = x.shape[0]
    nb = -(-mp // XPOSE_BLOCK)
    out = torch.empty((FIELDS, mp), dtype=torch.int32, device=dev)
    totals = torch.empty((max(nb, 1), FIELDS), dtype=torch.int32, device=dev)  # scratch
    kernels.LAUNCHES["xpose_cumsum"] += 1
    kernels.launch("gsdf_xpose_cumsum", x.data_ptr(), mp, totals.data_ptr(), out.data_ptr())
    return out
