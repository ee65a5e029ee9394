"""The kernels of other checkouts of the port, timed in turns with this
tree's on one card, their outputs held against this tree's.

    python -m gsdf_slam_tpu_torch.probes.tree_turns DIR [DIR ...] [--rounds N] [--names NAME ...]

Each DIR is the root of another checkout (a directory holding
`gsdf_slam_tpu_torch/`), for example the parent commit unpacked by `git
archive` into a directory that .gitignore lists; it is imported under an
alias and builds its own kernel library into DIR/build/. Every tree runs,
through its own wrappers on the same inputs:
- on the headline binning (`kernel_probe.build_inputs`: 400,000 Gaussians
  at 1200x680, K3 of this tree): K1 `blend_fwd`, K4 `blend_fwd_export`
  (margin 10, and margin 1, where its walk is K1's), K2 `blend_bwd` and, at
  chunk 128, the probes `blend_probe_fwd` in each of its six modes,
  `blend_probe_fwd_pair2` and `blend_probe_bwd` (from this tree's
  `chunk_exit` walk);
- `expand_gather` at mp 1,048,576 (`expand_probe`'s inputs), and the
  pair-table kernels on `probes.microbench`'s inputs: `realign_copy` at MP
  1,048,576, both window gathers at P 400,000, MP 1,048,576 and (names
  ending `@393216`) at the bench's default P 262,144, MP 393,216,
  `xpose_cumsum` at MP 393,216 and 1,048,576.

Checks, each tree against this tree: K1's and K4's accum, log_t_eff and
n_contrib bit-equal to this tree's K1, their checkpoints bit-equal on the
words K2 reads, K4's keep flags equal to this tree's K4's; K2 on this
tree's K1 outputs within K2's headline bar (3e-4 scaled per field; K2 adds
with atomics, so two launches differ in rounding), the gap printed beside
this tree's K2 against itself; each forward probe mode, pair2,
`expand_gather` and the pair-table kernels bit-equal to this tree's, the
probe backward within the same 3e-4 scaled per field, its gap printed
beside this tree's against itself. Exit 1 if any check fails.

Times: graph ms (`timing.graph_ms`: 20 launches replayed from a CUDA
graph) of each kernel in turns, this tree first and then the others, then
in reverse (this, A, B, B, A, this), `--rounds` times; printed per tree
with every run, the mean, the ratio to this tree and K4/K1. Then each
tree's ptxas registers and spill bytes of every kernel, and a last line of
JSON with it all. `--names` runs only the named kernels (and their checks).
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
from pathlib import Path

import torch

from .. import kernels
from ..ops import blend_probe, pair_table, tile_blend
from . import checks, expand_probe, microbench
from .kernel_probe import build_inputs, cotangents
from .scene import N_HEADLINE
from .timing import graph_ms, require_cuda

MARGIN = 10.0
# K2's headline bar (chip_smoke.py K2_HEADLINE): atomics sum in any order
K2_BAR = 3e-4
# the pair-table and expansion sizes: the headline's Gaussians at its pair
# capacity; xpose_cumsum also at the microbench's default MP, whose input
# fits in the 50 MB L2
P_HEAD, MP_HEAD = 400_000, 1_048_576
XPOSE_MPS = (393_216, MP_HEAD)
# (name suffix, P, MP) of the window gathers: the headline and the bench's
# default size
WINDOW_SIZES = (("", P_HEAD, MP_HEAD), ("@393216", 262_144, 393_216))
WINDOW_NAMES = tuple(f"window_gather_{kind}{sfx}" for sfx, _, _ in WINDOW_SIZES for kind in ("rows", "cols"))
FWD_NAMES = tuple(f"blend_probe_fwd:{m}" for m in blend_probe.FWD_MODES)
PAIR_TABLE_NAMES = ("realign_copy", *WINDOW_NAMES, *(f"xpose_cumsum@{mp}" for mp in XPOSE_MPS))
# K4 also at margin 1, where its walk is K1's: K4/K1 there is the cost of
# the keep marks and the phase test alone
NAMES = ("blend_fwd", "blend_fwd_export", "blend_fwd_export@1", "blend_bwd", *FWD_NAMES,
         "blend_probe_fwd_pair2", "blend_probe_bwd", "expand_gather", *PAIR_TABLE_NAMES)
# kernels held bit-equal to this tree's through checks.bit_equal
BIT_EQUAL = (*FWD_NAMES, "blend_probe_fwd_pair2", "expand_gather", *PAIR_TABLE_NAMES)


def load_tree(root: Path, alias: str):
    """The port package of another checkout, imported as `alias`: (its
    kernels module, its ops.tile_blend, ops.blend_probe and ops.pair_table
    modules)."""
    pkg = root.resolve() / "gsdf_slam_tpu_torch"
    spec = importlib.util.spec_from_file_location(alias, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return tuple(importlib.import_module(f"{alias}.{m}")
                 for m in ("kernels", "ops.tile_blend", "ops.blend_probe", "ops.pair_table"))


def pair_table_inputs(dev) -> dict:
    """{name: the wrapper's arguments on the card} for the pair-table
    kernels and expand_gather."""
    put = lambda a: torch.from_numpy(a).to(dev)
    tbl, src, mpa = microbench.realign_inputs(MP_HEAD)
    out = {"realign_copy": (put(tbl), put(src), mpa)}
    for name, win, cpc in (("window_gather_rows", pair_table.WIN_ROWS, pair_table.CPC_ROWS),
                           ("window_gather_cols", pair_table.WIN_COLS, pair_table.CPC_COLS)):
        for sfx, p, mp in WINDOW_SIZES:
            out[name + sfx] = tuple(put(a) for a in microbench.window_inputs(p, mp, win, cpc))
    for mp in XPOSE_MPS:
        out[f"xpose_cumsum@{mp}"] = (put(microbench.xpose_inputs(mp)),)
    # the expansion probe's Gaussian count at this mp (expand_probe.main)
    table, _, g0, lr = (put(a) for a in expand_probe.build(MP_HEAD, MP_HEAD // 3 // 128 * 128)[:4])
    out["expand_gather"] = (table, g0, lr)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", type=Path, help="roots of other checkouts")
    ap.add_argument("--rounds", type=int, default=2, help="passes of this-others-others-this")
    ap.add_argument("--names", nargs="+", choices=NAMES, default=list(NAMES), help="kernels to run")
    args = ap.parse_args(argv)
    names = [n for n in NAMES if n in args.names]
    smi = require_cuda()
    dev = torch.device("cuda", 0)
    trees = {"this": (kernels, tile_blend, blend_probe, pair_table)}
    for i, root in enumerate(args.trees):
        trees[str(root)] = load_tree(root, f"gsdf_tree_{i}")
    for kern, *_ in trees.values():
        kern.library()

    st = build_inputs(N_HEADLINE, dev)
    ranges, payload, gid, gw, gh, p = (st[k] for k in ("ranges", "payload", "gid", "gw", "gh", "p"))
    ct_a, ct_t = cotangents(gw * gh, dev)
    pt_in = pair_table_inputs(dev)
    acc, lte, nc, ckpt = tile_blend.blend_fwd(ranges, payload, gw, gh)
    k2_args = (ranges, payload, gid, acc, nc, ckpt, ct_a, ct_t, p, gw, gh)
    single = blend_probe.blend_probe_fwd(ranges, payload, gw, gh, "chunk_exit", 128)
    pb_args = (ranges, payload, single[3], single[2], ct_a, ct_t, gw, gh, 128)

    def tree_calls(tb, bp, pt):
        calls = {
            "blend_fwd": lambda: tb.blend_fwd(ranges, payload, gw, gh),
            "blend_fwd_export": lambda: tb.blend_fwd_export(ranges, payload, gw, gh, MARGIN),
            "blend_fwd_export@1": lambda: tb.blend_fwd_export(ranges, payload, gw, gh, 1.0),
            "blend_bwd": lambda: tb.blend_bwd(*k2_args),
            "blend_probe_fwd_pair2": lambda: bp.blend_probe_fwd_pair2(ranges, payload, gw, gh, 128),
            "blend_probe_bwd": lambda: bp.blend_probe_bwd(*pb_args),
            "expand_gather": lambda: bp.expand_gather(*pt_in["expand_gather"]),
            "realign_copy": lambda: pt.realign_copy(*pt_in["realign_copy"]),
        }
        for name in WINDOW_NAMES:
            calls[name] = lambda name=name: getattr(pt, name.split("@")[0])(*pt_in[name])
        for name, mode in zip(FWD_NAMES, blend_probe.FWD_MODES):
            calls[name] = lambda mode=mode: bp.blend_probe_fwd(ranges, payload, gw, gh, mode, 128)
        for mp in XPOSE_MPS:
            calls[f"xpose_cumsum@{mp}"] = lambda mp=mp: pt.xpose_cumsum(*pt_in[f"xpose_cumsum@{mp}"])
        return calls

    calls = {name: tree_calls(*mods[1:]) for name, mods in trees.items()}
    print(f"trees: {list(trees)}; {payload.shape[1]} pairs, {gw * gh} tiles, margin {MARGIN:g}; kernels {names}; "
          f"{smi}", flush=True)

    # outputs against this tree's
    want = {n: calls["this"][n]() for n in names if n in BIT_EQUAL}
    if "blend_fwd_export" in names:
        keep = calls["this"]["blend_fwd_export"]()[-1]
    g_this = tile_blend.blend_bwd(*k2_args)
    self_gap = max(checks.scaled_errors(tile_blend.blend_bwd(*k2_args).t(), g_this.t()).values())
    pb_this = blend_probe.blend_probe_bwd(*pb_args)
    pb_self = max(checks.scaled_errors(blend_probe.blend_probe_bwd(*pb_args), pb_this).values())
    failed, result = [], {"device": smi, "trees": {}}
    for name in trees:
        c, res = calls[name], {}
        for kname in ("blend_fwd", "blend_fwd_export"):
            if kname in names:
                out = c[kname]()
                torch.cuda.synchronize()
                res[f"{kname}_bit_equal_to_k1"] = (
                    torch.equal(out[0], acc) and torch.equal(out[1], lte) and torch.equal(out[2], nc)
                    and checks.checkpoint_check(out[3], ckpt, ranges, out[2], nc)[2])
        if "blend_fwd_export" in names:
            res["keep_mismatches"] = int((c["blend_fwd_export"]()[-1] != keep).sum())
        if "blend_bwd" in names:
            res["k2_scaled_gap"] = max(checks.scaled_errors(c["blend_bwd"]().t(), g_this.t()).values())
        if "blend_probe_bwd" in names:
            res["probe_bwd_scaled_gap"] = max(checks.scaled_errors(c["blend_probe_bwd"](), pb_this).values())
        for kname, w in want.items():
            got = c[kname]()
            res[f"{kname}_bit_equal"] = (all(map(checks.bit_equal, got, w)) if isinstance(w, tuple)
                                         else checks.bit_equal(got, w))
        torch.cuda.synchronize()
        print(f"[{name}] {json.dumps(res)} (this tree's K2 against itself {self_gap:.3g}, its probe backward "
              f"{pb_self:.3g}, bar {K2_BAR:g})", flush=True)
        ok = all(v for k, v in res.items() if k.endswith("bit_equal") or k.endswith("to_k1"))
        ok = ok and res.get("keep_mismatches", 0) == 0
        ok = ok and res.get("k2_scaled_gap", 0.0) <= K2_BAR and res.get("probe_bwd_scaled_gap", 0.0) <= K2_BAR
        if not ok:
            failed.append(name)
        result["trees"][name] = res

    order = list(trees) + list(reversed(trees))
    runs = {name: {k: [] for k in names} for name in trees}
    for _ in range(args.rounds):
        for kname in names:
            for name in order:
                runs[name][kname].append(graph_ms(calls[name][kname]))
    mean = {name: {k: sum(v) / len(v) for k, v in r.items()} for name, r in runs.items()}
    for kname in names:
        for name in trees:
            print(f"[time] {kname} {name}: {mean[name][kname]:.4f} ms graph, "
                  f"{mean[name][kname] / mean['this'][kname]:.4f} of this tree's "
                  f"(runs {', '.join(f'{v:.4f}' for v in runs[name][kname])}) on {smi}", flush=True)
    for name, (kern, *_) in trees.items():
        usage = kernels.ptxas_usage(kern.build_info.get("log", ""))
        ratios = {}
        if "blend_fwd" in names and "blend_fwd_export" in names:
            ratios["k4_over_k1"] = mean[name]["blend_fwd_export"] / mean[name]["blend_fwd"]
        if "blend_fwd" in names and "blend_fwd_export@1" in names:
            ratios["k4_margin1_over_k1"] = mean[name]["blend_fwd_export@1"] / mean[name]["blend_fwd"]
        print(f"[{name}] {json.dumps(ratios)}; ptxas: {json.dumps(usage)}", flush=True)
        result["trees"][name].update(ms=mean[name], runs=runs[name], ptxas=usage, **ratios)
    print(json.dumps(result), flush=True)
    if failed:
        print(f"FAILED: outputs of {failed} differ from this tree's", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
