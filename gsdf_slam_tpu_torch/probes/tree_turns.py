"""The blend kernels of other checkouts of the port, timed in turns with
this tree's on one card, their outputs held against this tree's.

    python -m gsdf_slam_tpu_torch.probes.tree_turns DIR [DIR ...] [--rounds N]

Each DIR is the root of another checkout (a directory holding
`gsdf_slam_tpu_torch/`), for example the parent commit unpacked by `git
archive` into a directory that .gitignore lists; it is imported under an
alias and builds its own kernel library into DIR/build/. On the headline
binning (`kernel_probe.build_inputs`: 400,000 Gaussians at 1200x680, K3
of this tree) every tree runs K1 `blend_fwd`, K4 `blend_fwd_export`
(margin 10, and margin 1, where its walk is K1's), K2 `blend_bwd` and,
at chunk 128, the probes `blend_probe_fwd` (`chunk_exit`),
`blend_probe_fwd_pair2` and `blend_probe_bwd` (from this tree's
`chunk_exit` walk) through its own wrappers on the same inputs.

Checks, each tree against this tree: K1's and K4's accum, log_t_eff and
n_contrib bit-equal to this tree's K1, their checkpoints bit-equal on the
words K2 reads, K4's keep flags equal to this tree's K4's; K2 on this
tree's K1 outputs within K2's headline bar (3e-4 scaled per field; K2 adds
with atomics, so two launches differ in rounding), the gap printed beside
this tree's K2 against itself; the probes' `chunk_exit` and pair2 outputs
bit-equal to this tree's, the probe backward within the same 3e-4 scaled
per field, its gap printed beside this tree's against itself. Exit 1 if
any check fails.

Times: graph ms (`timing.graph_ms`: 20 launches replayed from a CUDA
graph) of each kernel in turns, this tree first and then the others, then
in reverse (this, A, B, B, A, this), `--rounds` times; printed per tree
with every run, the mean, the ratio to this tree and K4/K1. Then each
tree's ptxas registers and spill bytes of its blend and probe kernels, and
a last line of JSON with it all.
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
from ..ops import blend_probe, tile_blend
from . import checks
from .kernel_probe import build_inputs, cotangents
from .scene import N_HEADLINE
from .timing import graph_ms, require_cuda

MARGIN = 10.0
# K2's headline bar (chip_smoke.py K2_HEADLINE): atomics sum in any order
K2_BAR = 3e-4
# K4 also at margin 1, where its walk is K1's: K4/K1 there is the cost of
# the keep marks and the phase test alone
NAMES = ("blend_fwd", "blend_fwd_export", "blend_fwd_export@1", "blend_bwd", "blend_probe_fwd",
         "blend_probe_fwd_pair2", "blend_probe_bwd")


def load_tree(root: Path, alias: str):
    """The port package of another checkout, imported as `alias`: (its
    kernels module, its ops.tile_blend module, its ops.blend_probe
    module)."""
    pkg = root.resolve() / "gsdf_slam_tpu_torch"
    spec = importlib.util.spec_from_file_location(alias, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return tuple(importlib.import_module(f"{alias}.{m}") for m in ("kernels", "ops.tile_blend", "ops.blend_probe"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", type=Path, help="roots of other checkouts")
    ap.add_argument("--rounds", type=int, default=2, help="passes of this-others-others-this")
    args = ap.parse_args(argv)
    smi = require_cuda()
    dev = torch.device("cuda", 0)
    trees = {"this": (kernels, tile_blend, blend_probe)}
    for i, root in enumerate(args.trees):
        trees[str(root)] = load_tree(root, f"gsdf_tree_{i}")
    for kern, *_ in trees.values():
        kern.library()

    st = build_inputs(N_HEADLINE, dev)
    ranges, payload, gid, gw, gh, p = (st[k] for k in ("ranges", "payload", "gid", "gw", "gh", "p"))
    ct_a, ct_t = cotangents(gw * gh, dev)
    calls = {
        name: {
            "blend_fwd": lambda tb=tb: tb.blend_fwd(ranges, payload, gw, gh),
            "blend_fwd_export": lambda tb=tb: tb.blend_fwd_export(ranges, payload, gw, gh, MARGIN),
            "blend_fwd_export@1": lambda tb=tb: tb.blend_fwd_export(ranges, payload, gw, gh, 1.0),
            "blend_probe_fwd": lambda bp=bp: bp.blend_probe_fwd(ranges, payload, gw, gh, "chunk_exit", 128),
            "blend_probe_fwd_pair2": lambda bp=bp: bp.blend_probe_fwd_pair2(ranges, payload, gw, gh, 128),
        } for name, (_, tb, bp) in trees.items()
    }
    print(f"trees: {list(trees)}; {payload.shape[1]} pairs, {gw * gh} tiles, margin {MARGIN:g}; {smi}", flush=True)

    # outputs against this tree's
    acc, lte, nc, ckpt = tile_blend.blend_fwd(ranges, payload, gw, gh)
    keep = tile_blend.blend_fwd_export(ranges, payload, gw, gh, MARGIN)[-1]
    k2_args = (ranges, payload, gid, acc, nc, ckpt, ct_a, ct_t, p, gw, gh)
    g_this = tile_blend.blend_bwd(*k2_args)
    g_again = tile_blend.blend_bwd(*k2_args)
    single = blend_probe.blend_probe_fwd(ranges, payload, gw, gh, "chunk_exit", 128)
    pair2 = blend_probe.blend_probe_fwd_pair2(ranges, payload, gw, gh, 128)
    pb_args = (ranges, payload, single[3], single[2], ct_a, ct_t, gw, gh, 128)
    pb_this = blend_probe.blend_probe_bwd(*pb_args)
    pb_self = max(checks.scaled_errors(blend_probe.blend_probe_bwd(*pb_args), pb_this).values())
    failed, result = [], {"device": smi, "trees": {}}
    self_gap = max(checks.scaled_errors(g_again.t(), g_this.t()).values())
    for name, (_, tb, bp) in trees.items():
        calls[name]["blend_bwd"] = lambda tb=tb: tb.blend_bwd(*k2_args)
        calls[name]["blend_probe_bwd"] = lambda bp=bp: bp.blend_probe_bwd(*pb_args)
        same = {}
        for kname in ("blend_fwd", "blend_fwd_export"):
            out = calls[name][kname]()
            torch.cuda.synchronize()
            same[kname] = (torch.equal(out[0], acc) and torch.equal(out[1], lte) and torch.equal(out[2], nc)
                           and checks.checkpoint_check(out[3], ckpt, ranges, out[2], nc)[2])
        keep_diff = int((calls[name]["blend_fwd_export"]()[-1] != keep).sum())
        k2_gap = max(checks.scaled_errors(calls[name]["blend_bwd"]().t(), g_this.t()).values())
        single_same = all(torch.equal(a, b) for a, b in zip(calls[name]["blend_probe_fwd"](), single))
        pair2_same = all(torch.equal(a, b) for a, b in zip(calls[name]["blend_probe_fwd_pair2"](), pair2))
        pb_gap = max(checks.scaled_errors(calls[name]["blend_probe_bwd"](), pb_this).values())
        torch.cuda.synchronize()
        print(f"[{name}] K1 bit-equal to this tree's K1: {same['blend_fwd']}; K4 bit-equal to it: "
              f"{same['blend_fwd_export']}; keep differs from this tree's K4 at {keep_diff} of {keep.numel()} "
              f"pairs; K2 scaled gap {k2_gap:.3g} (this tree's K2 against itself {self_gap:.3g}, bar {K2_BAR:g}); "
              f"probe chunk_exit bit-equal: {single_same}; pair2 bit-equal: {pair2_same}; probe backward scaled "
              f"gap {pb_gap:.3g} (this tree's against itself {pb_self:.3g}, bar {K2_BAR:g})", flush=True)
        if not (same["blend_fwd"] and same["blend_fwd_export"] and keep_diff == 0 and k2_gap <= K2_BAR
                and single_same and pair2_same and pb_gap <= K2_BAR):
            failed.append(name)
        result["trees"][name] = dict(k1_bit_equal=same["blend_fwd"], k4_bit_equal=same["blend_fwd_export"],
                                     keep_mismatches=keep_diff, k2_scaled_gap=k2_gap,
                                     probe_chunk_exit_bit_equal=single_same, pair2_bit_equal=pair2_same,
                                     probe_bwd_scaled_gap=pb_gap)

    order = list(trees) + list(reversed(trees))
    runs = {name: {k: [] for k in NAMES} for name in trees}
    for _ in range(args.rounds):
        for kname in NAMES:
            for name in order:
                runs[name][kname].append(graph_ms(calls[name][kname]))
    mean = {name: {k: sum(v) / len(v) for k, v in r.items()} for name, r in runs.items()}
    for kname in NAMES:
        for name in trees:
            print(f"[time] {kname} {name}: {mean[name][kname]:.4f} ms graph, "
                  f"{mean[name][kname] / mean['this'][kname]:.4f} of this tree's "
                  f"(runs {', '.join(f'{v:.4f}' for v in runs[name][kname])}) on {smi}", flush=True)
    for name, (kern, *_) in trees.items():
        usage = {k: v for k, v in kernels.ptxas_usage(kern.build_info.get("log", "")).items()
                 if k.startswith(("blend_fwd", "blend_bwd", "probe_fwd_kernel<Li4E>", "probe_fwd_pair2", "probe_bwd"))}
        ratio = mean[name]["blend_fwd_export"] / mean[name]["blend_fwd"]
        ratio1 = mean[name]["blend_fwd_export@1"] / mean[name]["blend_fwd"]
        print(f"[{name}] K4/K1 {ratio:.4f} (at margin 1 {ratio1:.4f}); ptxas: {json.dumps(usage)}", flush=True)
        result["trees"][name].update(ms=mean[name], runs=runs[name], k4_over_k1=ratio, k4_margin1_over_k1=ratio1,
                                     ptxas=usage)
    print(json.dumps(result), flush=True)
    if failed:
        print(f"FAILED: outputs of {failed} differ from this tree's", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
