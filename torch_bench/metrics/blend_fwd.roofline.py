"""The forward blend launches' (K1 blend_fwd, K4 blend_fwd_export) summed
bound over their summed device time in the traced window, in percent. The
bound of each launch is the larger of its bytes over the card's bandwidth
and its walk's operations over its float32 rate (metrics/counts.py), from
its own inputs and outputs; the applied pixel-pairs' further work is not
counted, so the share is at most the true one."""

from torch_bench.metrics import counts
from torch_bench.trace import FWD_KERNELS


def read(rec):
    if rec.blend is None or rec.trace is None or not rec.blend["fwd_calls"]:
        return None
    return counts.share(rec.blend["fwd_bound_s"], rec.trace.kernel_seconds(FWD_KERNELS))
