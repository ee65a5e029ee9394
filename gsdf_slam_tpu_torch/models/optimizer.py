"""Six-group Adam (eps 1e-15) and the learning-rate schedule.

Port of `gsdf_slam_tpu/models/optimizer.py`: one torch-semantics Adam over
the groups xyz / f_dc / f_rest / opacity / scaling / rotation, with one
shared step count (gaussian_model.cpp:319-352), in the JAX package's op
order. A plain function over a dict of tensors, so that the moments can be
carried across from the JAX state and compared with it row for row.

The scalars (the bias corrections, sqrt(bc2), each group's lr / bc1 and
the schedule) are float32 arithmetic on the host, in the JAX package's
formulas and order: a device tensor made from a host number is an upload
from pageable memory, at which the host waits for the device. On CUDA
tensors `adam_step` launches the kernel `adam_step` (csrc/adam.cu) once
over all groups, every scalar a launch argument, and it updates p, m and v
in place; on CPU tensors it runs `adam_step_plain` a group, the plain
tensor ops, which put new m and v into the state. The kernel replaces no
Pallas kernel: the JAX package leaves Adam to XLA's fusion.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from .. import kernels

BETA1 = 0.9
BETA2 = 0.999
EPS = 1e-15  # adam_options.eps() = 1e-15, gaussian_model.cpp:327

PARAM_GROUPS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")

_F32 = np.float32
# b1, 1 - b1, b2, 1 - b2 and eps as torch rounds them, a Python number
# against a float32 tensor
_CONSTS = tuple(float(_F32(c)) for c in (BETA1, 1.0 - BETA1, BETA2, 1.0 - BETA2, EPS))


@dataclasses.dataclass
class AdamState:
    m: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]
    step: int = 0

    @staticmethod
    def init(params: dict[str, torch.Tensor]) -> "AdamState":
        return AdamState(
            m={k: torch.zeros_like(p) for k, p in params.items()},
            v={k: torch.zeros_like(p) for k, p in params.items()},
            step=0,
        )


def bias_corrections(step: int) -> tuple[np.float32, np.float32, np.float32]:
    """(bc1, bc2, sqrt(bc2)) of Adam's step number `step`, in float32:
    bc = 1 - beta ** t, as the JAX package computes them."""
    t = _F32(step)
    bc1 = _F32(1.0) - _F32(BETA1) ** t
    bc2 = _F32(1.0) - _F32(BETA2) ** t
    return bc1, bc2, np.sqrt(bc2)


def adam_step_plain(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, lr_bc1: float,
                    sqrt_bc2: float) -> tuple[torch.Tensor, torch.Tensor]:
    """One group's step as tensor ops in torch's order: `p` updated in
    place, the new (m, v) returned. sqrt(bc2) divides as a 0-dim tensor on
    p's device, since on CUDA torch turns a division by a host number into
    a product with its reciprocal; so the card's plain run rounds as the
    CPU's and as the kernel."""
    m = BETA1 * m + (1.0 - BETA1) * g
    v = BETA2 * v + (1.0 - BETA2) * g * g
    denom = torch.sqrt(v) / p.new_full((), sqrt_bc2) + EPS
    p.sub_((lr_bc1 * m) / denom)
    return m, v


class _Group(ctypes.Structure):
    """csrc/adam.cu's GsdfAdamGroup."""

    _fields_ = [("p", ctypes.c_void_p), ("g", ctypes.c_void_p), ("m", ctypes.c_void_p), ("v", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("lr_bc1", ctypes.c_float)]


def adam_step_kernel(params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor], m: dict[str, torch.Tensor],
                     v: dict[str, torch.Tensor], lr_bc1: dict[str, float], sqrt_bc2: float) -> None:
    """Kernel `adam_step`: one launch over the groups of `params` (1 to 6),
    each group's p, g, m and v contiguous float32 of one shape on one CUDA
    device; p, m and v updated in place. The groups' pointers, sizes and
    lr / bc1 go to the kernel by value, built on the host. A CUDA tensor
    only (no plain fallback)."""
    names = list(params)
    if not 1 <= len(names) <= len(PARAM_GROUPS):
        raise ValueError(f"adam_step: 1 to {len(PARAM_GROUPS)} groups, got {len(names)}")
    dev = params[names[0]].device
    groups = (_Group * len(names))()
    total = 0
    for i, k in enumerate(names):
        ts = (params[k], grads[k], m[k], v[k])
        shape = ts[0].shape
        # kernels.check's conditions, tested at once; it names the failure
        if not all(t.dtype == torch.float32 and t.shape == shape and t.device == dev and t.is_contiguous()
                   for t in ts):
            for what, t in zip(("params", "grads", "m", "v"), ts):
                kernels.check(f"{what}[{k!r}]", t, torch.float32, tuple(shape), dev)
        n = ts[0].numel()
        groups[i] = _Group(*(t.data_ptr() for t in ts), n, float(lr_bc1[k]))
        total += n
    kernels.library()  # builds on first use; raises where it cannot
    if total == 0:
        return
    kernels.LAUNCHES["adam_step"] += 1
    kernels.launch("gsdf_adam_step", ctypes.addressof(groups), len(names), *_CONSTS, float(sqrt_bc2))


@torch.no_grad()
def adam_step(
    params: dict[str, torch.Tensor],
    grads: dict[str, torch.Tensor],
    state: AdamState,
    lrs: dict[str, float],
) -> None:
    """One Adam step over all groups. Updates `params` and `state` in place
    (the JAX version returns new arrays; in place saves a copy of the map).
    `lrs`: each group's learning rate, a host number (`group_lrs`'). The
    kernel on CUDA tensors, the plain version on CPU tensors."""
    state.step += 1
    bc1, _, sqrt_bc2 = bias_corrections(state.step)
    lr_bc1 = {k: _F32(lrs[k]) / bc1 for k in params}
    if not kernels.runs_plain(next(iter(params.values()))):
        adam_step_kernel(params, grads, state.m, state.v, lr_bc1, sqrt_bc2)
        return
    for k, p in params.items():
        state.m[k], state.v[k] = adam_step_plain(p, grads[k], state.m[k], state.v[k], float(lr_bc1[k]),
                                                 float(sqrt_bc2))


def expon_lr(
    step: float,
    lr_init: float,
    lr_final: float,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
    max_steps: int = 30_000,
) -> np.float32:
    """Log-lerp lr schedule (gaussian_model.cpp:1025-1037), in float32 on
    the host as the JAX version evaluates it."""
    step_t, lr_i, lr_f = _F32(step), _F32(lr_init), _F32(lr_final)
    # min / max of float32 numbers return one of them: clip and maximum
    # without numpy's per-call cost
    clip01 = lambda x: min(max(x, _F32(0.0)), _F32(1.0))
    if lr_delay_steps > 0:
        delay = _F32(lr_delay_mult) + _F32(1.0 - lr_delay_mult) * np.sin(
            _F32(0.5 * math.pi) * clip01(step_t / _F32(lr_delay_steps))
        )
    else:
        delay = _F32(1.0)
    t = clip01(step_t / _F32(max_steps))
    log_lerp = np.exp(
        np.log(max(lr_i, _F32(1e-38))) * (_F32(1.0) - t)
        + np.log(max(lr_f, _F32(1e-38))) * t
    )
    if lr_init == 0.0 and lr_final == 0.0:
        log_lerp = _F32(0.0)
    return _F32(0.0) if step_t < 0 else _F32(delay * log_lerp)


def group_lrs(opt, spatial_lr_scale: float, iteration: float) -> dict[str, np.float32]:
    """Current lr per group (trainingSetup :319-352 + updateLearningRate),
    float32 host numbers."""
    return {
        "xyz": expon_lr(
            iteration,
            opt.position_lr_init * spatial_lr_scale,
            opt.position_lr_final * spatial_lr_scale,
            lr_delay_mult=opt.position_lr_delay_mult,
            max_steps=opt.position_lr_max_steps,
        ),
        "f_dc": _F32(opt.feature_lr),
        "f_rest": _F32(opt.feature_lr / 20.0),
        "opacity": _F32(opt.opacity_lr),
        "scaling": _F32(opt.scaling_lr),
        "rotation": _F32(opt.rotation_lr),
    }
