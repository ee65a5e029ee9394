"""Six-group Adam (eps 1e-15) and the learning-rate schedule.

Port of `gsdf_slam_tpu/models/optimizer.py`: one torch-semantics Adam over
the groups xyz / f_dc / f_rest / opacity / scaling / rotation, with one
shared step count (gaussian_model.cpp:319-352), in the JAX package's op
order. A plain function over a dict of tensors, so that the moments can be
carried across from the JAX state and compared with it row for row.
"""

from __future__ import annotations

import dataclasses
import math

import torch

BETA1 = 0.9
BETA2 = 0.999
EPS = 1e-15  # adam_options.eps() = 1e-15, gaussian_model.cpp:327

PARAM_GROUPS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")


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


@torch.no_grad()
def adam_step(
    params: dict[str, torch.Tensor],
    grads: dict[str, torch.Tensor],
    state: AdamState,
    lrs: dict[str, torch.Tensor],
) -> None:
    """One Adam step over all groups. Updates `params` and `state` in place
    (the JAX version returns new arrays; in place saves a copy of the map)."""
    state.step += 1
    dev = next(iter(params.values())).device
    t = torch.tensor(float(state.step), dtype=torch.float32, device=dev)
    bc1 = 1.0 - torch.pow(torch.tensor(BETA1, dtype=torch.float32, device=dev), t)
    bc2 = 1.0 - torch.pow(torch.tensor(BETA2, dtype=torch.float32, device=dev), t)
    sqrt_bc2 = torch.sqrt(bc2)
    for k, p in params.items():
        g = grads[k]
        m = BETA1 * state.m[k] + (1.0 - BETA1) * g
        v = BETA2 * state.v[k] + (1.0 - BETA2) * g * g
        # torch's op order: denom = sqrt(v)/sqrt(bc2) + eps; p -= (lr/bc1) * m / denom
        denom = torch.sqrt(v) / sqrt_bc2 + EPS
        p.sub_((lrs[k] / bc1) * m / denom)
        state.m[k] = m
        state.v[k] = v


def expon_lr(
    step: float,
    lr_init: float,
    lr_final: float,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
    max_steps: int = 30_000,
    device: torch.device | str = "cuda",
) -> torch.Tensor:
    """Log-lerp lr schedule (gaussian_model.cpp:1025-1037), in float32 as
    the JAX version evaluates it."""
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    step_t, lr_i, lr_f = f(step), f(lr_init), f(lr_final)
    if lr_delay_steps > 0:
        delay = lr_delay_mult + (1.0 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step_t / lr_delay_steps, 0.0, 1.0)
        )
    else:
        delay = 1.0
    t = torch.clamp(step_t / max_steps, 0.0, 1.0)
    log_lerp = torch.exp(
        torch.log(torch.clamp_min(lr_i, 1e-38)) * (1.0 - t)
        + torch.log(torch.clamp_min(lr_f, 1e-38)) * t
    )
    if lr_init == 0.0 and lr_final == 0.0:
        log_lerp = torch.zeros_like(log_lerp)
    return torch.where(step_t < 0, 0.0, delay * log_lerp)


def group_lrs(opt, spatial_lr_scale: float, iteration: float, device="cuda") -> dict[str, torch.Tensor]:
    """Current lr per group (trainingSetup :319-352 + updateLearningRate)."""
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    return {
        "xyz": expon_lr(
            iteration,
            opt.position_lr_init * spatial_lr_scale,
            opt.position_lr_final * spatial_lr_scale,
            lr_delay_mult=opt.position_lr_delay_mult,
            max_steps=opt.position_lr_max_steps,
            device=device,
        ),
        "f_dc": f(opt.feature_lr),
        "f_rest": f(opt.feature_lr / 20.0),
        "opacity": f(opt.opacity_lr),
        "scaling": f(opt.scaling_lr),
        "rotation": f(opt.rotation_lr),
    }
