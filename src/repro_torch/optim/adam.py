"""Adam / AdamW over a dict of named tensors: the port's twin of
``repro/optim/adam.py``, op for op.

The moments are f32 (or bf16 with ``state_dtype="bfloat16"``), each leaf's
update runs in f32 as the reference orders it -- ``m = b1 m + (1 - b1) g``,
``v = b2 v + (1 - b2) g g``, ``mhat / (sqrt(vhat) + eps)`` with bias
corrections ``1 - b ** step`` in f32 -- and the result is cast to the
parameter's dtype.  (``torch.optim.Adam`` orders these operations
differently.)  Unlike the reference, which returns new pytrees,
``adam_update`` writes the parameters and moments in place, which keeps a
full-width model's optimizer at one copy of its state.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

Tree = Dict[str, torch.Tensor]


class AdamState(NamedTuple):
    step: torch.Tensor        # () int32
    mu: Tree
    nu: Tree


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0          # AdamW when > 0
    grad_clip_norm: float = 0.0        # 0 = off
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    state_dtype: str = "float32"       # "bfloat16" halves optimizer memory


def init_adam(params: Tree, cfg: AdamConfig) -> AdamState:
    dt = torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32
    device = next(iter(params.values())).device
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                     mu={n: zeros(p) for n, p in params.items()},
                     nu={n: zeros(p) for n, p in params.items()})


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares (leaves summed in
    the dict's order)."""
    total = 0
    for x in tree.values():
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tuple[Tree, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {n: g * scale.to(g.dtype) for n, g in grads.items()}, norm


@torch.no_grad()
def adam_update(grads: Tree, params: Tree, state: AdamState, cfg: AdamConfig) -> Tuple[Tree, AdamState, torch.Tensor]:
    """Returns (params, state, grad_norm); ``params`` and the state's
    moments are updated in place.  ``grads`` holds a gradient for every
    parameter (a zero tensor where the loss does not reach it)."""
    if cfg.grad_clip_norm > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip_norm)
    else:
        gnorm = global_norm(grads)
    step = state.step + 1
    lr = cfg.lr if cfg.schedule is None else cfg.lr * cfg.schedule(step)
    b1, b2 = cfg.b1, cfg.b2
    step32 = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, step32)
    bc2 = 1.0 - torch.pow(b2, step32)
    for name, p in params.items():
        acc = torch.promote_types(p.dtype, torch.float32)   # f32; f64 for an f64 oracle
        g32 = grads[name].to(acc)
        m, v = state.mu[name], state.nu[name]
        m32 = b1 * m.to(acc) + (1 - b1) * g32
        v32 = b2 * v.to(acc) + (1 - b2) * g32 * g32
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay > 0:
            delta = delta + cfg.weight_decay * p.to(acc)
        p.copy_(p.to(acc) - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    return params, AdamState(step=step, mu=state.mu, nu=state.nu), gnorm
