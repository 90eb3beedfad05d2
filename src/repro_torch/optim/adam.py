"""Adam / AdamW over a dict of named tensors: the port's twin of
``repro/optim/adam.py``, op for op.

The moments are f32 (or bf16 with ``state_dtype="bfloat16"``), each leaf's
update runs in f32 as the reference orders it -- ``m = b1 m + (1 - b1) g``,
``v = b2 v + (1 - b2) g g``, ``mhat / (sqrt(vhat) + eps)`` with bias
corrections ``1 - b ** step`` in f32 -- and the result is cast to the
parameter's dtype.  (``torch.optim.Adam`` orders these operations
differently.)  Unlike the reference, which returns new pytrees,
``adam_update`` writes the parameters and moments in place, which keeps a
full-width model's optimizer at one copy of its state; and it takes each
leaf a slice of rows at a time (``SLICE_ELEMS``), with the clip's scale
applied inside the slice, so its f32 temporaries are a slice's, not a
leaf's (nine of a 940 M-element expert tensor would be 33.8 GB), and the
clipped gradients are never a second copy.  Each element's arithmetic is
the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

Tree = Dict[str, torch.Tensor]
# The most elements of a leaf that one slice of the update covers (a slice
# is whole rows of the leaf's first axis, at least one).
SLICE_ELEMS = 1 << 24


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


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def _row_slices(t: torch.Tensor):
    """Indices that cover ``t`` in slices of whole first-axis rows, each of
    at most ``SLICE_ELEMS`` elements (one row at least); ``...`` for a leaf
    that fits in one."""
    if t.dim() == 0 or t.numel() <= SLICE_ELEMS:
        return [...]
    rows = max(1, SLICE_ELEMS // (t.numel() // t.shape[0]))
    return [slice(lo, lo + rows) for lo in range(0, t.shape[0], rows)]


@torch.no_grad()
def adam_update(grads: Tree, params: Tree, state: AdamState, cfg: AdamConfig) -> Tuple[Tree, AdamState, torch.Tensor]:
    """Returns (params, state, grad_norm); ``params`` and the state's
    moments are updated in place.  ``grads`` holds a gradient for every
    parameter (a zero tensor where the loss does not reach it).  The clip
    multiplies each gradient by the reference's ``clip_by_global_norm``
    scale in the gradient's dtype, a slice at a time."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip_norm) if cfg.grad_clip_norm > 0 else None
    step = state.step + 1
    lr = cfg.lr if cfg.schedule is None else cfg.lr * cfg.schedule(step)
    b1, b2 = cfg.b1, cfg.b2
    step32 = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, step32)
    bc2 = 1.0 - torch.pow(b2, step32)
    for name, p_leaf in params.items():
        acc = torch.promote_types(p_leaf.dtype, torch.float32)   # f32; f64 for an f64 oracle
        g_leaf, m_leaf, v_leaf = grads[name], state.mu[name], state.nu[name]
        for sl in _row_slices(p_leaf):
            p, g, m, v = p_leaf[sl], g_leaf[sl], m_leaf[sl], v_leaf[sl]
            if scale is not None:
                g = g * scale.to(g.dtype)
            g32 = g.to(acc)
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
