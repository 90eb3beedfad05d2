"""Shared building blocks: dtypes, the truncated-normal initializers, norms
(RMSNorm and LayerNorm) and activations (twin of ``repro/models/common.py``),
with the recurrent layers' ``softplus`` and ``log_sigmoid`` in jax's form."""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


def acc_dtype(t: torch.Tensor) -> torch.dtype:
    """The dtype the reference's f32 upcasts compute in: f32, or f64 for an
    f64 tensor (a model cast with ``.double()``, the gradient oracle)."""
    return torch.promote_types(t.dtype, torch.float32)


def upcast(t: torch.Tensor) -> torch.Tensor:
    """``t`` in :func:`acc_dtype`: the reference's ``astype(float32)``, which
    leaves an f64 oracle in f64."""
    return t.to(acc_dtype(t))


def frozen(shape, dtype, device) -> nn.Parameter:
    """An uninitialized parameter, built without grad: the serving paths
    never differentiate the weights, and the trainer turns grad on
    (``launch/steps.py``, ``model.requires_grad_(True)``)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


@torch.no_grad()
def trunc_normal_(t: torch.Tensor, std: float, gen: torch.Generator) -> torch.Tensor:
    """N(0, 1) truncated to [-2, 2], scaled by ``std``, drawn in f32 and cast
    to the parameter's dtype (the reference's ``dense_init``/``embed_init``)."""
    x = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    nn.init.trunc_normal_(x, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=gen)
    return t.copy_(x * std)


def dense_std(shape) -> float:
    """Fan-in scale of ``dense_init``: 1 / sqrt(shape[-2])."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return 1.0 / math.sqrt(fan_in)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """RMSNorm with the (1 + scale) convention, eps 1e-6, computed in f32."""
    x32 = x.to(acc_dtype(x))
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + 1e-6)
    return (y * (1.0 + scale.to(x32.dtype))).to(x.dtype)


class RMSNorm(nn.Module):
    """:func:`rmsnorm` with its ``scale`` (zeros at init)."""

    def __init__(self, d: int, dtype, device):
        super().__init__()
        self.scale = frozen((d,), dtype, device)

    def reset_parameters(self) -> None:
        nn.init.zeros_(self.scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.scale)


class LayerNorm(nn.Module):
    """LayerNorm with ``scale`` (ones) and ``bias`` (zeros), eps 1e-5,
    computed in f32: the biased variance as the mean of the squared
    deviations, as ``jnp.var`` forms it."""

    def __init__(self, d: int, dtype, device):
        super().__init__()
        self.scale = frozen((d,), dtype, device)
        self.bias = frozen((d,), dtype, device)

    def reset_parameters(self) -> None:
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(acc_dtype(x))
        mean = x32.mean(dim=-1, keepdim=True)
        centered = x32 - mean
        var = (centered * centered).mean(dim=-1, keepdim=True)
        y = centered * torch.rsqrt(var + 1e-5)
        return (y * self.scale.to(x32.dtype) + self.bias.to(x32.dtype)).to(x.dtype)


def make_norm(kind: str, d: int, dtype, device) -> nn.Module:
    """The norm ``cfg.norm`` names (the reference's ``init_norm`` /
    ``apply_norm``)."""
    if kind == "rmsnorm":
        return RMSNorm(d, dtype, device)
    if kind == "layernorm":
        return LayerNorm(d, dtype, device)
    raise ValueError(f"unknown norm {kind!r}")


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): ``max(x, 0) +
    log1p(exp(-|x|))``, the same operations in the same order (torch's
    ``F.softplus`` forms ``log1p(exp(x))`` below its threshold, which rounds
    otherwise for positive x)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)


def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu
    raise ValueError(name)
