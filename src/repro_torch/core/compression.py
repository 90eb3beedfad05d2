"""Lossy activation compression (paper Appendix A) — the port's twin of
``repro/core/compression.py``.

* Quantization (Eq. 13-15): clip to the calibrated per-element
  ``[s_min, s_max]``, round to an ``n``-bit integer code (round half to
  even, as ``jnp.round``); the code is what crosses the channel.
* PCA (Eq. 18-19): transmit ``w a``, reconstruct ``w^T a' + b``.
* Message sizing: ``n = floor(32 M / M_float)`` bits, or ``D' = floor(M /
  4)`` PCA coefficients, for a target message size ``M`` bytes.
* The fine-tuning graph's roundtrip (``Compressor.roundtrip_train``):
  quantize-dequantize with a straight-through gradient
  (``fake_quantize_ste``), PCA as the linear map it is.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Per-element scale factors; shapes broadcast against the activation's
    trailing feature dims."""

    bits: int
    s_min: torch.Tensor
    s_max: torch.Tensor

    @staticmethod
    def bits_for_message_size(message_bytes: float, float_bytes: float) -> int:
        """n = floor(32 M / M_float), clamped to [1, 32]."""
        return int(max(1, min(32, np.floor(32.0 * message_bytes / float_bytes))))


def _range(spec: QuantSpec, like: torch.Tensor):
    s_min = spec.s_min.to(device=like.device, dtype=like.dtype)
    s_max = spec.s_max.to(device=like.device, dtype=like.dtype)
    rng = torch.clamp(s_max - s_min, min=1e-8)
    return s_min, s_max, rng


def quantize(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Eq. (13)-(14): the integer code, as a float tensor of x's dtype."""
    levels = float(2 ** spec.bits - 1)
    s_min, s_max, rng = _range(spec, x)
    clipped = torch.minimum(torch.maximum(x, s_min), s_max)
    return torch.round((clipped - s_min) / rng * levels)


def dequantize(code: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Eq. (15)."""
    levels = float(2 ** spec.bits - 1)
    s_min, _, rng = _range(spec, code)
    return code / levels * rng + s_min


def fake_quantize_ste(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Quantize + dequantize in the forward, identity in the backward (the
    reference's ``x + stop_gradient(y - x)``): the COMtune fine-tuning
    graph's quantizer.  No gradient reaches ``s_min`` / ``s_max``."""
    y = dequantize(quantize(x, spec), spec)
    return x + (y - x).detach()


@dataclasses.dataclass(frozen=True)
class PCASpec:
    """w: (D', D) top eigenvector rows; b: (D,) residual mean bias (Eq. 23)."""

    w: torch.Tensor
    b: torch.Tensor

    @property
    def reduced_dim(self) -> int:
        return int(self.w.shape[0])

    @staticmethod
    def reduced_dim_for_message_size(message_bytes: float, float_bytes: float, full_dim: int) -> int:
        """D' = floor(M D / M_float) with M_float = D * float_bytes, i.e.
        floor(M / float_bytes) coefficients, clamped to [1, D]."""
        return int(max(1, min(full_dim, int(np.floor(message_bytes / float_bytes)))))


def pca_compress(x: torch.Tensor, spec: PCASpec) -> torch.Tensor:
    """Eq. (18): a' = w a."""
    return torch.einsum("...d,kd->...k", x, spec.w.to(device=x.device, dtype=x.dtype))


def pca_decompress(coeff: torch.Tensor, spec: PCASpec) -> torch.Tensor:
    """Eq. (19): a = w^T a' + b."""
    w = spec.w.to(device=coeff.device, dtype=coeff.dtype)
    return torch.einsum("...k,kd->...d", coeff, w) + spec.b.to(device=coeff.device, dtype=coeff.dtype)


@dataclasses.dataclass(frozen=True)
class Compressor:
    """f_cmp / f_dec pair (paper Eq. 8).  kind in {identity, quant, pca}."""

    kind: str = "identity"
    quant: Optional[QuantSpec] = None
    pca: Optional[PCASpec] = None

    def compress(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "identity":
            return x
        if self.kind == "quant":
            return quantize(x, self.quant)
        if self.kind == "pca":
            return pca_compress(x, self.pca)
        raise ValueError(self.kind)

    def decompress(self, z: torch.Tensor) -> torch.Tensor:
        if self.kind == "identity":
            return z
        if self.kind == "quant":
            return dequantize(z, self.quant)
        if self.kind == "pca":
            return pca_decompress(z, self.pca)
        raise ValueError(self.kind)

    def roundtrip_train(self, x: torch.Tensor) -> torch.Tensor:
        """Differentiable compress-decompress of the fine-tuning graph (STE
        for quantization; PCA is linear already)."""
        if self.kind == "identity":
            return x
        if self.kind == "quant":
            return fake_quantize_ste(x, self.quant)
        if self.kind == "pca":
            return pca_decompress(pca_compress(x, self.pca), self.pca)
        raise ValueError(self.kind)

    def message_elements(self, feature_dim: int) -> int:
        """How many scalars cross the channel per activation vector."""
        if self.kind == "pca":
            return self.pca.reduced_dim
        return feature_dim

    def bytes_per_element(self) -> float:
        if self.kind == "quant":
            return self.quant.bits / 8.0
        return 4.0
