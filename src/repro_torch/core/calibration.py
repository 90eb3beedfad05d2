"""Calibration of the compression parameters (paper Appendix A): the port's
copy of ``repro/core/calibration.py``.  The maths is the reference's numpy,
line for line, so the specs hold the same float32 values; they come back
as f32 tensors on the ``device`` given (the card unless the caller asks
for the CPU).

* Quantization: per-feature ``s_min`` / ``s_max`` over a calibration batch
  of split-point activations, optionally percentile-clipped.
* PCA (Eq. 20-23): the top-D' eigenvectors of the activation covariance,
  through the (N, N) Gram matrix when N < D, and the residual-mean bias.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.compression import Compressor, PCASpec, QuantSpec
from repro_torch.kernels.runtime import resolve_device


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _f32(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(resolve_device(device))


def collect_activations(apply_fn, params, batches) -> np.ndarray:
    """Run the device-side sub-model over calibration batches and stack the
    flattened split-point activations into (N, D)."""
    outs = []
    for batch in batches:
        a = _numpy(apply_fn(params, batch))
        outs.append(a.reshape(-1, a.shape[-1]))
    return np.concatenate(outs, axis=0)


def calibrate_quant(activations: np.ndarray, bits: int, percentile: float = 0.0, device="cuda") -> QuantSpec:
    """Per-feature scale factors.  ``percentile`` > 0 trims outliers
    symmetrically (e.g. 0.1 -> the 0.1 / 99.9 percentiles)."""
    if percentile > 0.0:
        s_min = np.percentile(activations, percentile, axis=0)
        s_max = np.percentile(activations, 100.0 - percentile, axis=0)
    else:
        s_min = activations.min(axis=0)
        s_max = activations.max(axis=0)
    # Guard degenerate features.
    flat = s_max - s_min < 1e-6
    s_max = np.where(flat, s_min + 1e-6, s_max)
    return QuantSpec(bits=bits, s_min=_f32(s_min, device), s_max=_f32(s_max, device))


def calibrate_pca(activations: np.ndarray, reduced_dim: int, device="cuda") -> PCASpec:
    """Eq. (20)-(23) on activations (N, D), in float64."""
    a = np.asarray(activations, dtype=np.float64)
    mean = a.mean(axis=0)
    centered = a - mean
    # Covariance S (Eq. 20); the N x N Gram matrix when N < D.
    n, d = centered.shape
    if n >= d:
        cov = centered.T @ centered / n
        eigval, eigvec = np.linalg.eigh(cov)  # ascending
        order = np.argsort(eigval)[::-1]
        basis = eigvec[:, order].T  # rows = eigenvectors, descending eigval
    else:
        gram = centered @ centered.T / n
        eigval, eigvec = np.linalg.eigh(gram)
        order = np.argsort(eigval)[::-1]
        eigval = np.maximum(eigval[order], 1e-12)
        # v_i = X^T u_i / sqrt(n * lambda_i)
        basis = (centered.T @ eigvec[:, order] / np.sqrt(n * eigval)).T
    w = basis[:reduced_dim]  # (D', D)
    # Bias b: the mean's projection onto the discarded eigenvectors (Eq. 23),
    # b = mean - w^T w mean.
    b = mean - w.T @ (w @ mean)
    return PCASpec(w=_f32(w, device), b=_f32(b, device))


def make_compressor(activations: np.ndarray, *, kind: str, message_bytes: float | None = None,
                    bits: int | None = None, reduced_dim: int | None = None, percentile: float = 0.0,
                    device="cuda") -> Compressor:
    """A Compressor sized for a target message size M bytes (the paper's
    knob), or from explicit ``bits`` / ``reduced_dim``."""
    d = activations.shape[-1]
    float_bytes = 4.0
    if kind == "identity":
        return Compressor(kind="identity")
    if kind == "quant":
        if bits is None:
            assert message_bytes is not None
            bits = QuantSpec.bits_for_message_size(message_bytes, d * float_bytes)
        return Compressor(kind="quant", quant=calibrate_quant(activations, bits, percentile, device=device))
    if kind == "pca":
        if reduced_dim is None:
            assert message_bytes is not None
            reduced_dim = PCASpec.reduced_dim_for_message_size(message_bytes, float_bytes, d)
        return Compressor(kind="pca", pca=calibrate_pca(activations, reduced_dim, device=device))
    raise ValueError(kind)
