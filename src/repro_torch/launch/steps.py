"""Step builders (twin of ``repro/launch/steps.py:31-173``).

``train_step`` is COMtune's fine-tuning step (Eq. 8): the LM loss with the
link emulation active at the split point, its gradient, and Adam.
``train_epoch`` runs K of them with the reference's key chain (``key, sub
= split(key)`` each step), which the reference compiles as one
``lax.scan``; the port runs the steps eagerly.  ``serve_step`` is the
paper's DI round (Eq. 12) for one token: device-side layers -> lossy link
(quantize, packet mask, 1/(1-p), dequantize) -> server-side layers,
writing the cache in place.

The reference's step metrics also carry the link counters
(``link_elems``, ``link_dropped``, ``fec_recovered_packets``); they come
with the device-counter port (ROADMAP A8).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import prng
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.optim import AdamConfig, AdamState, adam_update


def make_train_step(cfg: ModelConfig, adam_cfg: AdamConfig, link_mode: str = "train", link_spec=None):
    """COMtune fine-tuning step; ``link_mode="off"`` is the 'previous DI'
    baseline.  ``link_spec`` (a full ``LinkSpec``) selects the train-time
    emulation (Eq. 7 dropout or the deployment channel); None derives it
    from ``cfg.link``.  A ``batch["link_rate"]`` 0-d tensor, when present,
    overrides the emulation rate (the per-step curriculum).

    ``train_step(model, opt_state, batch, key) -> (model, opt_state,
    {"loss", "grad_norm"})`` updates the model's parameters in place; they
    must require grad (``model.requires_grad_(True)``)."""

    def train_step(model: lm.LM, opt_state: AdamState, batch: Dict[str, Any], key):
        params = dict(model.named_parameters())
        logits, _, aux = lm.forward(model, batch["tokens"], cfg, link_key=key, link_mode=link_mode,
                                    link_spec=link_spec, link_rate=batch.get("link_rate"))
        loss = lm.lm_loss(logits, batch["tokens"], aux, cfg.router_aux_coef)
        del logits
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        # A parameter the loss does not reach (the link's quantization range,
        # behind the straight-through estimator) gets the reference's zero
        # gradient.
        grads = {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(params.items(), grads)}
        _, opt_state, gnorm = adam_update(grads, params, opt_state, adam_cfg)
        return model, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step


def make_train_epoch(cfg: ModelConfig, adam_cfg: AdamConfig, link_mode: str = "train", link_spec=None):
    """K train steps on the reference's key chain.  ``epoch_fn(model,
    opt_state, batches, key) -> (model, opt_state, key, metrics)``:
    ``batches`` holds ``tokens`` (K, B, S) and optionally ``link_rate`` (K,)
    (the per-step curriculum); ``metrics`` holds (K,) ``loss`` and
    ``grad_norm`` tensors, read by the caller only where it logs; the
    returned key continues the chain, so consecutive epochs compose to one
    long loop."""
    step = make_train_step(cfg, adam_cfg, link_mode=link_mode, link_spec=link_spec)

    def epoch_fn(model: lm.LM, opt_state: AdamState, batches: Dict[str, torch.Tensor], key: torch.Tensor):
        losses, norms = [], []
        for i in range(batches["tokens"].shape[0]):
            key, sub = prng.split(key)
            model, opt_state, metrics = step(model, opt_state, {k: v[i] for k, v in batches.items()}, sub)
            losses.append(metrics["loss"])
            norms.append(metrics["grad_norm"])
        return model, opt_state, key, {"loss": torch.stack(losses), "grad_norm": torch.stack(norms)}

    return epoch_fn


def make_prefill_step(cfg: ModelConfig, link_mode: str = "serve"):
    """Builds the cache from a prompt; the prompt activation crosses the
    lossy link once, streamed as per-token rounds."""

    def prefill_step(model: lm.LM, batch: Dict[str, Any], cache, key):
        logits, cache, _ = lm.forward(model, batch["tokens"], cfg, cache=cache, cache_index=0,
                                      link_key=key, link_mode=link_mode)
        return logits[:, -1], cache

    return prefill_step


def make_serve_step(cfg: ModelConfig, link_mode: str = "serve"):
    """One DI decode round (paper Eq. 12)."""

    def serve_step(model: lm.LM, token, cache, index: int, key):
        logits, cache, _ = lm.forward(model, token, cfg, cache=cache, cache_index=index,
                                      link_key=key, link_mode=link_mode)
        return logits[:, 0], cache

    return serve_step
