"""Step builders (twin of ``repro/launch/steps.py:31-241``).

``train_step`` is COMtune's fine-tuning step (Eq. 8): the LM loss with the
link emulation active at the split point, its gradient, and Adam; its
metrics carry the link counters of the step's draws (``link_elems``,
``link_dropped``, ``fec_recovered_packets``, 0-d tensors on the device).
``train_epoch`` runs K of them with the reference's key chain (``key, sub
= split(key)`` each step), which the reference compiles as one
``lax.scan``; the port runs the steps eagerly.  ``serve_step`` is the
paper's DI round (Eq. 12) for one token: device-side layers -> lossy link
(quantize, packet mask, 1/(1-p), dequantize) -> server-side layers,
writing the cache in place.  ``generate_fn`` is the whole generation: a
prefill, then ``num_tokens`` DI rounds, greedy or sampled.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.obs import device as obs_device
from repro_torch.optim import AdamConfig, AdamState, adam_update

# The link counters of a train step's metrics (and of an epoch's).
LINK_KEYS = ("link_elems", "link_dropped", "fec_recovered_packets")


def make_train_step(cfg: ModelConfig, adam_cfg: AdamConfig, link_mode: str = "train", link_spec=None):
    """COMtune fine-tuning step; ``link_mode="off"`` is the 'previous DI'
    baseline.  ``link_spec`` (a full ``LinkSpec``) selects the train-time
    emulation (Eq. 7 dropout or the deployment channel); None derives it
    from ``cfg.link``.  A ``batch["link_rate"]`` 0-d tensor, when present,
    overrides the emulation rate (the per-step curriculum).

    ``train_step(model, opt_state, batch, key) -> (model, opt_state,
    metrics)`` updates the model's parameters in place; they must require
    grad (``model.requires_grad_(True)``).  ``metrics``: ``loss``,
    ``grad_norm`` and the ``LINK_KEYS`` counters of the emulated link's
    draws (what its masks dropped this step, from a link tap)."""

    def train_step(model: lm.LM, opt_state: AdamState, batch: Dict[str, Any], key):
        params = dict(model.named_parameters())
        with obs_device.tap_link_stats() as tap:
            logits, _, aux = lm.forward(model, batch["tokens"], cfg, link_key=key, link_mode=link_mode,
                                        link_spec=link_spec, link_rate=batch.get("link_rate"))
        link = tap.totals(logits.device)
        loss = lm.lm_loss(logits, batch["tokens"], aux, cfg.router_aux_coef)
        del logits
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        # A parameter the loss does not reach (the link's quantization range,
        # behind the straight-through estimator) gets the reference's zero
        # gradient.
        grads = {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(params.items(), grads)}
        _, opt_state, gnorm = adam_update(grads, params, opt_state, adam_cfg)
        return model, opt_state, {"loss": loss.detach(), "grad_norm": gnorm, "link_elems": link["elems"],
                                  "link_dropped": link["dropped"], "fec_recovered_packets": link["fec_recovered"]}

    return train_step


def make_train_epoch(cfg: ModelConfig, adam_cfg: AdamConfig, link_mode: str = "train", link_spec=None):
    """K train steps on the reference's key chain.  ``epoch_fn(model,
    opt_state, batches, key) -> (model, opt_state, key, metrics)``:
    ``batches`` holds ``tokens`` (K, B, S) and optionally ``link_rate`` (K,)
    (the per-step curriculum); ``metrics`` holds (K,) ``loss``,
    ``grad_norm`` and ``LINK_KEYS`` tensors, read by the caller only where
    it logs; the returned key continues the chain, so consecutive epochs
    compose to one long loop."""
    step = make_train_step(cfg, adam_cfg, link_mode=link_mode, link_spec=link_spec)
    keys = ("loss", "grad_norm") + LINK_KEYS

    def epoch_fn(model: lm.LM, opt_state: AdamState, batches: Dict[str, torch.Tensor], key: torch.Tensor):
        out = {k: [] for k in keys}
        for i in range(batches["tokens"].shape[0]):
            key, sub = prng.split(key)
            model, opt_state, metrics = step(model, opt_state, {k: v[i] for k, v in batches.items()}, sub)
            for k in keys:
                out[k].append(metrics[k])
        return model, opt_state, key, {k: torch.stack(v) for k, v in out.items()}

    return epoch_fn


def make_prefill_step(cfg: ModelConfig, link_mode: str = "serve", link_spec=None):
    """Builds the cache from a prompt; the prompt activation crosses the
    lossy link once, streamed as per-token rounds.  ``link_spec`` (a full
    ``LinkSpec``, e.g. ``use_kernel=True``) overrides the one ``cfg.link``
    implies."""

    def prefill_step(model: lm.LM, batch: Dict[str, Any], cache, key):
        logits, cache, _ = lm.forward(model, batch["tokens"], cfg, cache=cache, cache_index=0,
                                      link_key=key, link_mode=link_mode, link_spec=link_spec)
        return logits[:, -1], cache

    return prefill_step


def make_serve_step(cfg: ModelConfig, link_mode: str = "serve", link_spec=None):
    """One DI decode round (paper Eq. 12); ``link_spec`` as in
    :func:`make_prefill_step`."""

    def serve_step(model: lm.LM, token, cache, index: int, key):
        logits, cache, _ = lm.forward(model, token, cfg, cache=cache, cache_index=index,
                                      link_key=key, link_mode=link_mode, link_spec=link_spec)
        return logits[:, 0], cache

    return serve_step


def temperature_scale(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """``logits.float() / max(temperature, 1e-6)`` as the jitted reference
    computes it: XLA folds the division by the static f32 temperature into
    a multiply by its f32 reciprocal, so the port multiplies by that
    reciprocal too (an f32 value, exact as a scalar operand on either
    device)."""
    recip = np.float32(1.0) / np.float32(max(temperature, 1e-6))
    return logits.to(torch.float32) * float(recip)


def make_generate_fn(cfg: ModelConfig, num_tokens: int, link_mode: str = "serve", greedy: bool = True,
                     temperature: float = 1.0, link_spec=None):
    """Whole-generation step: a prefill, then ``num_tokens`` DI decode
    rounds, with the reference's key chain: ``split(key)`` for the
    prefill; when sampling, ``split(key)`` once more for the first token;
    then each round ``split(key)`` (greedy) or ``split(key, 3)`` (the third
    key samples).  The reference runs the rounds as one ``lax.scan``; the
    port loops eagerly.

    Returns ``generate_fn(model, prompts, cache, key) -> (tokens, cache)``
    with ``tokens`` (B, num_tokens) int32: the token fed into each round,
    so ``tokens[:, 0]`` is the prefill's choice.  Sampling draws one joint
    categorical over the batch a round (``prng.categorical``), as the
    reference does."""
    prefill = make_prefill_step(cfg, link_mode=link_mode, link_spec=link_spec)
    step = make_serve_step(cfg, link_mode=link_mode, link_spec=link_spec)

    def select(logits, key):
        if greedy:
            return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        return prng.categorical(key, temperature_scale(logits, temperature))[:, None].to(torch.int32)

    def generate_fn(model: lm.LM, prompts: torch.Tensor, cache, key: torch.Tensor):
        s_prompt = prompts.shape[1]
        key, sub = prng.split(key)
        logits, cache = prefill(model, {"tokens": prompts}, cache, sub)
        if greedy:
            token = select(logits, None)
        else:
            key, ks = prng.split(key)
            token = select(logits, ks)
        out = []
        for i in range(num_tokens):
            out.append(token)
            if greedy:
                key, sub = prng.split(key)
                ks = None
            else:
                key, sub, ks = prng.split(key, 3)
            logits, cache = step(model, token, cache, s_prompt + i, sub)
            token = select(logits, ks)
        return torch.cat(out, dim=1), cache

    return generate_fn
