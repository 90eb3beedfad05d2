"""Serving step builders (twin of ``repro/launch/steps.py:134-173``).

``serve_step`` is the paper's DI round (Eq. 12) for one token: device-side
layers -> lossy link (quantize, packet mask, 1/(1-p), dequantize) ->
server-side layers, writing the cache in place.  The reference jits these
closures; the port runs them eagerly.
"""

from __future__ import annotations

from typing import Any, Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm


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
