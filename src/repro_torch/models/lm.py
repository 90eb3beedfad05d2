"""Causal LM with the COMtune link at the split point — the port's twin of
``repro/models/lm.py`` (init, ``make_link_fn``, ``forward`` and
``lm_loss``).

``LM`` holds the weights in the reference's layout (``state_dict`` keys
``embed``, ``stack.layers.{i}.{norm1,mix,norm2,ffn}.*``, ``final_norm.*``,
``link.s_min``/``link.s_max``, and where the config has them ``lm_head``
(an untied head) and ``frontend.proj`` (the modality adapter)).  Behaviour
(attention path, link) is read from the ``cfg`` passed to ``forward``, so
one set of weights can be run under several configurations, as the
reference's functions allow.

Vocabulary parallel (the sharded serving steps): when ``embed`` (and
``lm_head``) hold this rank's ``V / m`` vocabulary rows (columns), a token
outside them reads zeros and the sum over ``model`` puts each token's row
together (one nonzero term, so the sum is exact); the logits come out as
the rank's vocabulary slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import comtune
from repro_torch.core.compression import Compressor, PCASpec, QuantSpec
from repro_torch.core.link import scalar_as
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import rope as rope_lib
from repro_torch.models.attention import Cache, Index, PagedIndex
from repro_torch.models.common import acc_dtype, dense_std, dtype_of, frozen, make_norm, trunc_normal_
from repro_torch.models.frontends import FrontendAdapter, fuse_frontend
from repro_torch.obs import device as obs_device
from repro_torch.models.transformer import Stack
from repro_torch.sharding import ctx as shard_ctx


class LinkParams(nn.Module):
    """Compression parameters at the split point (f32): quantization range
    ``s_min``/``s_max`` or the PCA basis ``w``/``b``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, link = cfg.d_model, cfg.link
        self.kind = link.compression
        if link.compression == "quant":
            self.s_min = frozen((d,), torch.float32, device)
            self.s_max = frozen((d,), torch.float32, device)
        elif link.compression == "pca":
            dim = link.pca_dim or d // 4
            self.w = frozen((dim, d), torch.float32, device)
            self.b = frozen((d,), torch.float32, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        if self.kind == "quant":
            nn.init.constant_(self.s_min, -6.0)
            nn.init.constant_(self.s_max, 6.0)
        elif self.kind == "pca":
            trunc_normal_(self.w, 1.0 / math.sqrt(self.w.shape[0]), gen)
            nn.init.zeros_(self.b)

    def compressor(self, cfg: ModelConfig) -> Compressor:
        if self.kind == "quant":
            return Compressor(kind="quant", quant=QuantSpec(cfg.link.quant_bits, self.s_min, self.s_max))
        if self.kind == "pca":
            return Compressor(kind="pca", pca=PCASpec(w=self.w, b=self.b))
        return Compressor(kind="identity")


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        dtype = dtype_of(cfg.dtype)
        self.cfg = cfg
        self.embed = frozen((cfg.vocab_size, cfg.d_model), dtype, device)
        self.stack = Stack(cfg, dtype, device)
        self.final_norm = make_norm(cfg.norm, cfg.d_model, dtype, device)
        self.link = LinkParams(cfg, device)
        self.lm_head = None if cfg.tie_embeddings else frozen((cfg.d_model, cfg.vocab_size), dtype, device)
        self.frontend = FrontendAdapter(cfg.d_model, dtype, device) if cfg.frontend else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        trunc_normal_(self.embed, 0.02, gen)
        self.stack.reset_parameters(gen)
        self.final_norm.reset_parameters()
        self.link.reset_parameters(gen)
        if self.lm_head is not None:
            trunc_normal_(self.lm_head, dense_std(self.lm_head.shape), gen)
        if self.frontend is not None:
            self.frontend.reset_parameters(gen)

    def forward(self, tokens: torch.Tensor, cfg: Optional[ModelConfig] = None, *,
                positions: Optional[torch.Tensor] = None, cache: Optional[List[Cache]] = None,
                cache_index: Optional[Index] = None, link_fn=None, frontend_embed: Optional[torch.Tensor] = None,
                route_rows: bool = False, return_aux: bool = False):
        """Logits (B, S, V) in f32, or (logits, aux) with ``return_aux``;
        ``cache`` (if any) is written in place.  Per-row ``cache_index``
        lengths (a tensor or ``PagedIndex``) need explicit positions ((B, S),
        or (B, 3, S) under M-RoPE).  ``frontend_embed`` (B, F, d) replaces
        the first F embeddings of a frontend config; ``route_rows`` routes
        each batch row as its own MoE group (the contiguous slot pool)."""
        cfg = cfg or self.cfg
        b, s = tokens.shape
        x = self.lookup(tokens, cfg.vocab_size)
        if cfg.embed_scale:
            x = x * scalar_as(float(np.sqrt(np.float32(cfg.d_model))), x.dtype)
        if cfg.frontend and frontend_embed is not None:
            x = fuse_frontend(self.frontend, x, frontend_embed)
        if positions is None:
            if torch.is_tensor(cache_index) or isinstance(cache_index, PagedIndex):
                raise ValueError("per-row cache_index lengths need explicit positions")
            positions = rope_lib.default_positions(b, s, offset=cache_index or 0, mrope=bool(cfg.mrope_sections),
                                                   device=tokens.device)
        x, aux = self.stack(x, cfg, positions, cache=cache, cache_index=cache_index, link_fn=link_fn,
                            route_rows=route_rows)
        x = self.final_norm(x)
        logits = (x @ self.embed.T if self.lm_head is None else x @ self.lm_head).to(acc_dtype(x))
        return (logits, aux) if return_aux else logits


    def lookup(self, tokens: torch.Tensor, vocab_size: int) -> torch.Tensor:
        """The embeddings of ``tokens``; from a vocabulary slice, summed over
        ``model``."""
        rows = self.embed.shape[0]
        if rows == vocab_size:
            return self.embed[tokens]
        local = tokens.long() - shard_ctx.model_rank() * rows
        inside = ((local >= 0) & (local < rows))[..., None]
        x = self.embed[torch.where(inside[..., 0], local, 0)]
        return shard_ctx.sum_over_model(torch.where(inside, x, torch.zeros((), dtype=x.dtype, device=x.device)))


def init_lm(cfg: ModelConfig, seed: int = 0, device="cuda") -> LM:
    """Random weights from ``seed`` with the reference's shapes and scales:
    truncated-normal fan-in matrices, 0.02 embeddings, zero norms and
    biases, quantization range [-6, 6].  (torch's generator, not jax's, so
    the values differ from ``repro.models.lm.init_lm``; tests load the
    reference's weights through ``repro_torch.params`` instead.)"""
    model = LM(cfg, device=device)
    gen = torch.Generator(device=model.embed.device)
    gen.manual_seed(seed)
    model.reset_parameters(gen)
    return model


def link_spec_from_config(cfg: ModelConfig, loss_rate: Optional[float] = None, **overrides) -> comtune.LinkSpec:
    """The ``LinkSpec`` a model config implies (compressor left at its
    default: the calibrated one lives in ``model.link``)."""
    link = cfg.link
    kw = dict(
        dropout_rate=link.dropout_rate,
        loss_rate=link.loss_rate if loss_rate is None else loss_rate,
        train_link=link.train_link,
        channel=link.channel,
        channel_params=tuple(link.channel_params),
        shuffle=link.shuffle,
        fec_k=link.fec_k,
        fec_m=link.fec_m,
        fec_kind=link.fec_kind,
    )
    kw.update(overrides)
    return comtune.LinkSpec(**kw)


def make_link_fn(cfg: ModelConfig, model: LM, key: Optional[torch.Tensor], mode: str,
                 loss_rate: Optional[float] = None, link_spec: Optional[comtune.LinkSpec] = None,
                 link_rate=None):
    """The function applied at the split point: ``emulate_link`` under the
    calibrated compressor held in ``model.link``.  mode: train (Eq. 8) /
    serve (Eq. 12) / clean / off.  ``link_rate`` (a float or a 0-d tensor,
    the per-step curriculum's rate) overrides the current mode's emulation
    rate: the train emulation's (``with_train_rate``) in train mode, the
    channel loss rate otherwise."""
    if mode == "off":
        return None
    spec = _calibrated_spec(cfg, model, loss_rate, link_spec)
    if link_rate is not None:
        spec = spec.with_train_rate(link_rate) if mode == "train" else spec.with_channel_loss_rate(link_rate)

    def fn(x):
        return comtune.emulate_link(key, x, spec, mode)

    return fn


def _calibrated_spec(cfg: ModelConfig, model: LM, loss_rate: Optional[float],
                     link_spec: Optional[comtune.LinkSpec]) -> comtune.LinkSpec:
    """The link spec (from ``cfg`` unless given, with ``loss_rate`` applied)
    under the calibrated compressor held in ``model.link``."""
    if link_spec is None:
        link_spec = link_spec_from_config(cfg, loss_rate=loss_rate)
    elif loss_rate is not None:
        link_spec = link_spec.with_channel_loss_rate(loss_rate)
    return dataclasses.replace(link_spec, compressor=model.link.compressor(cfg))


def make_slotwise_link_fn(cfg: ModelConfig, model: LM, keys: torch.Tensor, mode: str,
                          loss_rate: Optional[float] = None, link_spec: Optional[comtune.LinkSpec] = None,
                          live: Optional[torch.Tensor] = None):
    """Per-slot link for a batched decode step (twin of
    ``repro.models.lm.make_slotwise_link_fn``): row ``i`` of the split
    activation ``(B, S, d)`` goes through ``emulate_link`` alone, under its
    own key ``keys[i]`` -- bitwise the draws of a batch-1 round with that
    key.  ``loss_rate`` and ``link_spec`` act as in ``make_link_fn``.

    Each row draws under a link tap of its own (``obs.device``); while a
    collector is installed, the rows' statistics are re-published to it
    weighted by ``live`` ((B,) bool; all ones when None): dead slots still
    compute, but never count, as in the reference."""
    if mode == "off":
        return None
    spec = _calibrated_spec(cfg, model, loss_rate, link_spec)

    def fn(x):
        rows, taps = [], []
        for i in range(x.shape[0]):
            with obs_device.tap_link_stats() as tap:
                rows.append(comtune.emulate_link(keys[i], x[i:i + 1], spec, mode))
            taps.append(tap)
        obs_device.emit_rows(taps, live, x.device)
        return torch.cat(rows)

    return fn


def forward(model: LM, tokens: torch.Tensor, cfg: Optional[ModelConfig] = None, *,
            positions=None, frontend_embed=None, cache=None, cache_index=None, link_key=None,
            link_mode: str = "off", loss_rate: Optional[float] = None, link_spec=None, link_rate=None,
            link_fn=None):
    """``repro.models.lm.forward``'s signature: returns (logits f32, cache, aux)
    with ``aux`` the f32 sum of the MoE layers' load-balance terms (0 for a
    dense stack).  ``link_mode="train"`` is the fine-tuning graph;
    ``link_rate`` as in :func:`make_link_fn`.  (The reference's ``mode``
    argument only switches its rematerialisation in training, which the
    port does not do: the card holds the activations.)"""
    cfg = cfg or model.cfg
    if link_fn is None:
        link_fn = make_link_fn(cfg, model, link_key, link_mode, loss_rate=loss_rate, link_spec=link_spec,
                               link_rate=link_rate)
    logits, aux = model(tokens, cfg, positions=positions, cache=cache, cache_index=cache_index, link_fn=link_fn,
                        frontend_embed=frontend_embed, return_aux=True)
    return logits, cache, aux


def token_nll(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """(B, S - 1) next-token negative log-likelihoods, as the reference's
    ``lm_loss`` forms them: f32 logsumexp around the stop-gradient row
    max, minus the target logit (the reference's one-hot contraction, here
    a gather, which gives the same f32 value)."""
    targets = tokens[:, 1:].long()
    lg = logits[:, :-1].to(acc_dtype(logits))
    m = lg.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(lg - m), dim=-1)) + m[..., 0]
    return lse - torch.gather(lg, -1, targets[..., None])[..., 0]


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor, aux: torch.Tensor, aux_coef: float) -> torch.Tensor:
    """Next-token cross entropy (shift by one) plus the MoE load-balance
    term (twin of ``repro.models.lm.lm_loss``)."""
    return token_nll(logits, tokens).mean() + aux_coef * aux
