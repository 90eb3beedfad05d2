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

The sharded trainer (twin of ``steps.py:308-470``, the train kind): the
same step and epoch run on each rank of a ``launch.mesh.Mesh`` when their
state is a ``sharding.fsdp.ShardedModel`` (``shard_model``: the model held
as the rank's shards under ``rules.param_pspecs``), which decides the
placement and the MoE's form once.  Each rank takes its ``data`` rows of the
global batch (``rules.token_pspec``; the same rows on every ``model``
rank), all-gathers the parameters its shards hold, and runs the forward
with the split link and the dense MoE over the global rows
(``sharding.ctx.use_batch_shard``: the link's masks and the MoE's routing
are the unsharded step's), or the expert-parallel MoE (``moe_shard_map``).
Its loss is its rows' share of the global mean NLL plus ``1 / n_data`` of
the load-balance term, so the ranks' losses and gradients sum over
``data`` to the unsharded step's; gradients are reduce-scattered (or
all-reduced) back to the shards and Adam updates the shards with the
global norm's clip.  On a world of one every collective returns its input
and every added factor is 1.0: the step is the unsharded one bit for bit.
The reference's ``build_sharded_step`` / ``build_sharded_epoch`` of the
train kind are ``shard_model`` and these builders; their prefill and decode
kinds, and tensor-parallel compute over ``model``, are ROADMAP A13b (dense
parameters placed on ``model`` are gathered and their compute repeated on
every ``model`` rank).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.obs import device as obs_device
from repro_torch.optim import AdamConfig, AdamState, adam_update
from repro_torch.sharding import comm, rules
from repro_torch.sharding import ctx as shard_ctx
from repro_torch.sharding.fsdp import ShardedModel

# The link counters of a train step's metrics (and of an epoch's).
LINK_KEYS = ("link_elems", "link_dropped", "fec_recovered_packets")


def make_train_step(cfg: ModelConfig, adam_cfg: AdamConfig, link_mode: str = "train", link_spec=None):
    """COMtune fine-tuning step; ``link_mode="off"`` is the 'previous DI'
    baseline.  ``link_spec`` (a full ``LinkSpec``) selects the train-time
    emulation (Eq. 7 dropout or the deployment channel); None derives it
    from ``cfg.link``.  A ``batch["link_rate"]`` 0-d tensor, when present,
    overrides the emulation rate (the per-step curriculum); a frontend
    config's ``batch["frontend_embed"]`` (B, F, d) replaces the first
    embeddings, as the reference's step passes it.

    ``train_step(state, opt_state, batch, key) -> (state, opt_state,
    metrics)`` updates the parameters in place.  ``state`` is the model
    (``lm.LM``, its parameters requiring grad) or, for the sharded trainer,
    a ``ShardedModel`` from :func:`shard_model` with ``opt_state`` over its
    shards: each rank then passes the same *global* batch and trains on its
    rows (module notes).  ``metrics``: ``loss``, ``grad_norm`` and the
    ``LINK_KEYS`` counters of the emulated link's draws (what its masks
    dropped this step, from a link tap), all global."""

    def train_step(state, opt_state: AdamState, batch: Dict[str, Any], key):
        part = _Shards(state, batch) if isinstance(state, ShardedModel) else _Whole(state, batch)
        model, params, rows = part.model, part.params, part.rows
        with part.scope():
            with obs_device.tap_link_stats() as tap:
                link_fn = lm.make_link_fn(cfg, model, key, link_mode, link_spec=link_spec,
                                          link_rate=batch.get("link_rate"))
                logits, _, aux = lm.forward(model, rows["tokens"], cfg, frontend_embed=rows.get("frontend_embed"),
                                            link_fn=part.link(link_fn))
            link = tap.totals(logits.device)
            loss = part.loss(logits, aux, cfg.router_aux_coef)
            del logits
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        # A parameter the loss does not reach (the link's quantization range,
        # behind the straight-through estimator) gets the reference's zero
        # gradient.
        grads = {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(params.items(), grads)}
        grads, target, norm_reduce = part.reduce(grads)
        _, opt_state, gnorm = adam_update(grads, target, opt_state, adam_cfg, norm_reduce=norm_reduce)
        return state, opt_state, {"loss": part.total(loss.detach()), "grad_norm": gnorm,
                                  "link_elems": link["elems"], "link_dropped": link["dropped"],
                                  "fec_recovered_packets": link["fec_recovered"]}

    return train_step


class _Whole:
    """One train step's view of an unsharded model: the whole batch and
    model, no collective (each of :class:`_Shards`' hooks as the
    identity)."""

    def __init__(self, model: lm.LM, batch: Dict[str, Any]):
        self.model, self.rows = model, batch
        self.params = dict(model.named_parameters())

    def scope(self):
        return contextlib.nullcontext()

    def link(self, fn):
        return fn

    def loss(self, logits, aux, aux_coef):
        return lm.lm_loss(logits, self.rows["tokens"], aux, aux_coef)

    def reduce(self, grads):
        """(gradients, the tensors Adam updates, the clip norm's reduce)."""
        return grads, self.params, None

    def total(self, loss):
        return loss


class _Shards(_Whole):
    """One train step's view of a ``ShardedModel`` on this rank: its
    ``data`` rows of the global batch (``rules.batch_spec``; every data rank
    holds them all when they do not divide), the parameters all-gathered for
    the compute, the link's masks drawn on the global activation, the loss
    its rows' share of the global one, the gradients brought back to the
    shards and the clip's norm summed over the mesh."""

    def __init__(self, sharded: ShardedModel, batch: Dict[str, Any]):
        mesh = sharded.mesh
        self.sharded, self.mesh, self.data = sharded, mesh, mesh.group("data")
        n_rows, n_data = batch["tokens"].shape[0], mesh.shape["data"]
        self.shard = shard_ctx.BatchShard(mesh, rules.batch_spec(mesh, n_rows) is not None)
        rows = {k: self.shard.mine(v) for k, v in batch.items() if k in ("tokens", "frontend_embed")}
        # This rank's rows' share of the global token mean; the load-balance
        # term, computed whole on every data rank, a 1 / n_data share.
        self.weight = rows["tokens"].shape[0] / n_rows if self.shard.split else 1.0 / n_data
        self.aux_weight = 1.0 / n_data
        sharded.gather()
        self.model, self.rows, self.params = sharded.model, rows, sharded.params

    def scope(self):
        ctx = contextlib.ExitStack()
        ctx.enter_context(shard_ctx.use_shard_map_mesh(self.mesh if self.sharded.moe_shard_map else None))
        ctx.enter_context(shard_ctx.use_batch_shard(self.shard))
        return ctx

    def link(self, fn):
        if fn is None or not self.shard.split:
            return fn

        def global_rows(x):
            # The masks are the global activation's: gather the rows, draw
            # and apply the link as the unsharded step does, keep ours.
            return self.shard.mine(fn(comm.gather_rows(x, self.data)))

        return global_rows

    def loss(self, logits, aux, aux_coef):
        return lm.token_nll(logits, self.rows["tokens"]).mean() * self.weight + (aux_coef * aux) * self.aux_weight

    def reduce(self, grads):
        grads = self.sharded.reduce_grads(grads)
        self.sharded.release()
        return grads, self.sharded.shards, self.sharded.reduce_partials

    def total(self, loss):
        return comm.all_reduce_(loss.clone(), self.data)


def make_train_epoch(cfg: ModelConfig, adam_cfg: AdamConfig, link_mode: str = "train", link_spec=None):
    """K train steps on the reference's key chain.  ``epoch_fn(state,
    opt_state, batches, key) -> (state, opt_state, key, metrics)``, with
    ``state`` as :func:`make_train_step`'s: ``batches`` holds ``tokens``
    (K, B, S) and optionally ``link_rate`` (K,) (the per-step curriculum)
    and ``frontend_embed`` (K, B, F, d); ``metrics`` holds (K,) ``loss``,
    ``grad_norm`` and ``LINK_KEYS`` tensors, read by the caller only where
    it logs; the returned key continues the chain, so consecutive epochs
    compose to one long loop."""
    step = make_train_step(cfg, adam_cfg, link_mode=link_mode, link_spec=link_spec)
    keys = ("loss", "grad_norm") + LINK_KEYS

    def epoch_fn(state, opt_state: AdamState, batches: Dict[str, torch.Tensor], key: torch.Tensor):
        out = {k: [] for k in keys}
        for i in range(batches["tokens"].shape[0]):
            key, sub = prng.split(key)
            state, opt_state, metrics = step(state, opt_state, {k: v[i] for k, v in batches.items()}, sub)
            for k in keys:
                out[k].append(metrics[k])
        return state, opt_state, key, {k: torch.stack(v) for k, v in out.items()}

    return epoch_fn


def shard_model(model: lm.LM, cfg: ModelConfig, mesh, fsdp="on", moe_shard_map: bool = False) -> ShardedModel:
    """``model`` held as this rank's shards under ``rules.param_pspecs(fsdp)``
    over ``mesh``: the state of the sharded train step and epoch.  With
    ``moe_shard_map`` the step runs the expert-parallel MoE, and the experts
    stay where they are stored along ``model`` when ``model`` divides their
    count (``models.moe.MoE.forward``'s test).  The model's parameters must
    require grad."""
    specs = rules.param_pspecs(dict(model.named_parameters()), mesh, fsdp=fsdp)
    local = {}
    if moe_shard_map and cfg.num_experts and cfg.num_experts % mesh.shape["model"] == 0:
        local = {n: ("model",) for n, p in model.named_parameters()
                 if n.split(".")[-1] in ("w_up", "w_gate", "w_down") and p.dim() == 3}
    return ShardedModel(model, mesh, specs, local, moe_shard_map=moe_shard_map)


def make_prefill_step(cfg: ModelConfig, link_mode: str = "serve", link_spec=None):
    """Builds the cache from a prompt; the prompt activation crosses the
    lossy link once, streamed as per-token rounds.  ``link_spec`` (a full
    ``LinkSpec``, e.g. ``use_kernel=True``) overrides the one ``cfg.link``
    implies; a frontend config's ``batch["frontend_embed"]``, when given,
    replaces the first embeddings."""

    def prefill_step(model: lm.LM, batch: Dict[str, Any], cache, key):
        logits, cache, _ = lm.forward(model, batch["tokens"], cfg, frontend_embed=batch.get("frontend_embed"),
                                      cache=cache, cache_index=0, link_key=key, link_mode=link_mode,
                                      link_spec=link_spec)
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
