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

Sharded steps (twin of ``steps.py:244-400``, ``build_sharded_step``):
each of these steps also runs on each rank of a ``launch.mesh.Mesh`` when
its state is a ``sharding.fsdp.ShardedModel`` (:func:`shard_model`: the
model held as the rank's shards under ``rules.param_pspecs``), which
decides the placement and the MoE's form once.  Every rank passes the same
*global* batch and takes its ``data`` rows (``rules.token_pspec``; the same
rows on every ``model`` rank); it all-gathers the parameters its shards
hold, and the split link and the dense MoE take the global rows
(``sharding.ctx.use_batch_shard``: the link's masks and the MoE's routing
are the unsharded step's), or the MoE its expert-parallel form
(``moe_shard_map``; prefill and train only: decode keeps the dense form,
as the reference does).

* The train step's loss is its rows' share of the global mean NLL plus
  ``1 / n_data`` of the load-balance term, so the ranks' losses and
  gradients sum over ``data`` to the unsharded step's; gradients are
  reduce-scattered (or all-reduced) back to the shards and Adam updates
  them with the global norm's clip.  Its compute over ``model`` is
  repeated on each ``model`` rank on gathered parameters.
* The prefill and decode steps compute over ``model`` where the
  parameters are stored (``shard_model(tensor_parallel=True)``, which
  :func:`build_sharded_step`'s ``fn.place`` calls; the counterpart of the
  reference's GSPMD partitioning): attention whose KV heads ``model``
  divides takes the rank's heads and a cache of its KV heads (B3 and B1
  on them), the dense MLPs the rank's ``d_ff`` slice, the embedding and
  the head the rank's vocabulary slice, each summed over ``model`` where
  the reference's program reduces; the logits come back as the rank's
  rows and vocabulary slice (``rules.logits_spec``), and
  :func:`greedy_tokens` takes the argmax over the whole vocabulary.  The
  dense MoE's experts, where ``model`` divides their count, are computed
  where stored too: every ``model`` rank routes the global rows, runs its
  ``E / m`` experts and the partial outputs are summed over ``model``
  (``models.moe``).  The rest (Mamba, mLSTM, sLSTM, the MoE whose experts
  ``model`` does not divide, attention whose KV heads ``model`` does not
  divide) runs on gathered parameters, its cache leaves placed on
  ``model`` by ``rules.cache_pspecs`` gathered for the step and cut back
  after it when ``model`` is wider than one rank (ROADMAP A13d).
* Where the batch cannot be split over the data axes (``long_500k``),
  ``rules.cache_pspecs`` puts an attention layer's KV sequence on them:
  each such layer gets a ``sharding.ctx.ContextShard`` (context-parallel
  decode: the rank's rows of the cache, flash decode's partials merged
  across the data ranks, ``models.attention``).

On a world of one every collective returns its input and every added
factor is 1.0: each sharded step is the unsharded one bit for bit.
:func:`build_sharded_step` builds any kind for an (architecture x shape)
pair with its abstract arguments on ``meta``, the rank's shards: the dry
run (``launch.dryrun``) traces it on a placeholder mesh.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import cache as cache_lib
from repro_torch.models import lm
from repro_torch.models.attention import Attention
from repro_torch.models.mlp import MLP
from repro_torch.obs import device as obs_device
from repro_torch.optim import AdamConfig, AdamState, adam_update, init_adam
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
        if isinstance(state, ShardedModel) and _computes_model_slices(state):
            raise NotImplementedError("the train step computes over 'model' on gathered parameters: shard the model "
                                      "with tensor_parallel=False (tensor-parallel training is ROADMAP A13d)")
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
        data = rules.data_axes(mesh)
        self.sharded, self.mesh, self.data = sharded, mesh, mesh.group(data)
        n_rows, n_data = batch["tokens"].shape[0], mesh.size_of(data)
        self.shard = shard_ctx.BatchShard(mesh, rules.batch_spec(mesh, n_rows))
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
        return _global_rows_link(fn, self.shard)

    def loss(self, logits, aux, aux_coef):
        return lm.token_nll(logits, self.rows["tokens"]).mean() * self.weight + (aux_coef * aux) * self.aux_weight

    def reduce(self, grads):
        grads = self.sharded.reduce_grads(grads)
        self.sharded.release()
        return grads, self.sharded.shards, self.sharded.reduce_partials

    def total(self, loss):
        return comm.all_reduce_(loss.clone(), self.data)


def _global_rows_link(fn, shard: shard_ctx.BatchShard):
    """``fn`` (the split link) on the global rows: the masks are the global
    activation's, so gather the rows, draw and apply the link as the
    unsharded step does, and keep this rank's."""
    if fn is None or not shard.split:
        return fn

    def global_rows(x):
        return shard.mine(fn(comm.gather_rows(x, shard.group())))

    return global_rows


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


def shard_model(model: lm.LM, cfg: ModelConfig, mesh, fsdp="on", moe_shard_map: bool = False,
                tensor_parallel: bool = False) -> ShardedModel:
    """``model`` held as this rank's shards under ``rules.param_pspecs(fsdp)``
    over ``mesh``: the state of the sharded steps.  With ``moe_shard_map``
    the train and prefill steps run the expert-parallel MoE.  With
    ``moe_shard_map`` or ``tensor_parallel`` the experts stay where they are
    stored along ``model`` when ``model`` divides their count
    (``models.moe.MoE.forward``'s test).  With ``tensor_parallel`` (the
    prefill and decode steps) the attention layers whose KV heads ``model``
    divides, the dense MLPs and, when ``model`` divides the vocabulary, the
    embedding and the head are computed where they are stored along
    ``model`` too.  A model to train must require grad."""
    specs = rules.param_pspecs(dict(model.named_parameters()), mesh, fsdp=fsdp)
    local = {}
    if (moe_shard_map or tensor_parallel) and cfg.num_experts and cfg.num_experts % mesh.shape["model"] == 0:
        local = {n: ("model",) for n in _expert_names({n: p.shape for n, p in model.named_parameters()})}
    if tensor_parallel:
        local.update({n: ("model",) for n in _tensor_parallel_names(model, cfg, mesh)})
    return ShardedModel(model, mesh, specs, local, moe_shard_map=moe_shard_map)


def _computes_model_slices(state: ShardedModel) -> bool:
    """Whether a layer other than the experts computes on its slice along a
    ``model`` axis wider than one (a ``tensor_parallel`` state)."""
    if state.mesh.size_of("model") == 1:
        return False
    experts = set(_expert_names(state.specs))
    return any(pairs for n, pairs in state.local.items() if n not in experts)


def _expert_names(shapes: Dict[str, Any]) -> List[str]:
    """The MoE's expert tensors among ``name -> shape`` (or spec)."""
    return [n for n, s in shapes.items() if n.split(".")[-1] in ("w_up", "w_gate", "w_down") and len(s) == 3]


def _tensor_parallel_names(model: lm.LM, cfg: ModelConfig, mesh) -> List[str]:
    """The parameters the serving steps compute where stored along
    ``model``."""
    m = mesh.shape["model"]
    names = []
    if rules.logits_spec(cfg, mesh, 1)[1] == "model":
        names += ["embed"] + (["lm_head"] if model.lm_head is not None else [])
    for i, layer in enumerate(model.stack.layers):
        if isinstance(layer.mix, Attention) and cfg.num_kv_heads % m == 0:
            names += [f"stack.layers.{i}.mix.{n}" for n, _ in layer.mix.named_parameters()]
        if isinstance(layer.ffn, MLP):
            names += [f"stack.layers.{i}.ffn.{n}" for n, _ in layer.ffn.named_parameters()]
    return names


class _ServeView:
    """One prefill or decode step's view of its state.  Unsharded: the
    model, the whole batch and the cache as given (no collective).  On a
    ``ShardedModel``: the parameters gathered but for the ``model`` slices
    computed where stored, this rank's rows, the link on the global rows,
    the cache leaves placed on ``model`` of the layers computed whole
    gathered for the step and cut back after it, and a ``ContextShard``
    for each attention layer whose cache puts its KV sequence on the data
    axes."""

    def __init__(self, state, cfg: ModelConfig, n_rows: int, cache_specs, decode: bool):
        self.sharded = state if isinstance(state, ShardedModel) else None
        if self.sharded is None:
            if cache_specs is not None:
                raise TypeError("a sharded serving step takes a ShardedModel: place the model with its "
                                "build_sharded_step function's place(model)")
            self.model, self.shard = state, None
            return
        if cache_specs is None:
            raise ValueError("a sharded serving step needs its cache's placement: build it with "
                             "launch.steps.build_sharded_step")
        mesh = state.mesh
        self.model, self.mesh, self.cache_specs, self.decode = state.model, mesh, cache_specs, decode
        self.shard = shard_ctx.BatchShard(mesh, rules.batch_spec(mesh, n_rows))
        self.local_layers = {i for i in range(len(cfg.all_layers())) if state.local.get(f"stack.layers.{i}.mix.wk")}
        self.model_split = mesh.size_of("model") > 1
        # The attention layers whose KV sequence sits on the data axes.
        self.seq_axes = {i: specs["k"][1] for i, (spec, specs) in enumerate(zip(cfg.all_layers(), cache_specs))
                         if spec.kind == "attn" and specs["k"][1] is not None}

    def _context_shards(self, cache) -> Dict[Any, shard_ctx.ContextShard]:
        layers = self.model.stack.layers
        return {layers[i].mix: shard_ctx.ContextShard(self.mesh, axes, cache[i]["k"].shape[1])
                for i, axes in self.seq_axes.items()}

    @contextlib.contextmanager
    def scope(self, batch: Dict[str, Any], cache):
        """Yields (model, this rank's batch rows, the cache to compute on)."""
        if self.sharded is None:
            yield self.model, batch, cache
            return
        self.sharded.gather()
        try:
            work = self._open(cache)
            with contextlib.ExitStack() as ctx:
                moe_mesh = self.mesh if self.sharded.moe_shard_map and not self.decode else None
                ctx.enter_context(shard_ctx.use_shard_map_mesh(moe_mesh))
                ctx.enter_context(shard_ctx.use_batch_shard(self.shard))
                ctx.enter_context(shard_ctx.use_tensor_parallel(self.mesh))
                ctx.enter_context(shard_ctx.use_context_shards(self._context_shards(work)))
                yield self.model, {k: self.shard.mine(v) for k, v in batch.items()}, work
            self._close(cache, work)
        finally:
            self.sharded.release()

    def link(self, fn):
        return fn if self.shard is None else _global_rows_link(fn, self.shard)

    def _gathered_dims(self, i: int, spec) -> List[int]:
        """The dims of layer ``i``'s cache leaf gathered over ``model`` for
        the step: none on a ``model`` axis of one rank, which splits
        nothing."""
        if not self.model_split or i in self.local_layers:
            return []
        return [d for d, e in enumerate(spec) if e == "model"]

    def _open(self, cache):
        group = self.mesh.group("model")
        work = []
        for i, (layer, specs) in enumerate(zip(cache, self.cache_specs)):
            out = {}
            for name, t in layer.items():
                for d in self._gathered_dims(i, specs[name]):
                    t = comm.all_gather_along(t, group, d)
                out[name] = t
            work.append(out)
        return work

    @torch.no_grad()
    def _close(self, cache, work) -> None:
        m, r = self.mesh.shape["model"], self.mesh.coordinate()["model"]
        for i, (layer, specs) in enumerate(zip(cache, self.cache_specs)):
            for name, t in layer.items():
                dims = self._gathered_dims(i, specs[name])
                if not dims:
                    continue
                full = work[i][name]
                for d in dims:
                    n = full.shape[d] // m
                    full = full.narrow(d, r * n, n)
                t.copy_(full)


def make_prefill_step(cfg: ModelConfig, link_mode: str = "serve", link_spec=None, cache_specs=None):
    """Builds the cache from a prompt; the prompt activation crosses the
    lossy link once, streamed as per-token rounds.  ``link_spec`` (a full
    ``LinkSpec``, e.g. ``use_kernel=True``) overrides the one ``cfg.link``
    implies; a frontend config's ``batch["frontend_embed"]``, when given,
    replaces the first embeddings.

    ``prefill_step(state, batch, cache, key) -> (logits, cache)``: the last
    position's logits and the cache, written in place.  ``state`` is the
    model, or a ``ShardedModel`` with ``cache`` this rank's cache shards
    under ``cache_specs`` (``rules.cache_pspecs``; module notes)."""

    def prefill_step(state, batch: Dict[str, Any], cache, key):
        view = _ServeView(state, cfg, batch["tokens"].shape[0], cache_specs, decode=False)
        with view.scope(batch, cache) as (model, rows, work):
            link_fn = view.link(lm.make_link_fn(cfg, model, key, link_mode, link_spec=link_spec))
            logits, _, _ = lm.forward(model, rows["tokens"], cfg, frontend_embed=rows.get("frontend_embed"),
                                      cache=work, cache_index=0, link_fn=link_fn)
        return logits[:, -1], cache

    return prefill_step


def make_serve_step(cfg: ModelConfig, link_mode: str = "serve", link_spec=None, cache_specs=None):
    """One DI decode round (paper Eq. 12): ``serve_step(state, token, cache,
    index, key) -> (logits, cache)``; ``link_spec``, ``state`` and
    ``cache_specs`` as in :func:`make_prefill_step`."""

    def serve_step(state, token, cache, index: int, key):
        view = _ServeView(state, cfg, token.shape[0], cache_specs, decode=True)
        with view.scope({"tokens": token}, cache) as (model, rows, work):
            link_fn = view.link(lm.make_link_fn(cfg, model, key, link_mode, link_spec=link_spec))
            logits, _, _ = lm.forward(model, rows["tokens"], cfg, cache=work, cache_index=index, link_fn=link_fn)
        return logits[:, 0], cache

    return serve_step


def greedy_tokens(logits: torch.Tensor, cfg: ModelConfig, mesh=None) -> torch.Tensor:
    """(B, 1) int32 greedy tokens of (B, V) logits, or of the rank's
    vocabulary slice (B, V / m) of the sharded steps: each ``model`` rank
    takes its slice's first maximum, the ranks' (value, global index) pairs
    are all-gathered over ``model`` and the first rank holding the largest
    value wins, so the token is ``argmax`` over the whole vocabulary, its
    first maximum included."""
    if logits.shape[-1] == cfg.vocab_size:
        return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    group = mesh.group("model")
    idx = torch.argmax(logits, dim=-1)
    val = torch.gather(logits, -1, idx[:, None])[:, 0]
    idx = idx + mesh.coordinate()["model"] * logits.shape[-1]
    vals = comm.all_gather_along(val[None], group)
    idxs = comm.all_gather_along(idx[None], group)
    best = torch.argmax(vals, dim=0)
    return torch.gather(idxs, 0, best[None])[0][:, None].to(torch.int32)


# ---------------------------------------------------------------------------
# Abstract inputs and the sharded step builder
# ---------------------------------------------------------------------------

def abstract_params(cfg: ModelConfig) -> lm.LM:
    """The model on ``meta``: its parameters' names, shapes and dtypes, no
    allocation."""
    return lm.LM(cfg, device="meta")


def batch_specs(cfg: ModelConfig, shape_cfg: ShapeConfig) -> Dict[str, torch.Tensor]:
    """The step's global batch on ``meta``."""
    b, s = shape_cfg.global_batch, shape_cfg.seq_len
    out = {"tokens": torch.empty((b, s), dtype=torch.int32, device="meta")}
    if cfg.frontend and shape_cfg.kind != "decode":
        out["frontend_embed"] = torch.empty((b, cfg.frontend_len, cfg.d_model), dtype=torch.bfloat16, device="meta")
    return out


def _key():
    return torch.empty((2,), dtype=torch.int64, device="meta")


def input_specs(cfg: ModelConfig, shape_cfg: ShapeConfig, adam_cfg: Optional[AdamConfig] = None) -> Tuple[Tuple, str]:
    """(unsharded abstract args on ``meta``, step kind) for the (arch x
    shape) pair: train ``(model, opt_state, batch, key)``, prefill
    ``(model, batch, cache, key)``, decode ``(model, token, cache, index,
    key)`` with ``index`` the last row of the cache."""
    model = abstract_params(cfg)
    b, s = shape_cfg.global_batch, shape_cfg.seq_len
    if shape_cfg.kind == "train":
        model.requires_grad_(True)
        opt = init_adam(dict(model.named_parameters()), adam_cfg or AdamConfig())
        return (model, opt, batch_specs(cfg, shape_cfg), _key()), "train"
    cache = cache_lib.cache_spec(cfg, b, s)
    if shape_cfg.kind == "prefill":
        return (model, batch_specs(cfg, shape_cfg), cache, _key()), "prefill"
    token = torch.empty((b, 1), dtype=torch.int32, device="meta")
    return (model, token, cache, s - 1, _key()), "decode"


def _cut_leaf(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    for d, axes in enumerate(spec):
        if axes is not None:
            n = t.shape[d] // mesh.size_of(axes)
            t = t.narrow(d, mesh.index_of(axes) * n, n)
    return t


def shard_cache(cache, cache_specs, mesh) -> List[Dict[str, torch.Tensor]]:
    """This rank's stored slices (copies) of a whole cache."""
    return [{n: _cut_leaf(t, specs[n], mesh).clone() for n, t in layer.items()} for layer, specs in zip(cache, cache_specs)]


def init_cache_shards(cfg: ModelConfig, shape_cfg: ShapeConfig, mesh, device="cuda") -> List[Dict[str, torch.Tensor]]:
    """This rank's cache shards under ``rules.cache_pspecs``, at
    ``init_cache``'s values (only the shards are allocated)."""
    specs = rules.cache_pspecs(cfg, shape_cfg, mesh)
    whole = cache_lib.cache_spec(cfg, shape_cfg.global_batch, shape_cfg.seq_len)
    out = [{n: torch.empty(_cut_leaf(t, s[n], mesh).shape, dtype=t.dtype, device=device) for n, t in layer.items()}
           for layer, s in zip(whole, specs)]
    return cache_lib.reset_cache(out, cfg)


def build_sharded_step(cfg: ModelConfig, shape_cfg: ShapeConfig, mesh, adam_cfg: Optional[AdamConfig] = None,
                       link_mode: Optional[str] = None, link_spec=None, fsdp="on", moe_shard_map: bool = False):
    """(fn, abstract_args) for the (arch x shape) pair on ``mesh``, with the
    reference's signature.  ``fn`` is this rank's step: the train kind
    :func:`make_train_step`, prefill :func:`make_prefill_step` (the last
    position's logits and the cache), decode :func:`make_serve_step`, each
    on a :func:`shard_model` state (train: ``tensor_parallel=False``;
    prefill and decode: ``True``) under ``rules.param_pspecs(fsdp)``, its
    cache under ``rules.cache_pspecs`` and its logits under
    ``rules.logits_spec``.  ``fn.place(model)`` holds a real model as that
    state (this rank's shards).  ``abstract_args`` are this rank's
    arguments on ``meta``: the sharded state, the optimizer state over its
    shards (train), the global batch (each rank takes its rows), the cache
    shards (a KV sequence on the data axes: the rank's rows of it), the
    last cache row as the decode index, and a key."""
    adam_cfg = adam_cfg or AdamConfig(state_dtype="bfloat16")
    args, kind = input_specs(cfg, shape_cfg, adam_cfg)
    place = functools.partial(shard_model, cfg=cfg, mesh=mesh, fsdp=fsdp, moe_shard_map=moe_shard_map,
                              tensor_parallel=kind != "train")
    state = place(args[0])
    if kind == "train":
        fn = make_train_step(cfg, adam_cfg, link_mode=link_mode or "train", link_spec=link_spec)
        abstract = (state, init_adam(state.shards, adam_cfg)) + args[2:]
    else:
        c_spec = rules.cache_pspecs(cfg, shape_cfg, mesh)
        cache = shard_cache(args[2], c_spec, mesh)
        if kind == "prefill":
            fn = make_prefill_step(cfg, link_mode=link_mode or "serve", link_spec=link_spec, cache_specs=c_spec)
            abstract = (state, args[1], cache, args[3])
        else:
            fn = make_serve_step(cfg, link_mode=link_mode or "serve", link_spec=link_spec, cache_specs=c_spec)
            abstract = (state, args[1], cache) + args[3:]
    fn.place = place
    return fn, abstract


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
