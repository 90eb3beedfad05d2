"""Top-k Mixture-of-Experts FFN with sort-based capacity dispatch (twin of
``repro/models/moe.py:moe_forward_dense``, with ``init_moe`` and
``_capacity``).

1. f32 router softmax; the top ``k`` experts a token from a stable
   descending sort, so that ties go to the lower expert id as
   ``jax.lax.top_k`` breaks them; the ``k`` gates renormalised;
2. the Switch load-balance term ``E * sum_e f_e P_e`` (f_e the share of
   tokens whose first choice is e, P_e the mean router probability);
3. the (token, choice) assignments sorted by expert id (stable), each
   expert taking its first ``capacity`` of them: the rest are dropped;
4. the ``(E, C, d)`` expert inputs gathered (zeros where an expert has
   fewer than C tokens) and the experts run as batched products
   (``torch.bmm``, as the reference leaves its einsums to XLA);
5. each token's kept outputs, weighted by its gates, summed in ascending
   expert order from zero in the model dtype: the order in which the
   reference's scatter-add meets them in its sorted stream.  No atomics, so
   two runs on the card give the same bits;
6. the shared-expert MLP (Kimi-K2) and the dense residual MLP (Arctic)
   added to the routed output.

Routing groups: capacity couples the tokens routed together.  The
reference's loop, ``DecodeEngine`` and paged slot pool route a whole
``(B, S)`` batch jointly; its contiguous slot pool vmaps a batch-1 step,
so every slot routes alone.  ``per_row=True`` gives each batch row its own
group (the port writes the slot axis out as the batch).

Under the sharded trainer (``launch.steps`` on a ``shard_model``) the layer
takes one of two forms, as ``repro/models/moe.py:86-105`` dispatches:

* expert parallel (:meth:`MoE.forward_shard_map`, the reference's
  ``moe_forward_shard_map``), when a mesh is active
  (``sharding.ctx.use_shard_map_mesh``) and the ``model`` axis divides the
  experts: each ``model`` rank routes its local tokens (capacity from the
  local count) to the ``E / m`` experts it owns and the partial outputs are
  summed over ``model``; the load-balance statistics are averaged over
  ``data``;
* otherwise the dense form over the global batch: while a split batch is
  active (``sharding.ctx.use_batch_shard``) the rank gathers the layer's
  tokens over ``data``, routes them jointly (capacity and ``aux`` from all
  of them, as the reference's GSPMD program) and keeps its own rows.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import activation, dense_std, frozen, trunc_normal_, upcast
from repro_torch.models.mlp import MLP
from repro_torch.sharding import comm
from repro_torch.sharding import ctx as shard_ctx


def capacity(num_tokens: int, cfg: ModelConfig) -> int:
    """Tokens an expert takes from ``num_tokens`` routed together: Python's
    ``int()`` of the reference's product, at least ``top_k``."""
    cap = int(num_tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(cfg.top_k, cap)


def route(logits: torch.Tensor, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Routing of ``G`` groups of ``T`` tokens from f32 router logits
    ``(G, T, E)``.  Returns, with ``n = T * k`` assignments a group in the
    reference's flat order (token-major, then choice):

    * ``gates`` (G, T, k) f32 renormalised, ``expert_ids`` (G, T, k)
      int64, ``aux`` (G,) f32 from ``f_e`` (G, E) (the share of first
      choices) and ``p_e`` (G, E) (the mean router probability);
    * in the expert-sorted order of the reference (``argsort(stable)``):
      ``order`` (G, n), ``sorted_expert`` (G, n), ``pos`` (G, n) the
      position inside the expert's group, ``keep`` (G, n), ``slot`` (G, n)
      ``expert * C + pos`` for kept assignments and ``E * C`` (the
      reference's scratch row) for dropped ones;
    * ``cap`` (a Python int)."""
    g, t, e = logits.shape
    k = cfg.top_k
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, expert_ids = vals[..., :k], ids[..., :k]
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)

    f_e = torch.nn.functional.one_hot(expert_ids[..., 0], e).to(probs.dtype).mean(dim=1)
    p_e = probs.mean(dim=1)
    aux = float(e) * torch.sum(f_e * p_e, dim=-1)

    cap = capacity(t, cfg)
    n = t * k
    flat_expert = expert_ids.reshape(g, n)
    order = torch.argsort(flat_expert, dim=-1, stable=True)
    sorted_expert = torch.gather(flat_expert, 1, order).contiguous()
    arange = torch.arange(n, device=logits.device)
    pos = arange - torch.searchsorted(sorted_expert, sorted_expert, side="left")
    keep = pos < cap
    slot = torch.where(keep, sorted_expert * cap + pos, e * cap)
    return dict(gates=gates, expert_ids=expert_ids, aux=aux, f_e=f_e, p_e=p_e, order=order,
                sorted_expert=sorted_expert, pos=pos, keep=keep, slot=slot, cap=cap)


class MoE(nn.Module):
    """Routed experts ``w_up`` / ``w_gate`` (E, d, f) and ``w_down`` (E, f,
    d), the router (d, E), and the optional ``shared`` and
    ``dense_residual`` MLPs, in the reference's layout."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_dff or cfg.d_ff
        self.act = activation(cfg.act)
        self.router = frozen((d, e), dtype, device)
        self.w_up = frozen((e, d, f), dtype, device)
        self.w_gate = frozen((e, d, f), dtype, device)
        self.w_down = frozen((e, f, d), dtype, device)
        self.shared = (MLP(d, f * cfg.num_shared_experts, cfg.gated_mlp, cfg.act, dtype, device)
                       if cfg.num_shared_experts else None)
        self.dense_residual = (MLP(d, cfg.dense_residual_dff, cfg.gated_mlp, cfg.act, dtype, device)
                               if cfg.dense_residual_dff else None)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """The reference's scales (router at 0.1 x fan-in).  The expert
        tensors are drawn one expert at a time: a draw makes two f32 copies
        of what it fills, and at kimi-k2's width one whole (384, 7168, 2048)
        tensor would take 2 x 22.5 GB of them."""
        trunc_normal_(self.router, 0.1 * dense_std(self.router.shape), gen)
        for w in (self.w_up, self.w_gate, self.w_down):
            std = dense_std(w.shape)
            for i in range(w.shape[0]):
                trunc_normal_(w[i], std, gen)
        for mlp in (self.shared, self.dense_residual):
            if mlp is not None:
                mlp.reset_parameters(gen)

    def forward(self, x: torch.Tensor, cfg: ModelConfig, per_row: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, S, d) -> (out (B, S, d), aux f32).  ``per_row`` routes each
        batch row as its own group (aux is then the mean of the rows').
        Under the sharded trainer, the expert-parallel or the gathered dense
        form (module docstring)."""
        mesh = shard_ctx.shard_map_mesh()
        if (mesh is not None and not per_row and "model" in mesh.axis_names
                and cfg.num_experts % mesh.shape["model"] == 0):
            return self.forward_shard_map(x, cfg, mesh)
        shard = shard_ctx.batch_shard()
        if shard is not None and shard.split and not per_row:
            out, aux = self._forward_dense(comm.gather_rows(x, shard.mesh.group("data")), cfg)
            return shard.mine(out), aux
        return self._forward_dense(x, cfg, per_row)

    def _forward_dense(self, x: torch.Tensor, cfg: ModelConfig, per_row: bool = False):
        b, s, d = x.shape
        groups = b if per_row else 1
        t = b * s // groups
        xt = x.reshape(groups, t, d)
        logits = upcast(xt @ self.router)
        r = route(logits, cfg)
        out = self._dispatch(xt, r, cfg).reshape(b * s, d)
        flat = x.reshape(b * s, d)
        if self.shared is not None:
            out = out + self.shared(flat)
        if self.dense_residual is not None:
            out = out + self.dense_residual(flat)
        return out.reshape(b, s, d), r["aux"].mean()

    def forward_shard_map(self, x: torch.Tensor, cfg: ModelConfig, mesh) -> Tuple[torch.Tensor, torch.Tensor]:
        """The expert-parallel form (twin of ``repro/models/moe.py:185-302``
        ``moe_forward_shard_map``): x (B, S, d) is this rank's rows, the same
        on every ``model`` rank.  The rank routes them (capacity from their
        count) to the ``E / m`` experts it owns, ``[first, first + E / m)``;
        the expert tensors are those experts (the sharded trainer stores
        them so) or all ``E``, sliced here.  The partial outputs are summed
        over ``model`` (``comm.reduce_from``: backward identity) and the
        region's replicated inputs, the tokens and the gates, enter through
        ``comm.copy_to`` (backward: the ranks' partial gradients summed);
        the router and ``aux`` stay outside the region, counted once.
        ``f_e`` and ``p_e`` are averaged over ``data``.  The shared and
        dense-residual MLPs stay outside too."""
        b, s, d = x.shape
        e = cfg.num_experts
        e_loc = e // mesh.shape["model"]
        first = mesh.coordinate()["model"] * e_loc
        mgroup, dgroup = mesh.group("model"), mesh.group("data")
        xt = x.reshape(1, b * s, d)
        r = route(upcast(xt @ self.router), cfg)
        aux = float(e) * torch.sum(comm.all_mean(r["f_e"], dgroup) * comm.all_mean(r["p_e"], dgroup), dim=-1)
        weights = [w if w.shape[0] == e_loc else w[first:first + e_loc] for w in (self.w_up, self.w_gate, self.w_down)]
        out = self._dispatch(comm.copy_to(xt, mgroup), dict(r, gates=comm.copy_to(r["gates"], mgroup)), cfg,
                             first=first, weights=weights)
        out = comm.reduce_from(out, mgroup).reshape(b * s, d)
        flat = x.reshape(b * s, d)
        if self.shared is not None:
            out = out + self.shared(flat)
        if self.dense_residual is not None:
            out = out + self.dense_residual(flat)
        return out.reshape(b, s, d), aux.mean()

    def _dispatch(self, xt: torch.Tensor, r: Dict[str, torch.Tensor], cfg: ModelConfig, first: int = 0,
                  weights=None) -> torch.Tensor:
        """The routed half: (G, T, d) -> (G, T, d), over the experts
        ``[first, first + len(weights[0]))`` (all of them by default); an
        assignment to another expert adds zero."""
        g, t, d = xt.shape
        w_up, w_gate, w_down = weights or (self.w_up, self.w_gate, self.w_down)
        k, cap = cfg.top_k, r["cap"]
        e = w_up.shape[0]
        n = t * k
        dev = xt.device
        # Expert e's slot c holds its c-th assignment in sorted order, if any.
        experts = torch.arange(first, first + e, device=dev).expand(g, e).contiguous()
        start = torch.searchsorted(r["sorted_expert"], experts, side="left")          # (G, E)
        count = torch.searchsorted(r["sorted_expert"], experts, side="right") - start
        c = torch.arange(cap, device=dev)
        j = torch.clamp(start[..., None] + c, max=n - 1).reshape(g, e * cap)        # (G, E*C)
        filled = (c < count[..., None]).reshape(g, e * cap, 1)
        src_tok = torch.gather(torch.div(r["order"], k, rounding_mode="floor"), 1, j)  # flat index // k
        gathered = torch.gather(xt, 1, src_tok[..., None].expand(g, e * cap, d))
        expert_in = torch.where(filled, gathered, torch.zeros((), dtype=xt.dtype, device=dev))
        # (G, E, C, d) -> (E, G * C, d): one batched product an expert tensor.
        expert_in = expert_in.reshape(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)
        h = self.act(torch.bmm(expert_in, w_gate)) * torch.bmm(expert_in, w_up)
        expert_out = torch.bmm(h, w_down).reshape(e, g, cap, d).transpose(0, 1).reshape(g, e * cap, d)

        # Combine: assignment (token, choice) in flat order, its sorted position.
        inv = torch.empty_like(r["order"])
        inv.scatter_(1, r["order"], torch.arange(n, device=dev).expand(g, n).contiguous())
        pos = torch.gather(r["pos"], 1, inv)                                         # (G, n)
        local = r["expert_ids"].reshape(g, n) - first
        keep = ((pos < cap) & (local >= 0) & (local < e))[..., None]
        src = torch.clamp(local * cap + pos, min=0, max=e * cap - 1)
        got = torch.gather(expert_out, 1, src[..., None].expand(g, n, d))
        weighted = torch.where(keep, got, torch.zeros((), dtype=xt.dtype, device=dev))
        weighted = (weighted * r["gates"].reshape(g, n, 1).to(xt.dtype)).reshape(g, t, k, d)
        # A token's k contributions in ascending expert order, from zero.
        asc = torch.argsort(r["expert_ids"], dim=-1)                                 # (G, T, k)
        weighted = torch.gather(weighted, 2, asc[..., None].expand(g, t, k, d))
        out = torch.zeros((g, t, d), dtype=xt.dtype, device=dev)
        for i in range(k):
            out = out + weighted[:, :, i]
        return out
