"""A model's parameters held as this rank's shards (ZeRO-3 over ``data``,
the ``model`` placements of ``rules.param_pspecs``).

A parameter whose spec names a mesh axis is *stored* as the rank's slice
(its coordinate's chunk along each named dim); :meth:`ShardedModel.gather`
all-gathers it into the model for the step's compute and
:meth:`ShardedModel.release` frees that copy afterwards.  A parameter
computed where it is stored (the expert-parallel MoE's experts along
``model``) is gathered along its other axes only.  A replicated parameter
is stored whole: the model's own tensor.

:meth:`ShardedModel.reduce_grads` brings the step's gradients back to the
shards: summed over ``data`` (a reduce-scatter along a dim the spec puts on
``data``, an all-reduce otherwise), then cut to the rank's chunk along the
dims gathered over ``model``, whose ranks computed the same gradient.
:meth:`ShardedModel.reduce_partials` gives the clip's norm over the whole
model (``optim.global_norm``'s ``reduce``): each leaf's squared partial norm
summed over the axes that split it.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.sharding import comm
from repro_torch.sharding.rules import P


class ShardedModel:
    """``model``'s parameters as this rank's shards of ``specs`` over
    ``mesh``; ``local`` maps a parameter name to the axes along which it is
    computed where it is stored (not gathered); ``moe_shard_map``: the train
    step runs the MoE in its expert-parallel form (``launch.steps``)."""

    def __init__(self, model: torch.nn.Module, mesh, specs: Mapping[str, P],
                 local: Optional[Mapping[str, Iterable[str]]] = None, moe_shard_map: bool = False):
        self.model, self.mesh, self.moe_shard_map = model, mesh, moe_shard_map
        self.specs = {n: P(*specs[n].padded(p.dim())) for n, p in model.named_parameters()}
        self.params = dict(model.named_parameters())
        self.coord = mesh.coordinate()
        local = {n: set(a) for n, a in (local or {}).items()}
        # (axis, dim) pairs a parameter is all-gathered along before use.
        self.plan = {n: [(a, d) for d, a in enumerate(s) if a is not None and a not in local.get(n, ())]
                     for n, s in self.specs.items()}
        self.local = {n: [(a, d) for d, a in enumerate(s) if a is not None and a in local.get(n, ())]
                      for n, s in self.specs.items()}
        self.shards: Dict[str, torch.Tensor] = {}
        with torch.no_grad():
            for name, p in self.params.items():
                if self.plan[name]:
                    self.shards[name] = self.shard_of(name, p.data)
                else:
                    if self.local[name] and any(self.mesh.shape[a] > 1 for a, _ in self.local[name]):
                        p.data = self._cut(p.data, self.local[name]).clone()
                    self.shards[name] = p.data
        self.release()

    # -- slicing ---------------------------------------------------------

    def _chunk(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        n = self.mesh.shape[axis]
        return t.narrow(dim, self.coord[axis] * (t.shape[dim] // n), t.shape[dim] // n)

    def _cut(self, t: torch.Tensor, pairs) -> torch.Tensor:
        for axis, dim in pairs:
            t = self._chunk(t, axis, dim)
        return t

    def shard_of(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's stored slice of a full tensor of parameter ``name``."""
        return self._cut(full, self.plan[name] + self.local[name]).clone()

    def full_of(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's stored slice (a collective)."""
        for axis, dim in self.plan[name] + self.local[name]:
            shard = comm.all_gather_along(shard, self.mesh.group(axis), dim)
        return shard

    # -- the step --------------------------------------------------------

    @torch.no_grad()
    def gather(self) -> None:
        """Put each parameter's compute tensor into the model."""
        for name, pairs in self.plan.items():
            if pairs:
                t = self.shards[name]
                for axis, dim in pairs:
                    t = comm.all_gather_along(t, self.mesh.group(axis), dim)
                self.params[name].data = t

    def release(self) -> None:
        """Free the gathered copies (the model's gathered parameters become
        empty until the next :meth:`gather`)."""
        for name, pairs in self.plan.items():
            if pairs:
                p = self.params[name]
                p.data = torch.empty(0, dtype=p.dtype, device=p.device)

    @torch.no_grad()
    def reduce_grads(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The step's gradients (of the compute tensors) as the shards'
        gradients, summed over ``data``.  ``grads`` is consumed."""
        data = self.mesh.group("data")
        out = {}
        for name in list(grads):
            g = grads.pop(name)
            on_data = [(a, d) for a, d in self.plan[name] if a == "data"]
            if on_data:
                g = comm.reduce_scatter_along(g, data, on_data[0][1])
            else:
                g = comm.all_reduce_(g, data)
            out[name] = self._cut(g, [(a, d) for a, d in self.plan[name] if a != "data"]).contiguous()
            del g
        return out

    def reduce_partials(self, partial: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The leaves' f32 sums of squares over their shards, each summed
        over the axes that split its leaf (one all-reduce a set of axes):
        ``optim.global_norm``'s ``reduce``."""
        by_axes: Dict[Tuple[str, ...], list] = {}
        for n in partial:
            axes = tuple(sorted({a for a in self.specs[n] if a is not None}))
            if axes:
                by_axes.setdefault(axes, []).append(n)
        out = dict(partial)
        for axes, names in by_axes.items():
            group = self.mesh.group(axes[0]) if len(axes) == 1 else dist.group.WORLD
            summed = comm.all_reduce_(torch.stack([partial[n] for n in names]), group)
            for i, n in enumerate(names):
                out[n] = summed[i]
        return out

    # -- whole tensors (checkpoints) -------------------------------------

    @torch.no_grad()
    def full_tree(self, tree: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Whole tensors of a shard-shaped dict (parameters or moments)."""
        return {n: self.full_of(n, t) for n, t in tree.items()}

    @torch.no_grad()
    def load_full(self, tree: Dict[str, torch.Tensor], full: Mapping[str, torch.Tensor]) -> None:
        """Copy this rank's slices of whole tensors into a shard-shaped dict."""
        for n, t in tree.items():
            t.copy_(self._cut(full[n].to(t.device), self.plan[n] + self.local[n]))

    @torch.no_grad()
    def materialize(self) -> torch.nn.Module:
        """The model with every parameter whole again (a collective); the
        sharded state is not used after this."""
        for name, p in self.params.items():
            p.data = self.full_of(name, self.shards[name])
        return self.model
