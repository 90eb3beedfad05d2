"""Step-time mesh contexts for layers that shard their own work (twin of
``repro/sharding/ctx.py``).

``use_shard_map_mesh`` is the reference's context: the sharded train step
activates it around the forward when ``moe_shard_map=True``, and the MoE
layer then takes its expert-parallel form (``models.moe``).  When no mesh
is active, layers run their single-device forms.

``use_batch_shard`` has no counterpart in the reference, whose GSPMD
program sees the global batch: the port's sharded step runs each rank on
its rows of the batch, and the layers that couple rows (the dense MoE's
joint routing, the link emulation's masks) gather the rows over the mesh's
data axes while a :class:`BatchShard` is active.

``use_context_shards`` has no counterpart in the reference either: where
the batch cannot be split over the data axes (``long_500k``),
``rules.cache_pspecs`` puts an attention layer's KV sequence on them and
the reference's GSPMD program partitions the decode over it.  The port's
sharded steps give each such layer a :class:`ContextShard`: the rank holds
rows ``[first, first + rows)`` of the layer's cache, writes the decode
token only where it owns the slot, and merges flash decode's partials over
the data axes (``models.attention``).

``use_tensor_parallel`` is the port's counterpart of the reference's GSPMD
partitioning over ``model`` (and of ``models/attention.py:85``
``_constrain_attention``): under it, a layer whose parameters are the
rank's slice along ``model`` (the sharded serving steps store them so)
computes that slice and sums its partial output over ``model``
(:func:`sum_over_model`).  A layer that finds its parameters whole
computes as on one device.
"""

from __future__ import annotations

import contextlib
import dataclasses
from contextvars import ContextVar
from typing import Dict, Optional, Tuple

import torch

from repro_torch.sharding import comm

_MOE_MESH: ContextVar = ContextVar("repro_torch_moe_mesh", default=None)
_BATCH: ContextVar = ContextVar("repro_torch_batch_shard", default=None)
_TP: ContextVar = ContextVar("repro_torch_tensor_parallel", default=None)
_CONTEXT: ContextVar = ContextVar("repro_torch_context_shards", default=None)


@contextlib.contextmanager
def use_shard_map_mesh(mesh):
    token = _MOE_MESH.set(mesh)
    try:
        yield
    finally:
        _MOE_MESH.reset(token)


def shard_map_mesh():
    return _MOE_MESH.get()


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], str]:
    """(data-like axes, model axis)."""
    data = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return data, "model"


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """This rank's share of the step's batch: the rows are divided over the
    mesh's data ``axes`` (``rules.batch_spec``; ``None``: every data rank
    holds them all)."""

    mesh: object
    axes: Optional[Tuple[str, ...]]

    @property
    def split(self) -> bool:
        """Whether the rows are divided (data axes wider than one rank)."""
        return self.axes is not None and self.mesh.size_of(self.axes) > 1

    def group(self):
        """The ranks that hold the other rows."""
        return self.mesh.group(self.axes)

    def mine(self, full):
        """This rank's rows (dim 0) of a tensor of the global rows."""
        if not self.split:
            return full
        b = full.shape[0] // self.mesh.size_of(self.axes)
        i = self.mesh.index_of(self.axes)
        return full[i * b:(i + 1) * b]


@contextlib.contextmanager
def use_batch_shard(shard: Optional[BatchShard]):
    token = _BATCH.set(shard)
    try:
        yield
    finally:
        _BATCH.reset(token)


def batch_shard() -> Optional[BatchShard]:
    return _BATCH.get()


@dataclasses.dataclass(frozen=True)
class ContextShard:
    """An attention layer's KV sequence split over the mesh's data ``axes``
    (``R`` ranks, pod and data on the multi-pod mesh): this rank, ``index``
    along them, holds ``rows`` (``C / R``) of the layer's ``C`` cache rows,
    from row ``first = index * rows``."""

    mesh: object
    axes: Tuple[str, ...]
    rows: int

    @property
    def ranks(self) -> int:
        return self.mesh.size_of(self.axes)

    @property
    def index(self) -> int:
        return self.mesh.index_of(self.axes)

    @property
    def first(self) -> int:
        return self.index * self.rows

    @property
    def length(self) -> int:
        """The layer's whole cache length, ``C``."""
        return self.rows * self.ranks

    def group(self):
        """The ranks that hold the other rows."""
        return self.mesh.group(self.axes)


@contextlib.contextmanager
def use_context_shards(shards: Optional[Dict[object, ContextShard]]):
    """Set the step's context-parallel layers: attention module ->
    :class:`ContextShard` (a layer absent holds its whole cache)."""
    token = _CONTEXT.set(shards)
    try:
        yield
    finally:
        _CONTEXT.reset(token)


def context_shard(layer) -> Optional[ContextShard]:
    """``layer``'s :class:`ContextShard` in the active step, or None."""
    shards = _CONTEXT.get()
    return None if shards is None else shards.get(layer)


@contextlib.contextmanager
def use_tensor_parallel(mesh):
    token = _TP.set(mesh)
    try:
        yield
    finally:
        _TP.reset(token)


def tensor_parallel_mesh():
    """The mesh of the active sharded serving step, or None."""
    return _TP.get()


def model_rank() -> int:
    """This rank's position along ``model`` (a layer holding a slice asks)."""
    return _tp_mesh().coordinate()["model"]


def sum_over_model(x: torch.Tensor) -> torch.Tensor:
    """The ``model`` ranks' partial outputs summed (``comm.reduce_from``)."""
    return comm.reduce_from(x, _tp_mesh().group("model"))


def _tp_mesh():
    mesh = _TP.get()
    if mesh is None:
        raise RuntimeError("a layer holds a slice of its parameters along 'model' outside "
                           "sharding.ctx.use_tensor_parallel: the sharded serving steps run it")
    return mesh
