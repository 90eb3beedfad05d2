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
from typing import Optional, Tuple

import torch

from repro_torch.sharding import comm

_MOE_MESH: ContextVar = ContextVar("repro_torch_moe_mesh", default=None)
_BATCH: ContextVar = ContextVar("repro_torch_batch_shard", default=None)
_TP: ContextVar = ContextVar("repro_torch_tensor_parallel", default=None)


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


@contextlib.contextmanager
def use_tensor_parallel(mesh):
    token = _TP.set(mesh)
    try:
        yield
    finally:
        _TP.reset(token)


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
