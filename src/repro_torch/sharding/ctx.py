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
data axis while a :class:`BatchShard` is active.
"""

from __future__ import annotations

import contextlib
import dataclasses
from contextvars import ContextVar
from typing import Optional, Tuple

_MOE_MESH: ContextVar = ContextVar("repro_torch_moe_mesh", default=None)
_BATCH: ContextVar = ContextVar("repro_torch_batch_shard", default=None)


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
    """This rank's share of the step's batch: ``split`` when the rows are
    divided over the mesh's ``data`` axis (``rules.batch_spec``), else every
    data rank holds them all."""

    mesh: object
    split: bool

    def mine(self, full):
        """This rank's rows (dim 0) of a tensor of the global rows."""
        if not self.split:
            return full
        b = full.shape[0] // self.mesh.shape["data"]
        i = self.mesh.coordinate()["data"]
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
