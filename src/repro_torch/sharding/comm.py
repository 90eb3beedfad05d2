"""Collectives of the sharded trainer, with the gradients the step needs.

Two kinds of axis, two kinds of gradient:

* over ``data`` the ranks hold different rows, and the step's objective is
  the sum of the ranks' objectives; a collective's backward is its true
  adjoint: :func:`gather_rows` (all-gather forward, reduce-scatter of the
  cotangents backward) and :func:`all_mean` (mean forward, mean of the
  cotangents backward);
* over ``model`` the ranks repeat one computation, so the objective is
  counted once; the expert-parallel MoE enters its region with
  :func:`copy_to` (identity forward, all-reduce backward: each rank's
  partial gradient of a replicated input summed) and leaves it with
  :func:`reduce_from` (all-reduce forward, identity backward), Megatron's
  conjugate pair, which is what the reference's ``shard_map`` with ``psum``
  over ``model`` differentiates to.

(``torch.distributed.nn.functional.all_reduce`` sums in its backward too,
which at the region's exit would multiply the gradients by the group's
size.)

The plain helpers (:func:`all_gather_along`, :func:`reduce_scatter_along`)
move parameters and gradients outside autograd, along any dim.  On a group
of one rank every collective returns its input's values unchanged.

The placeholder world (the dry run, ``launch.dryrun``): a
:class:`PlaceholderGroup` (what a placeholder ``launch.mesh.Mesh`` hands
out) stands for ranks that do not exist, and each collective on it returns
an uninitialised ``meta`` tensor of its output's shape.
:func:`placeholder_world` names the rank a trace stands for.  A
:class:`Tally` (:func:`tally`) adds up every collective's output bytes by
kind (the reference's ``all-gather`` / ``reduce-scatter`` / ``all-reduce``)
and by mesh axis, the placeholder's and a real world's alike (a real
group is named by the mesh that made it, ``name_group``).  Each call is
counted once: the port has no scanned layer body whose collectives would
repeat unseen.
"""

from __future__ import annotations

import collections
import contextlib
from contextvars import ContextVar
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


class PlaceholderGroup:
    """A group of ``n`` ranks along mesh axes ``axes`` (a label such as
    ``"model"`` or ``"pod+data"``) that do not exist: the dry run's."""

    def __init__(self, axes: str, n: int):
        self.axes, self.n = axes, n

    def __repr__(self) -> str:
        return f"PlaceholderGroup({self.axes!r}, {self.n})"


_RANK: ContextVar = ContextVar("repro_torch_placeholder_rank", default=None)
_TALLIES: ContextVar = ContextVar("repro_torch_tallies", default=())
_NAMES: Dict[int, str] = {}


@contextlib.contextmanager
def placeholder_world(rank: int = 0):
    """Trace as rank ``rank`` of a placeholder mesh's world."""
    token = _RANK.set(rank)
    try:
        yield
    finally:
        _RANK.reset(token)


def placeholder_rank() -> Optional[int]:
    return _RANK.get()


def name_group(group, axes: str):
    """Label a real process group with its mesh axes (for the tally);
    returns the group."""
    _NAMES[id(group)] = axes
    return group


class Tally:
    """Collective output bytes, by kind and by mesh axis (``by_axis[axes]
    [kind]``), the number of calls, and each call's (kind, axes, output
    shape) in order (``shapes``)."""

    def __init__(self):
        self.by_kind: Dict[str, int] = collections.Counter()
        self.by_axis: Dict[str, Dict[str, int]] = collections.defaultdict(collections.Counter)
        self.calls: Dict[str, Dict[str, int]] = collections.defaultdict(collections.Counter)
        self.shapes: List[Tuple[str, str, Tuple[int, ...]]] = []

    @property
    def total(self) -> int:
        return sum(self.by_kind.values())

    def add(self, kind: str, axes: str, out: torch.Tensor) -> None:
        self.by_kind[kind] += out.numel() * out.element_size()
        self.by_axis[axes][kind] += out.numel() * out.element_size()
        self.calls[axes][kind] += 1
        self.shapes.append((kind, axes, tuple(out.shape)))


@contextlib.contextmanager
def tally():
    """Count the collectives of the enclosed code; yields a :class:`Tally`."""
    t = Tally()
    token = _TALLIES.set(_TALLIES.get() + (t,))
    try:
        yield t
    finally:
        _TALLIES.reset(token)


def _record(kind: str, group, out: torch.Tensor) -> None:
    tallies = _TALLIES.get()
    if tallies:
        axes = group.axes if isinstance(group, PlaceholderGroup) else _NAMES.get(id(group), "world")
        for t in tallies:
            t.add(kind, axes, out)


def group_size(group) -> int:
    return group.n if isinstance(group, PlaceholderGroup) else dist.get_world_size(group)


def all_gather_along(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's ``t``s concatenated along ``dim``, in rank order."""
    n = group_size(group)
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=t.dtype,
                      device="meta" if isinstance(group, PlaceholderGroup) else t.device)
    if not isinstance(group, PlaceholderGroup):
        _all_gather(out, src, group=group)
    out = out.movedim(0, dim).contiguous() if dim else out
    _record("all-gather", group, out)
    return out


def reduce_scatter_along(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's sum of ``t``, this rank's ``1/n`` slice of it along ``dim``."""
    n = group_size(group)
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]), dtype=t.dtype,
                      device="meta" if isinstance(group, PlaceholderGroup) else t.device)
    if not isinstance(group, PlaceholderGroup):
        _reduce_scatter(out, src, group=group)
    out = out.movedim(0, dim).contiguous() if dim else out
    _record("reduce-scatter", group, out)
    return out


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group, in place; returns ``t``."""
    if not isinstance(group, PlaceholderGroup):
        dist.all_reduce(t, group=group)
    _record("all-reduce", group, t)
    return t


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_along(x, group)

    @staticmethod
    def backward(ctx, dy):
        return reduce_scatter_along(dy, ctx.group), None


class _AllMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group) / group_size(group)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce_(dy.clone(), ctx.group) / group_size(ctx.group), None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce_(dy.clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """All ranks' rows (dim 0) of ``x``, in rank order (data axis)."""
    return _GatherRows.apply(x, group)


def all_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over the group (data axis)."""
    return _AllMean.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Enter a region repeated over the group (model axis)."""
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Leave it: the ranks' partial results summed (model axis)."""
    return _ReduceFrom.apply(x, group)
