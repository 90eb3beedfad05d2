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
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def all_gather_along(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's ``t``s concatenated along ``dim``, in rank order."""
    n = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=t.dtype, device=t.device)
    _all_gather(out, src, group=group)
    return out.movedim(0, dim).contiguous() if dim else out


def reduce_scatter_along(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's sum of ``t``, this rank's ``1/n`` slice of it along ``dim``."""
    n = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]), dtype=t.dtype, device=t.device)
    _reduce_scatter(out, src, group=group)
    return out.movedim(0, dim).contiguous() if dim else out


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group, in place; returns ``t``."""
    dist.all_reduce(t, group=group)
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
        return all_reduce_(x.clone(), group) / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce_(dy.clone(), ctx.group) / dist.get_world_size(ctx.group), None


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
