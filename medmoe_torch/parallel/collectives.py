"""Cross-rank gathers over ``torch.distributed`` (counterpart of
medmoe_tpu/parallel/collectives.py; reference src/utils/distributed.py).

The reference has three gather flavours (BackpropType, distributed.py:16-58):

- GLOBAL: gradients flow to every rank. The backward sums the gathered
  tensor's cotangent over the ranks and hands each rank its own rows, as
  ``torch.distributed.nn.functional.all_gather`` does (and JAX's
  differentiable ``lax.all_gather``).
- LOCAL: the other ranks' rows arrive without a gradient; this rank's own
  rows are spliced back in, differentiable.
- NONE: no gradient at all.

Every gather concatenates on the leading axis, rank by rank, over the
default group or the ``group`` given (a data group of the d × e grid,
``parallel/mesh.py``). Outside a process group it is the identity. Inside
one it always runs the collective, a group of one rank included. The
forward takes ``all_gather`` and the GLOBAL backward ``all_reduce``: both
run on CUDA tensors over NCCL and over gloo. A collective the backend
refuses raises.

The expert region (expert parallelism, ``models/moe.py``): the e ranks of
an expert group hold the same rows and K/e experts each.

- ``enter_experts``: identity forward; the backward sums the cotangent
  over the expert group (each rank's experts saw the input, so each
  holds part of its gradient).
- ``leave_experts``: the forward sums each rank's partial output over the
  expert group; identity backward (every rank holds the same loss).
- ``gather_experts``: the bank's K/e slices concatenated into all K; the
  backward keeps this rank's slice and does not sum, since every rank of
  the group computed the same full gradient.
"""

from __future__ import annotations

import enum
from typing import List

import torch
import torch.distributed as dist


class BackpropType(enum.Enum):
    """How gradients flow through a cross-rank gather (reference
    distributed.py:16-25)."""

    GLOBAL = "global"     # gradients flow to every participating rank
    LOCAL = "local"       # only the local shard's gradient survives
    NONE = "none"         # no gradients

    @classmethod
    def from_str(cls, value: str) -> "BackpropType":
        return cls(value.lower())


def in_group() -> bool:
    """True inside an initialized default process group."""
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    """This process's rank in the default group, 0 outside one (reference
    get_rank, distributed.py:86-89)."""
    return dist.get_rank() if in_group() else 0


def get_world_size() -> int:
    """The default group's size, 1 outside one."""
    return dist.get_world_size() if in_group() else 1


def _all_gather(x: torch.Tensor, group=None) -> List[torch.Tensor]:
    parts = [torch.empty_like(x)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


def _all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _GlobalGather(torch.autograd.Function):
    """all_gather whose backward all-reduces (sums) the cotangent over the
    group and returns this rank's rows of the sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.rows, ctx.group = x.shape[0], group
        return torch.cat(_all_gather(x, group), dim=0)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce_sum(g, ctx.group)
        start = dist.get_rank(ctx.group) * ctx.rows
        return g[start:start + ctx.rows], None


def gather_tensor(x: torch.Tensor,
                  backprop_type: BackpropType = BackpropType.GLOBAL,
                  group=None) -> torch.Tensor:
    """all_gather over ``group`` (None: the default group), concatenated on
    the leading axis (reference gather_tensor, distributed.py:28-58).
    Every rank must pass the same shape. Outside a process group: ``x``
    itself."""
    if not in_group():
        return x
    if backprop_type == BackpropType.GLOBAL:
        return _GlobalGather.apply(x, group)
    parts = _all_gather(x.detach(), group)
    if backprop_type == BackpropType.LOCAL:
        parts[dist.get_rank(group)] = x
    return torch.cat(parts, dim=0)


def concat_gather_all(x: torch.Tensor,
                      backprop_type: BackpropType = BackpropType.GLOBAL,
                      group=None) -> torch.Tensor:
    """reference concat_gather_all_gpu (distributed.py:61-83)."""
    return gather_tensor(x, backprop_type, group)


def all_reduce_mean(values: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``values`` over ``group``'s ranks (a copy; ``values``
    itself outside a process group)."""
    if not in_group():
        return values
    return _all_reduce_sum(values, group) / dist.get_world_size(group)


def all_reduce_sum(values: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``values`` over ``group``'s ranks, without a gradient (a
    copy; ``values`` itself outside a process group)."""
    if not in_group():
        return values
    return _all_reduce_sum(values.detach(), group)


def all_gather_stack(x: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' ``x`` stacked on a new leading axis, rank by rank, without
    a gradient (``x[None]`` outside a process group)."""
    if not in_group():
        return x[None]
    return torch.stack(_all_gather(x.detach(), group), dim=0)


def any_rank(flag: bool, device: torch.device, group=None) -> bool:
    """True when ``flag`` is true on any rank: an all-reduce MAX (the JAX
    trainer's ``_preempt_agreed``). Every rank must call it at the same
    point."""
    if not in_group():
        return flag
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item() > 0)


class _EnterExperts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_sum(g, ctx.group), None


class _LeaveExperts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherExperts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.rows = x.shape[0]
        ctx.start = dist.get_rank(group) * x.shape[0]
        return torch.cat(_all_gather(x, group), dim=0)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.start:ctx.start + ctx.rows], None


def enter_experts(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the backward sums the cotangent over the expert
    ``group``."""
    return _EnterExperts.apply(x, group)


def leave_experts(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the expert ``group`` forward; identity backward."""
    return _LeaveExperts.apply(x, group)


def gather_experts(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's K/e bank slice → all K, rank by rank; the backward keeps
    this rank's slice of the (replicated) gradient, unsummed."""
    return _GatherExperts.apply(x, group)


def barrier() -> None:
    """Wait for every rank (nothing outside a group)."""
    if in_group():
        dist.barrier()
