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

Every gather is over the default group and concatenates on the leading
axis, rank by rank. Outside a process group it is the identity. Inside one
it always runs the collective, a group of one rank included. The forward
takes ``all_gather`` and the GLOBAL backward ``all_reduce``: both run on
CUDA tensors over NCCL and over gloo. A collective the backend refuses
raises.
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


def _all_gather(x: torch.Tensor) -> List[torch.Tensor]:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    return parts


class _GlobalGather(torch.autograd.Function):
    """all_gather whose backward all-reduces (sums) the cotangent over the
    ranks and returns this rank's rows of the sum."""

    @staticmethod
    def forward(ctx, x):
        ctx.rows = x.shape[0]
        return torch.cat(_all_gather(x), dim=0)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM)
        start = dist.get_rank() * ctx.rows
        return g[start:start + ctx.rows]


def gather_tensor(x: torch.Tensor,
                  backprop_type: BackpropType = BackpropType.GLOBAL
                  ) -> torch.Tensor:
    """all_gather over the default group, concatenated on the leading axis
    (reference gather_tensor, distributed.py:28-58). Every rank must pass
    the same shape. Outside a process group: ``x`` itself."""
    if not in_group():
        return x
    if backprop_type == BackpropType.GLOBAL:
        return _GlobalGather.apply(x)
    parts = _all_gather(x.detach())
    if backprop_type == BackpropType.LOCAL:
        parts[dist.get_rank()] = x
    return torch.cat(parts, dim=0)


def concat_gather_all(x: torch.Tensor,
                      backprop_type: BackpropType = BackpropType.GLOBAL
                      ) -> torch.Tensor:
    """reference concat_gather_all_gpu (distributed.py:61-83)."""
    return gather_tensor(x, backprop_type)


def all_reduce_mean(values: torch.Tensor) -> torch.Tensor:
    """The mean of ``values`` over the ranks (a copy; ``values`` itself
    outside a group)."""
    if not in_group():
        return values
    out = values.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out / dist.get_world_size()


def any_rank(flag: bool, device: torch.device) -> bool:
    """True when ``flag`` is true on any rank: an all-reduce MAX (the JAX
    trainer's ``_preempt_agreed``). Every rank must call it at the same
    point."""
    if not in_group():
        return flag
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item() > 0)


def barrier() -> None:
    """Wait for every rank (nothing outside a group)."""
    if in_group():
        dist.barrier()
