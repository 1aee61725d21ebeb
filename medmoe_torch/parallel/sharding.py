"""Which parameters carry the MoE's expert axis, and how a rank holds its
slice of them (counterpart of medmoe_tpu/parallel/sharding.py:21-37).

Every parameter is replicated, except, under expert parallelism
(``trainer.mesh.expert = e > 1``), the expert bank's: each of
``_EXPERT_PARAM_KEYS`` under an ``experts`` module has a leading K axis,
and rank (data j, expert c) of the grid holds experts
[c·K/e, (c+1)·K/e) of it, as JAX's ``P("expert", None, ...)`` gives
device c of the expert axis. The bank is initialized whole from the seed
and then sliced, so an expert-parallel run starts from the replicated
run's weights; checkpoints hold the whole bank (``utils/checkpoint.py``
gathers it on a save and slices it on a load).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import torch
from torch import nn

from medmoe_torch.parallel import collectives as C
from medmoe_torch.parallel.mesh import Grid

# parameter name fragments that carry a leading expert axis
_EXPERT_PARAM_KEYS = ("proj_w", "proj_b", "attn_w1", "attn_b1", "attn_w2",
                      "attn_b2")


def is_expert_param(name: str) -> bool:
    """True for a bank parameter: ``...experts.<key>`` ('.' or '/'
    separated, a ``state_dict`` or a flax path)."""
    parts = name.replace("/", ".").split(".")
    return "experts" in parts[:-1] and parts[-1].startswith(
        _EXPERT_PARAM_KEYS)


def expert_slice(num_experts: int, index: int, size: int) -> slice:
    """Rank ``index`` of an expert group of ``size``: its experts. Raises
    ValueError when ``size`` does not divide ``num_experts``."""
    if num_experts % size:
        raise ValueError(f"{num_experts} experts do not divide over an "
                         f"expert axis of {size} ranks")
    n = num_experts // size
    return slice(index * n, (index + 1) * n)


def shard_tensors(tensors: Mapping[str, torch.Tensor], index: int,
                  size: int) -> Dict[str, torch.Tensor]:
    """``tensors`` (whole banks, by parameter name) with every bank
    parameter cut to rank ``index``'s experts of ``size``; the rest
    unchanged."""
    return {k: v[expert_slice(v.shape[0], index, size)].clone()
            if is_expert_param(k) else v for k, v in tensors.items()}


def sharded_banks(model: nn.Module) -> Iterable[Tuple[str, nn.Module]]:
    """(name, bank) of every expert bank of ``model`` that holds a slice."""
    from medmoe_torch.models.moe import ExpertBank

    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, ExpertBank) and m.grid is not None]


def shard_model(model: nn.Module, grid: Grid) -> nn.Module:
    """Cut every expert bank of ``model`` to this rank's experts of the
    grid's expert axis (nothing when e = 1). Raises ValueError when e does
    not divide a bank's K. Call before the optimizer exists."""
    if grid.expert <= 1:
        return model
    from medmoe_torch.models.moe import ExpertBank

    for module in model.modules():
        if isinstance(module, ExpertBank):
            module.shard(grid)
    return model


def expert_flags(model: nn.Module, params: Iterable[nn.Parameter]
                 ) -> List[bool]:
    """One flag per parameter of ``params`` (the optimizer's order):
    whether it holds a slice of one of ``model``'s sharded banks."""
    ids = {id(p) for _, bank in sharded_banks(model)
           for p in bank.parameters()}
    return [id(p) in ids for p in params]


def bank_grid(model: nn.Module) -> Optional[Grid]:
    """The grid ``model``'s banks are sharded over, or None."""
    banks = sharded_banks(model)
    return banks[0][1].grid if banks else None


def full_state(model: nn.Module, state: Mapping[str, torch.Tensor],
               group) -> Dict[str, torch.Tensor]:
    """``state`` (a ``state_dict`` of ``model``) with every sharded bank
    parameter all-gathered over the expert ``group`` into the whole bank.
    Collective: every rank of the group must call it."""
    names = {f"{n}.{k}" if n else k for n, bank in sharded_banks(model)
             for k, _ in bank.named_parameters()}
    return {k: C.all_gather_stack(v, group).flatten(0, 1)
            if k in names else v for k, v in state.items()}
