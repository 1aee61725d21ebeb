"""The data × expert grid of ranks (counterpart of
medmoe_tpu/parallel/mesh.py).

The JAX package lays its devices out as a ``Mesh`` with two axes,
``data`` (the batch's rows) and ``expert`` (the MoE bank's leading K axis,
when expert-parallel), ``np.asarray(devices).reshape(d, e)``. Here the
ranks of the default ``torch.distributed`` group take the same layout:
rank r sits at (data = r // e, expert = r % e).

- The **data group** of a rank is its column: the d ranks that share its
  expert coordinate. Gradients are averaged over it, and the global
  negatives gathered over it. With e = 1 it is the default group itself
  (``None``), and nothing of plain data-parallel training changes.
- The **expert group** of a rank is its row: the e ranks that share its
  data coordinate. They hold the same batch rows and each holds K/e of
  the experts; the MoE's combine over k is a sum over this group.

Every rank creates every group, in the same order (``dist.new_group`` is
collective). Outside a process group the grid is 1 × 1.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    data: int = -1          # -1 = fill with the remaining ranks
    expert: int = 1

    def resolve(self, n_ranks: int) -> tuple[int, int]:
        """(d, e) over ``n_ranks``; raises ValueError when the grid does not
        divide the ranks."""
        expert = self.expert if self.expert > 0 else 1
        data = self.data
        if data <= 0:
            if n_ranks % expert != 0:
                raise ValueError(
                    f"{n_ranks} ranks not divisible by expert={expert}")
            data = n_ranks // expert
        if data * expert != n_ranks:
            raise ValueError(f"mesh {data}x{expert} != {n_ranks} ranks")
        return data, expert

    @classmethod
    def from_config(cls, mesh: Optional[Mapping[str, Any]]) -> "MeshSpec":
        mesh = mesh or {}
        return cls(data=int(mesh.get("data", -1) or -1),
                   expert=int(mesh.get("expert", 1) or 1))


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in the d × e grid and its two groups (``None``
    names the default group; an expert group of one rank is ``None``
    too, and never used)."""
    data: int = 1
    expert: int = 1
    rank: int = 0
    data_group: Any = None
    expert_group: Any = None
    #: the default group the grid was built in (a grid outlives no group)
    world: Any = None

    @property
    def data_index(self) -> int:
        return self.rank // self.expert

    @property
    def expert_index(self) -> int:
        return self.rank % self.expert


_GRID: Optional[Grid] = None


def _world():
    return dist.group.WORLD if dist.is_available() and dist.is_initialized() \
        else None


def init_grid(mesh: Optional[Mapping[str, Any]] = None) -> Grid:
    """Lay the default group's ranks out as ``mesh`` ({data, expert}, the
    trainer's ``mesh`` config) and make it the current grid. Raises
    ValueError when the grid does not divide the ranks. Idempotent for
    the same layout in the same group; every rank must call it."""
    global _GRID
    world = _world()
    n = dist.get_world_size() if world is not None else 1
    d, e = MeshSpec.from_config(mesh).resolve(n)
    if _GRID is not None and _GRID.world is world \
            and (_GRID.data, _GRID.expert) == (d, e):
        return _GRID
    rank = dist.get_rank() if world is not None else 0
    data_group = expert_group = None
    if e > 1:
        # every rank creates every group, in the same order
        for c in range(e):
            g = dist.new_group([j * e + c for j in range(d)])
            if rank % e == c:
                data_group = g
        for j in range(d):
            g = dist.new_group([j * e + c for c in range(e)])
            if rank // e == j:
                expert_group = g
    _GRID = Grid(data=d, expert=e, rank=rank, data_group=data_group,
                 expert_group=expert_group, world=world)
    return _GRID


def get_grid() -> Grid:
    """The current grid: the one ``init_grid`` built in this process group,
    else every rank on the data axis (plain data parallelism), else 1 × 1
    outside a group."""
    world = _world()
    if _GRID is not None and _GRID.world is world:
        return _GRID
    if world is None:
        return Grid()
    return Grid(data=dist.get_world_size(), expert=1, rank=dist.get_rank(),
                world=world)


def data_coords() -> tuple[int, int]:
    """(this rank's data coordinate, d): how the loaders split rows."""
    grid = get_grid()
    return grid.data_index, grid.data
