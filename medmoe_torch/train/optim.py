"""Optimizer and scheduler (counterpart of medmoe_tpu/train/optim.py;
reference configs/model/med-moe_pretraining.yaml:7-18).

``adam`` describes torch.optim.Adam with L2 weight decay added to the
gradient (what optax.add_decayed_weights before scale_by_adam computes)
and optax's global-norm clip in front of it. ``reduce_lr_on_plateau`` is
the host-side ReduceLROnPlateau the trainer steps on ``val/loss`` once an
epoch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, List, Optional

import torch


@dataclass(frozen=True)
class Adam:
    """What ``adam`` returns: the hyperparameters; ``init`` builds the
    torch optimizer over the parameters that require a gradient."""
    lr: float = 5e-5
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    gradient_clip_val: Optional[float] = None

    def init(self, params: Iterable[torch.nn.Parameter]) -> torch.optim.Adam:
        # frozen parameters carry no Adam state, as optax.masked gives
        trainable = [p for p in params if p.requires_grad]
        return torch.optim.Adam(trainable, lr=self.lr,
                                betas=(self.b1, self.b2), eps=self.eps,
                                weight_decay=self.weight_decay)


def adam(lr: float = 5e-5, weight_decay: float = 0.0, b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8,
         gradient_clip_val: Optional[float] = None) -> Adam:
    return Adam(float(lr), float(weight_decay), float(b1), float(b2),
                float(eps), gradient_clip_val)


def global_norm(grads: List[torch.Tensor],
                sharded: Optional[List[bool]] = None,
                group=None) -> torch.Tensor:
    """sqrt(Σ g²) over every tensor, as a 0-d device tensor.

    With ``sharded`` (one flag a tensor: a slice of the expert bank under
    expert parallelism) the replicated tensors' Σg² is taken once and the
    slices' Σg² is summed over the expert ``group``: the norm of the whole
    gradient, the same on every rank."""
    if not sharded or not any(sharded):
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in grads))
    from medmoe_torch.parallel import collectives as C

    sq = [torch.sum(torch.square(g.float())) for g in grads]
    rep = sum(q for q, s in zip(sq, sharded) if not s)
    local = C.all_reduce_sum(sum(q for q, s in zip(sq, sharded) if s), group)
    return torch.sqrt(rep + local)


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None
                        ) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: g / ‖g‖ · max_norm when ‖g‖ ≥ max_norm,
    else g unchanged (torch.nn.utils.clip_grad_norm_ divides by ‖g‖ + 1e-6
    instead). Stays on the device: no host sync."""
    norm = global_norm(grads) if norm is None else norm
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


class reduce_lr_on_plateau:  # noqa: N801 — config-surface name
    """Host-side ReduceLROnPlateau (reference scheduler config: mode=min,
    factor=0.1, patience=10, monitored on val/loss per epoch)."""

    def __init__(self, mode: str = "min", factor: float = 0.1,
                 patience: int = 10, min_lr: float = 0.0,
                 threshold: float = 1e-4):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.best = math.inf if mode == "min" else -math.inf
        self.num_bad_epochs = 0

    def _is_better(self, value: float) -> bool:
        if self.mode == "min":
            return value < self.best * (1.0 - self.threshold)
        return value > self.best * (1.0 + self.threshold)

    def step(self, value: float, current_lr: float) -> float:
        """Returns the (possibly reduced) learning rate."""
        if self._is_better(value):
            self.best = value
            self.num_bad_epochs = 0
            return current_lr
        self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.num_bad_epochs = 0
            return max(current_lr * self.factor, self.min_lr)
        return current_lr

    def state_dict(self) -> dict:
        return {"best": self.best, "num_bad_epochs": self.num_bad_epochs}

    def load_state_dict(self, state: dict) -> None:
        self.best = state["best"]
        self.num_bad_epochs = state["num_bad_epochs"]
