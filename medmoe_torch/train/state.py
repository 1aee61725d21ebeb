"""Train state (counterpart of medmoe_tpu/train/state.py): the model, its
optimizer over the trainable parameters, the clip value and the step
count. PyTorch updates the parameters in place. ``state_dict`` holds what
a checkpoint restores: the model, the Adam state (none for frozen
parameters, as optax.masked keeps none) and the step."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from medmoe_torch.train.optim import Adam, clip_by_global_norm


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    gradient_clip_val: Optional[float] = None
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, tx: Adam) -> "TrainState":
        return cls(model=model, optimizer=tx.init(model.parameters()),
                   gradient_clip_val=tx.gradient_clip_val)

    @property
    def params(self) -> List[nn.Parameter]:
        """The trainable parameters, in the optimizer's order."""
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def apply_gradients(self, grads: List[torch.Tensor],
                        norm: Optional[torch.Tensor] = None) -> "TrainState":
        """Clip (optax's global-norm formula; ``norm`` may be given when it
        is already computed) and take one Adam step with ``grads``, aligned
        with ``params``."""
        if self.gradient_clip_val:
            grads = clip_by_global_norm(grads, float(self.gradient_clip_val),
                                        norm)
        for p, g in zip(self.params, grads):
            p.grad = g
        self.optimizer.step()
        for p in self.params:
            p.grad = None
        self.step += 1
        return self

    def state_dict(self) -> Dict[str, Any]:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": int(self.step)}

    def load_state_dict(self, state: Dict[str, Any]) -> "TrainState":
        """Load ``state`` in place (the model strictly); shapes are checked
        by the caller (utils/checkpoint.restore_checkpoint)."""
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        return self


def param_count(model: nn.Module) -> int:
    """The whole model's parameters: an expert bank sharded over e ranks
    counts its K experts, not this rank's K/e."""
    from medmoe_torch.parallel.sharding import sharded_banks

    extra = sum(p.numel() * (bank.grid.expert - 1)
                for _, bank in sharded_banks(model)
                for p in bank.parameters())
    return sum(p.numel() for p in model.parameters()) + extra
