"""The train and eval steps (counterpart of medmoe_tpu/train/step.py;
reference medmoe_module.py:318-339 + Lightning's accumulation).

One optimizer step runs a Python loop over the micro-batches: each one's
forward and backward, its gradients summed into float32 accumulators. The
sum is scaled by 1/accum (the metrics are averaged the same way), the
global norm of that mean gradient is recorded as ``grad_norm`` before
clipping, then the clip and Adam run on it. Metrics stay device tensors:
nothing here waits for the device.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from medmoe_torch.train.optim import global_norm
from medmoe_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]


def build_train_step(module, accum_steps: int = 1) -> Callable:
    """Returns step(state, micro_batches) -> (state, metrics), where
    ``micro_batches`` is the list of the window's ``accum_steps``
    micro-batches, each a dict of tensors on the model's device."""

    def step(state: TrainState, micro_batches: List[Batch]
             ) -> Tuple[TrainState, Batch]:
        if len(micro_batches) != accum_steps:
            raise ValueError(f"expected {accum_steps} micro-batches, got "
                             f"{len(micro_batches)}")
        module.model.train()
        params = state.params
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        metrics_acc: Batch = {}
        for micro in micro_batches:
            loss, metrics = module.loss_fn(micro)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            for a, g in zip(acc, grads):
                if g is not None:
                    a.add_(g)
            for k, v in metrics.items():
                metrics_acc[k] = metrics_acc[k] + v if k in metrics_acc else v
        if accum_steps > 1:
            inv = 1.0 / accum_steps
            for a in acc:
                a.mul_(inv)
            metrics_acc = {k: v * inv for k, v in metrics_acc.items()}
        norm = global_norm(acc)
        state.apply_gradients(acc, norm)
        metrics_acc["grad_norm"] = norm
        return state, metrics_acc

    return step


def build_eval_step(module) -> Callable:
    """Returns eval_step(batch) -> metrics (eval mode, no gradients)."""

    def eval_step(batch: Batch) -> Batch:
        module.model.eval()
        with torch.no_grad():
            _, metrics = module.loss_fn(batch)
        return metrics

    return eval_step
