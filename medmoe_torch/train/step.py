"""The train and eval steps (counterpart of medmoe_tpu/train/step.py;
reference medmoe_module.py:318-339 + Lightning's accumulation).

One optimizer step runs a Python loop over the micro-batches: each one's
forward and backward, its gradients summed into the float32 parameters'
``.grad``. The sum is scaled by 1/accum (the metrics are averaged the same
way), the global norm of that mean gradient is recorded as ``grad_norm``
before clipping, then the clip and Adam run on it. Metrics stay device
tensors: nothing here waits for the device. The soft-label targets are
computed per micro-batch inside ``module.loss_fn``, as JAX's
``loss_for_micro`` does; the tool BERT is not among ``state.params``, so
the accumulation, the clip and Adam never touch it.

Under data-parallel training (``module.ddp``, a DistributedDataParallel
wrapper) every micro-batch but the last runs under ``no_sync``, so the
gradients are averaged over the ranks once a step, in the last backward;
``grad_norm`` and the clip then read that reduced, global gradient.

Under expert parallelism each rank holds a slice of the expert bank, and
its gradient: ``grad_norm`` adds the slices' Σg², summed over the expert
group, to the replicated parameters' (``optim.global_norm``), so every
rank clips by the same norm; Adam then updates each rank's slice.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Tuple

import torch

from medmoe_torch.parallel.sharding import bank_grid, expert_flags
from medmoe_torch.train.optim import global_norm
from medmoe_torch.train.state import TrainState
from medmoe_torch.utils.trace import span

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
        for p in params:
            p.grad = None
        ddp = getattr(module, "ddp", None)
        metrics_acc: Batch = {}
        for i, micro in enumerate(micro_batches):
            last = i == len(micro_batches) - 1
            with (ddp.no_sync() if ddp is not None and not last
                  else contextlib.nullcontext()):
                with span("medmoe#step.forward"):
                    loss, metrics = module.loss_fn(micro)
                with span("medmoe#step.backward"):
                    loss.backward()
            for k, v in metrics.items():
                metrics_acc[k] = metrics_acc[k] + v if k in metrics_acc else v
        with span("medmoe#step.optimizer"):
            acc = [p.grad if p.grad is not None
                   else torch.zeros_like(p, dtype=torch.float32)
                   for p in params]
            if accum_steps > 1:
                inv = 1.0 / accum_steps
                for a in acc:
                    a.mul_(inv)
                metrics_acc = {k: v * inv for k, v in metrics_acc.items()}
            grid = bank_grid(module.model)
            norm = global_norm(acc, expert_flags(module.model, params),
                               grid.expert_group if grid else None)
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
