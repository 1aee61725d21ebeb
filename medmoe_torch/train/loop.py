"""The Trainer: epoch loop, accumulation windows, validation, the plateau
scheduler and logging (counterpart of medmoe_tpu/train/loop.py; reference
src/train.py:73-101 + configs/trainer/*), in one process on one device.

Knobs kept from the JAX Trainer: max epochs, gradient clip and
accumulation (with the leftover window flushed at epoch end, as Lightning
does), limit_{train,val,test}_batches, overfit_batches,
num_sanity_val_steps, check_val_every_n_epoch, log_every_n_steps and
detect_anomaly (``torch.autograd.set_detect_anomaly``, scoped to ``fit``).
Not ported yet, and refused when asked for: several processes or nodes,
an expert-parallel mesh, callbacks, resuming from a checkpoint, the
profiler and the preemption handlers.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterable, List, Optional

import torch

from medmoe_torch.data.prefetch import prefetch
from medmoe_torch.models.layers import set_generator
from medmoe_torch.train.optim import get_learning_rate, set_learning_rate
from medmoe_torch.train.state import TrainState, param_count
from medmoe_torch.train.step import build_eval_step, build_train_step
from medmoe_torch.utils.logging import get_logger

log = get_logger(__name__)


def _aggregate_metric_buffers(buffers: Dict[str, List]) -> Dict[str, float]:
    """Mean per key over buffered per-step device scalars: one stack and
    one device→host copy per key."""
    return {k: float(torch.stack([v.float() for v in vals]).cpu().numpy()
                     .mean())
            for k, vals in buffers.items()}


def _limit(iterable: Iterable, limit: Optional[float],
           steps_per_epoch: Optional[int], what: str = "train") -> Iterable:
    """Cap an epoch's batches, Lightning semantics: an int is a batch count,
    a float a fraction of the dataloader (1.0 = all). A fraction of a
    dataloader of unknown length is an error."""
    if limit is None:
        yield from iterable
        return
    if isinstance(limit, float) and not limit.is_integer():
        if not steps_per_epoch:
            raise ValueError(
                f"limit_{what}_batches={limit} is a dataset fraction but the "
                f"{what} dataloader length is unknown; set steps_per_epoch "
                f"or use an integer batch count")
        limit = max(1, int(limit * steps_per_epoch))
    elif isinstance(limit, float) and limit == 1.0:
        yield from iterable
        return
    limit = int(limit)
    for i, item in enumerate(iterable):
        if i >= limit:
            return
        yield item


def resolve_accelerator(accelerator: str) -> torch.device:
    """``gpu``/``cuda`` → the CUDA card (raises without one); ``cpu`` → the
    CPU, the only way to get it."""
    if accelerator in ("gpu", "cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "trainer.accelerator=gpu and no CUDA device is available; "
                "pass trainer.accelerator=cpu to train on the CPU")
        return torch.device("cuda")
    if accelerator == "cpu":
        return torch.device("cpu")
    raise ValueError(f"trainer.accelerator must be gpu or cpu, got "
                     f"{accelerator!r}")


class Trainer:
    def __init__(self, max_epochs: int = 10,
                 accelerator: str = "gpu", devices: Any = 1,
                 num_nodes: int = 1,
                 accumulate_grad_batches: int = 1,
                 gradient_clip_val: Optional[float] = None,
                 mesh: Optional[Dict[str, int]] = None,
                 check_val_every_n_epoch: int = 1,
                 limit_train_batches: Optional[float] = None,
                 limit_val_batches: Optional[float] = None,
                 limit_test_batches: Optional[float] = None,
                 num_sanity_val_steps: int = 2,
                 log_every_n_steps: int = 10,
                 detect_anomaly: bool = False,
                 overfit_batches: int = 0,
                 steps_per_epoch: Optional[int] = None,
                 prefetch_batches: int = 2,
                 profiler: Optional[str] = None,
                 default_root_dir: str = ".",
                 callbacks: Optional[List] = None,
                 loggers: Optional[List] = None,
                 checkpoint_on_signal: bool = False,
                 seed: int = 0):
        if devices not in (1, "1", "auto") or int(num_nodes or 1) > 1:
            raise NotImplementedError(
                "multi-device (DDP) training is not ported yet; use "
                "trainer.devices=1 trainer.num_nodes=1")
        if int((mesh or {}).get("expert", 1) or 1) > 1:
            raise NotImplementedError("an expert-parallel mesh is not ported "
                                      "yet; use trainer.mesh.expert=1")
        if profiler:
            raise NotImplementedError("the trainer's profiler is not ported "
                                      "yet; use trainer.profiler=null")
        if checkpoint_on_signal:
            raise NotImplementedError(
                "preemption checkpoints are not ported yet; use "
                "trainer.checkpoint_on_signal=false")
        if callbacks:
            raise NotImplementedError("trainer callbacks are not ported yet; "
                                      "use callbacks=none")
        self.device = resolve_accelerator(accelerator)
        self.max_epochs = max_epochs
        self.accumulate_grad_batches = max(int(accumulate_grad_batches), 1)
        self.gradient_clip_val = gradient_clip_val
        self.check_val_every_n_epoch = check_val_every_n_epoch
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.limit_test_batches = limit_test_batches
        self.num_sanity_val_steps = num_sanity_val_steps
        self.log_every_n_steps = log_every_n_steps
        self.detect_anomaly = detect_anomaly
        self.overfit_batches = int(overfit_batches or 0)
        self.steps_per_epoch = steps_per_epoch
        self.prefetch_batches = int(prefetch_batches)
        self.default_root_dir = default_root_dir
        self.loggers = loggers or []
        self.seed = seed

        self.state: Optional[TrainState] = None
        self.module = None
        self.scheduler = None
        self.metrics_history: List[Dict[str, float]] = []

    # ------------------------------------------------------------------
    def _log(self, metrics: Dict[str, float], step: int) -> None:
        for logger in self.loggers:
            logger.log_metrics(metrics, step)

    def to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """numpy host batch → tensors on the trainer's device (through
        pinned memory to a card, so the copy does not wait on the host)."""
        if self.device.type == "cpu":
            return {k: torch.as_tensor(v) for k, v in batch.items()}
        return {k: torch.as_tensor(v).pin_memory().to(self.device,
                                                      non_blocking=True)
                for k, v in batch.items()}

    def _check_kernel_limits(self, module, datamodule) -> None:
        """On a card, the kernels' shape limits before any step runs."""
        if self.device.type == "cuda":
            module.check_kernel_limits(getattr(datamodule, "batch_size", None))

    def epoch_generator(self, epoch: int) -> torch.Generator:
        """The training-mode noise source of ``epoch``: seeded from (seed,
        epoch), as the JAX loop folds the epoch into its key."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed((int(self.seed) * 1_000_003 + epoch) % 2**63)
        return gen

    # ------------------------------------------------------------------
    def fit(self, module, datamodule, ckpt_path: Optional[str] = None) -> None:
        if ckpt_path:
            raise NotImplementedError("resuming from a checkpoint is not "
                                      "ported yet; use ckpt_path=null")
        if self.detect_anomaly:
            with torch.autograd.set_detect_anomaly(True):
                return self._fit(module, datamodule)
        return self._fit(module, datamodule)

    def _fit(self, module, datamodule) -> None:
        self.module = module
        module.init_params(self.seed)
        module.model.to(self.device)
        self._check_kernel_limits(module, datamodule)
        tx = module.make_optimizer(gradient_clip_val=self.gradient_clip_val)
        self.state = TrainState.create(module.model, tx)
        self.scheduler = module.make_scheduler()

        step_cache: Dict[int, Any] = {}

        def get_step(accum: int):
            if accum not in step_cache:
                step_cache[accum] = build_train_step(module, accum_steps=accum)
            return step_cache[accum]

        train_step = get_step(self.accumulate_grad_batches)
        eval_step = build_eval_step(module)

        self._log({"model/params_M": param_count(module.model) / 1e6},
                  self.state.step)

        if self.num_sanity_val_steps:
            for i, batch in enumerate(datamodule.val_dataloader()):
                if i >= self.num_sanity_val_steps:
                    break
                eval_step(self.to_device(batch))

        global_step = self.state.step
        overfit_cache: List = []
        accum = self.accumulate_grad_batches

        for epoch in range(self.max_epochs):
            set_generator(module.model, self.epoch_generator(epoch))
            epoch_metrics: Dict[str, List] = {}
            micro_batches: List = []
            t_epoch = time.time()
            n_pairs = 0

            if self.overfit_batches:
                if not overfit_cache:
                    for batch in datamodule.train_dataloader(epoch=0):
                        overfit_cache.append(self.to_device(batch))
                        if len(overfit_cache) >= self.overfit_batches:
                            break
                train_iter: Iterable = iter(list(overfit_cache))
            else:
                loader = datamodule.train_dataloader(epoch=epoch)
                steps = self.steps_per_epoch or getattr(
                    datamodule, "steps_per_epoch", None)
                # each micro-batch reaches the device on the prefetch
                # thread while the step before it runs
                train_iter = prefetch(
                    _limit(loader, self.limit_train_batches, steps, "train"),
                    self.prefetch_batches, self.to_device)

            def run(window: List, step_fn) -> Dict[str, torch.Tensor]:
                nonlocal global_step, n_pairs
                self.state, metrics = step_fn(self.state, window)
                global_step += 1
                n_pairs += sum(len(b["cap_lens"]) for b in window)
                for k, v in metrics.items():
                    epoch_metrics.setdefault(f"train/{k}", []).append(v)
                return metrics

            for batch in train_iter:
                micro_batches.append(batch)
                if len(micro_batches) < accum:
                    continue
                metrics = run(micro_batches, train_step)
                micro_batches = []
                # metrics stay on the device; the host reads them every
                # log_every_n_steps and once an epoch
                if global_step % self.log_every_n_steps == 0:
                    host = {f"train/{k}": float(v) for k, v in metrics.items()}
                    host["lr"] = get_learning_rate(self.state.optimizer)
                    host["epoch"] = epoch
                    self._log(host, global_step)

            # the leftover window steps the optimizer too (Lightning)
            if micro_batches:
                run(micro_batches, get_step(len(micro_batches)))

            agg = _aggregate_metric_buffers(epoch_metrics)
            train_time = time.time() - t_epoch
            if (epoch + 1) % self.check_val_every_n_epoch == 0:
                agg.update(self.validate(datamodule, eval_step))
            agg["epoch_time_s"] = time.time() - t_epoch
            if train_time > 0 and n_pairs:
                agg["pairs_per_sec"] = n_pairs / train_time
            self.metrics_history.append(agg)
            self._log(agg, global_step)
            log.info(f"epoch {epoch}: " + ", ".join(
                f"{k}={v:.4f}" for k, v in sorted(agg.items())))

            if self.scheduler is not None and "val/loss" in agg:
                current = get_learning_rate(self.state.optimizer)
                new_lr = self.scheduler.step(agg["val/loss"], current)
                if new_lr != current:
                    log.info(f"ReduceLROnPlateau: lr {current} -> {new_lr}")
                    set_learning_rate(self.state.optimizer, new_lr)

        for logger in self.loggers:
            logger.finalize()

    # ------------------------------------------------------------------
    def _evaluate(self, loader, limit, steps, what: str,
                  eval_step=None) -> Dict[str, float]:
        eval_step = eval_step or build_eval_step(self.module)
        sums: Dict[str, List] = {}
        for batch in prefetch(_limit(loader, limit, steps, what),
                              self.prefetch_batches, self.to_device):
            for k, v in eval_step(batch).items():
                sums.setdefault(f"{what}/{k}", []).append(v)
        return _aggregate_metric_buffers(sums)

    def validate(self, datamodule, eval_step=None) -> Dict[str, float]:
        return self._evaluate(datamodule.val_dataloader(),
                              self.limit_val_batches,
                              getattr(datamodule, "val_steps_per_epoch", None),
                              "val", eval_step)

    def test(self, module, datamodule,
             ckpt_path: Optional[str] = None) -> Dict[str, float]:
        """Eval metrics on the test split with the current weights (after
        ``fit``, or freshly initialized)."""
        if ckpt_path:
            raise NotImplementedError("restoring a checkpoint is not ported "
                                      "yet; use ckpt_path=null")
        if self.module is not module:
            self.module = module
            module.init_params(self.seed)
            module.model.to(self.device)
            self._check_kernel_limits(module, datamodule)
        out = self._evaluate(datamodule.test_dataloader(),
                             self.limit_test_batches,
                             getattr(datamodule, "test_steps_per_epoch",
                                     None), "test")
        self._log(out, self.state.step if self.state else 0)
        return out
