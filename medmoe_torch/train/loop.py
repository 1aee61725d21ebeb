"""The Trainer: epoch loop, accumulation windows, validation, the plateau
scheduler, callbacks, checkpoints and logging (counterpart of
medmoe_tpu/train/loop.py; reference src/train.py:73-101 +
configs/trainer/*), in one process on one device.

Knobs kept from the JAX Trainer: min/max epochs, gradient clip and
accumulation (with the leftover window flushed at epoch end, as Lightning
does), limit_{train,val,test}_batches, overfit_batches,
num_sanity_val_steps, check_val_every_n_epoch, log_every_n_steps,
detect_anomaly (``torch.autograd.set_detect_anomaly``, scoped to
``fit``), callbacks, resuming from a checkpoint (``fit(ckpt_path=...)``)
the preemption handlers (SIGTERM / SIGUSR1 → a blocking ``last``
checkpoint at the next step boundary, then stop; ``checkpoint_on_signal``)
and the profiler: a truthy ``profiler`` runs ``torch.profiler`` (CPU, and
CUDA on a card) over the epoch loop and writes one Chrome trace a rank to
``default_root_dir/profile/trace_rank{r}.json`` (JAX writes an xplane
there). ``deterministic`` is accepted and ignored, as in JAX.

Data-parallel training: ``devices`` ranks a node on ``num_nodes`` nodes,
one process a rank, joined in one ``torch.distributed`` group
(``parallel/multihost.py``; the train CLI starts a node's processes, or
torchrun does). Each rank trains on ``cuda:{LOCAL_RANK}`` (NCCL) or the
CPU (gloo), with the model wrapped in DistributedDataParallel: gradients
are averaged once a step (``train/step.py``), so the clip and the logged
``grad_norm`` read the global gradient. The ranks agree on preemption at
every step boundary (an all-reduce MAX of the flag, JAX's
``_preempt_agreed``), the epoch's train, validation and test metrics are
averaged over the ranks before any callback or logger reads them (so
every rank makes the same early-stopping and checkpoint decision), and
only rank 0 writes checkpoints, sidecars and logs, the others waiting at a
barrier.

Expert parallelism (``mesh: {data: d, expert: e}``, ``trainer=ep``): the
ranks form a d × e grid (``parallel/mesh.py``; a grid that does not
divide the ranks raises). The model is initialized whole from the seed,
then each expert bank is cut to the rank's K/e experts
(``parallel/sharding.py``); DDP averages every gradient over the rank's
data group only; the e ranks of an expert group hold the same rows. The
metrics are averaged over every rank (the expert ranks' are equal) and
``pairs_per_sec`` is summed over the data group; preemption agreement and
barriers span every rank. Checkpoints hold the whole bank.

Resume is exact at an epoch boundary: the data order, the caption draws
and the dropout generators are all seeded from (seed, epoch), and the
checkpoint holds the parameters, the Adam state, the step and the
scheduler. The soft-label tool BERT is not in it: its snapshot is taken
from the seed's init before the restore, so a resumed run scores with the
seed's initial BERT, as the JAX loop does.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Iterable, Iterator, List, Optional

import torch

from medmoe_torch.data.prefetch import prefetch
from medmoe_torch.models.layers import set_generator
from medmoe_torch.parallel import collectives as C
from medmoe_torch.parallel.mesh import init_grid
from medmoe_torch.parallel.multihost import local_rank, maybe_initialize
from medmoe_torch.parallel.sharding import shard_model
from medmoe_torch.train.optim import get_learning_rate, set_learning_rate
from medmoe_torch.train.state import TrainState, param_count
from medmoe_torch.train.step import build_eval_step, build_train_step
from medmoe_torch.utils.checkpoint import (load_model_weights, read_meta,
                                           restore_checkpoint,
                                           save_checkpoint)
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
    try:
        for i, item in enumerate(iterable):
            if i >= limit:
                return
            yield item
    finally:
        # an epoch cut short stops its loader's threads now, not at GC
        _close(iterable)


def _close(iterable) -> None:
    close = getattr(iterable, "close", None)
    if close is not None:
        close()


def _timed(iterable: Iterable, waits: List[float]) -> Iterator:
    """Yield from ``iterable``, adding the seconds each ``next`` blocks
    (on the prefetch queue: the host's loader falling behind) to
    ``waits[0]``."""
    it = iter(iterable)
    try:
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            waits[0] += time.perf_counter() - t0
            yield item
    finally:
        _close(it)


def resolve_accelerator(accelerator: str, index: int = 0) -> torch.device:
    """``gpu``/``cuda`` → the CUDA card ``index`` (raises without one);
    ``cpu`` → the CPU, the only way to get it."""
    if accelerator in ("gpu", "cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "trainer.accelerator=gpu and no CUDA device is available; "
                "pass trainer.accelerator=cpu to train on the CPU")
        return torch.device("cuda", index)
    if accelerator == "cpu":
        return torch.device("cpu")
    raise ValueError(f"trainer.accelerator must be gpu or cpu, got "
                     f"{accelerator!r}")


def resolve_devices(devices: Any, accelerator: str) -> int:
    """A node's ranks: ``auto`` is every visible card (one rank on the
    CPU); an int is checked against the visible cards."""
    on_card = accelerator in ("gpu", "cuda")
    visible = torch.cuda.device_count() if on_card else None
    if devices == "auto":
        return max(1, visible or 0) if on_card else 1
    n = int(devices)
    if n < 1:
        raise ValueError(f"trainer.devices must be >= 1 or auto, got "
                         f"{devices!r}")
    if on_card and torch.cuda.is_available() and n > visible:
        raise ValueError(f"trainer.devices={n} but {visible} CUDA "
                         f"device(s) are visible")
    return n


class Trainer:
    def __init__(self, min_epochs: int = 1, max_epochs: int = 10,
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
                 deterministic: bool = False,
                 detect_anomaly: bool = False,
                 overfit_batches: int = 0,
                 steps_per_epoch: Optional[int] = None,
                 prefetch_batches: int = 2,
                 profiler: Optional[str] = None,
                 default_root_dir: str = ".",
                 callbacks: Optional[List] = None,
                 loggers: Optional[List] = None,
                 checkpoint_on_signal: bool = True,
                 seed: int = 0):
        self.devices = resolve_devices(devices, accelerator)
        self.num_nodes = int(num_nodes or 1)
        world = self.devices * self.num_nodes
        maybe_initialize(self.num_nodes, accelerator)
        if C.get_world_size() != world or (world > 1 and not C.in_group()):
            raise RuntimeError(
                f"trainer.devices={self.devices} x trainer.num_nodes="
                f"{self.num_nodes} needs {world} processes in one group, one "
                f"a device; found {C.get_world_size()}. Launch through "
                f"python -m medmoe_torch.cli.train (which starts a node's "
                f"processes) or torchrun")
        #: this rank's place in the data × expert grid
        self.grid = init_grid(mesh)
        self.device = resolve_accelerator(accelerator, local_rank())
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self.min_epochs = min_epochs
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
        self.profiler = profiler
        self._prof = None
        self.default_root_dir = default_root_dir
        self.callbacks = callbacks or []
        self.loggers = loggers or []
        self.seed = seed

        self.state: Optional[TrainState] = None
        self.module = None
        self.scheduler = None
        self.best_model_path: Optional[str] = None
        #: the checkpoint this fit resumed from (None for a fresh run)
        self.resumed_from: Optional[str] = None
        self.metrics_history: List[Dict[str, float]] = []
        self.checkpoint_on_signal = checkpoint_on_signal
        self._preempt_requested = False
        self.interrupted = False

    # ------------------------------------------------------------------
    def request_preemption(self) -> None:
        """Checkpoint and stop at the next step boundary (the analogue of
        the reference's submitit SIGUSR1 + requeue,
        configs/hydra/launcher/base_submitit_slurm.yaml:25)."""
        self._preempt_requested = True

    def _preempt_agreed(self) -> bool:
        """At a step boundary: whether any rank was asked to preempt (an
        all-reduce MAX under a process group, so every rank stops at the
        same step)."""
        return C.any_rank(self._preempt_requested, self.device)

    def _install_signal_handlers(self) -> Dict[int, Any]:
        """SIGTERM and SIGUSR1 → ``request_preemption``; returns the
        handlers they replace. Outside the main thread ``signal.signal``
        raises ValueError, and nothing is installed."""
        if not self.checkpoint_on_signal:
            return {}
        import signal

        def handler(signum, frame):
            log.info(f"received signal {signum}: will checkpoint and stop "
                     f"at the next step boundary")
            self.request_preemption()

        previous = {}
        try:
            for sig in (signal.SIGTERM, getattr(signal, "SIGUSR1", None)):
                if sig is not None:
                    previous[sig] = signal.signal(sig, handler)
        except ValueError:
            pass        # not the main thread (e.g. under a test runner)
        return previous

    @staticmethod
    def _restore_signal_handlers(previous: Dict[int, Any]) -> None:
        import signal

        for sig, handler in previous.items():
            signal.signal(sig, handler)

    def _preempt_checkpoint(self, epoch: int) -> str:
        """A blocking ``last`` checkpoint mid-epoch, in the callbacks'
        checkpoint directory. Its sidecar names the previous epoch, so a
        resume re-runs the interrupted one (the data is seeded by epoch;
        steps within it are not replayable)."""
        dirpath = None
        for cb in self.callbacks:
            dirpath = getattr(cb, "dirpath", None) or dirpath
        path = os.path.join(dirpath or os.path.join(self.default_root_dir,
                                                    "checkpoints"), "last")
        save_checkpoint(path, self.state,
                        extra={"epoch": epoch - 1, "preempted": True,
                               **self.checkpoint_extra()})
        C.barrier()
        log.info(f"preemption checkpoint written to {path}")
        return path

    def checkpoint_extra(self) -> Dict[str, Any]:
        """Loop state saved beside the train state: the plateau
        scheduler's best and patience (so a resume keeps the LR trajectory)
        and the seed."""
        extra: Dict[str, Any] = {"seed": int(self.seed)}
        if self.scheduler is not None and hasattr(self.scheduler,
                                                  "state_dict"):
            extra["scheduler"] = self.scheduler.state_dict()
        return extra

    def _log(self, metrics: Dict[str, float], step: int) -> None:
        for logger in self.loggers:
            logger.log_metrics(metrics, step)

    def _across_ranks(self, metrics: Dict[str, float]) -> Dict[str, float]:
        """Every value averaged over the ranks (``pairs_per_sec`` summed: the
        global rate); unchanged outside a process group. Every rank must
        call it with the same keys."""
        if not C.in_group():
            return metrics
        keys = sorted(metrics)
        mean = C.all_reduce_mean(torch.tensor(
            [float(metrics[k]) for k in keys], dtype=torch.float64,
            device=self.device)).cpu().tolist()
        out = dict(zip(keys, mean))
        if "pairs_per_sec" in out:
            # the data ranks' rates summed; an expert group's ranks train
            # the same pairs
            out["pairs_per_sec"] *= self.grid.data
        return out

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
        previous = self._install_signal_handlers()
        try:
            if self.detect_anomaly:
                with torch.autograd.set_detect_anomaly(True):
                    return self._fit(module, datamodule, ckpt_path)
            return self._fit(module, datamodule, ckpt_path)
        finally:
            self._stop_profiler()      # a fit that raised still writes it
            self._restore_signal_handlers(previous)

    def _start_profiler(self) -> None:
        if not self.profiler:
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.start()

    def _stop_profiler(self) -> Optional[str]:
        """Stop the profiler that ``_start_profiler`` started and write its
        Chrome trace; returns the trace's path (None when none ran)."""
        prof, self._prof = self._prof, None
        if prof is None:
            return None
        prof.stop()
        profile_dir = os.path.join(self.default_root_dir, "profile")
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, f"trace_rank{C.get_rank()}.json")
        prof.export_chrome_trace(path)
        log.info(f"profile written to {path}")
        return path

    def _resume(self, ckpt_path: str) -> int:
        """Restore the train state and the scheduler from ``ckpt_path``;
        returns the epoch to start at (0 without a sidecar, as JAX)."""
        payload = restore_checkpoint(ckpt_path, self.state)
        meta = read_meta(ckpt_path)
        start_epoch = int(meta.get("epoch", -1)) + 1 if meta else 0
        sched = payload.get("scheduler") or (meta or {}).get("scheduler")
        if self.scheduler is not None and sched:
            self.scheduler.load_state_dict(sched)
        self.resumed_from = ckpt_path
        log.info(f"resumed from {ckpt_path} at step {self.state.step}, "
                 f"epoch {start_epoch}")
        return start_epoch

    def _place_model(self, module, datamodule) -> None:
        """Initialize ``module``'s model from the seed, snapshot the
        soft-label tool BERT (the seed's, before any restore), cut the
        expert banks to this rank's experts (expert parallelism) and move
        the model to the device; then the checks that must pass before
        the first step."""
        self.module = module
        module.init_params(self.seed)
        if hasattr(module, "capture_tool_params"):
            module.capture_tool_params(self.device)
        shard_model(module.model, self.grid)
        module.model.to(self.device)
        if hasattr(module, "check_blocks"):
            module.check_blocks(getattr(datamodule, "batch_size", None))
        self._check_kernel_limits(module, datamodule)

    def _fit(self, module, datamodule, ckpt_path: Optional[str]) -> None:
        self._place_model(module, datamodule)
        tx = module.make_optimizer(gradient_clip_val=self.gradient_clip_val)
        self.state = TrainState.create(module.model, tx)
        self.scheduler = module.make_scheduler()
        self.resumed_from = None
        start_epoch = self._resume(ckpt_path) if ckpt_path else 0
        module.ddp = None
        if C.in_group():
            # checkpoints keep the bare model's keys (no "module." prefix),
            # so they resume on any number of ranks
            import warnings

            from torch.nn.parallel import DistributedDataParallel

            # a training BERT's pooler feeds no loss: DDP must then expect
            # parameters that get no gradient (JAX gives them zeros)
            bert = getattr(getattr(module.model, "text_encoder", None),
                           "bert", None)
            unused = bert is not None and any(
                p.requires_grad for p in bert.pooler.parameters())
            with warnings.catch_warnings():
                # the buffers are constants (index tables): never synced
                warnings.simplefilter("ignore", FutureWarning)
                module.ddp = DistributedDataParallel(
                    module.model,
                    device_ids=[self.device] if self.device.type == "cuda"
                    else None, broadcast_buffers=False,
                    process_group=self.grid.data_group,
                    find_unused_parameters=unused)

        step_cache: Dict[int, Any] = {}

        def get_step(accum: int):
            if accum not in step_cache:
                step_cache[accum] = build_train_step(module, accum_steps=accum)
            return step_cache[accum]

        train_step = get_step(self.accumulate_grad_batches)
        eval_step = build_eval_step(module)

        self._log({"model/params_M": param_count(module.model) / 1e6},
                  self.state.step)
        for cb in self.callbacks:
            cb.on_train_start(self)

        if self.num_sanity_val_steps:
            for i, batch in enumerate(datamodule.val_dataloader()):
                if i >= self.num_sanity_val_steps:
                    break
                eval_step(self.to_device(batch))

        global_step = self.state.step
        overfit_cache: List = []
        accum = self.accumulate_grad_batches
        self._start_profiler()

        for epoch in range(start_epoch, self.max_epochs):
            set_generator(module.model, self.epoch_generator(epoch))
            epoch_metrics: Dict[str, List] = {}
            micro_batches: List = []
            t_epoch = time.time()
            n_pairs = 0
            waits = [0.0]

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
                batches = _limit(loader, self.limit_train_batches, steps,
                                 "train")
                if C.in_group() and steps:
                    # every rank takes the epoch's step count, also when
                    # its shards hold more rows than another rank's
                    batches = _limit(batches, int(steps), steps)
                # each micro-batch reaches the device on the prefetch
                # thread while the step before it runs
                train_iter = prefetch(batches, self.prefetch_batches,
                                      self.to_device)

            def run(window: List, step_fn) -> Dict[str, torch.Tensor]:
                nonlocal global_step, n_pairs
                self.state, metrics = step_fn(self.state, window)
                global_step += 1
                n_pairs += sum(b["image"].shape[0] for b in window)
                for k, v in metrics.items():
                    epoch_metrics.setdefault(f"train/{k}", []).append(v)
                return metrics

            timed = _timed(train_iter, waits)
            n_batches = 0
            preempted = False
            for batch in timed:
                n_batches += 1
                micro_batches.append(batch)
                if len(micro_batches) < accum:
                    continue
                metrics = run(micro_batches, train_step)
                micro_batches = []
                # metrics stay on the device; the host reads them every
                # log_every_n_steps and once an epoch
                if global_step % self.log_every_n_steps == 0:
                    host = self._across_ranks(
                        {f"train/{k}": float(v) for k, v in metrics.items()})
                    host["lr"] = get_learning_rate(self.state.optimizer)
                    host["epoch"] = epoch
                    self._log(host, global_step)
                if self._preempt_agreed():
                    preempted = self._preempt_requested = True
                    break
            timed.close()           # stops the prefetch threads early too
            if not n_batches and epoch == start_epoch \
                    and self.limit_train_batches != 0:
                raise ValueError(
                    "the train dataloader yielded no batches — check the "
                    "data paths (data.train_data_paths / data.data_dir) and "
                    "that batch_size does not exceed the dataset size")

            if preempted:
                self._preempt_checkpoint(epoch)
                self.interrupted = True
                log.info(f"stopping after the preemption checkpoint (epoch "
                         f"{epoch}, step {global_step})")
                break

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
                # the share of the train phase spent waiting on the loader
                agg["loader_wait_share"] = waits[0] / train_time
            agg = self._across_ranks(agg)
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

            stop = False
            for cb in self.callbacks:
                cb.on_epoch_end(self, epoch, agg)
                if cb.should_stop and epoch + 1 >= self.min_epochs:
                    stop = True
            C.barrier()
            if stop:
                log.info("early stopping triggered")
                break

        self._stop_profiler()
        for cb in self.callbacks:
            cb.on_train_end(self)
            if getattr(cb, "best_path", None):
                self.best_model_path = cb.best_path
        for logger in self.loggers:
            logger.finalize()
        C.barrier()

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
        """Eval metrics on the test split with the weights of
        ``ckpt_path`` when given, else the current ones (after ``fit``, or
        freshly initialized)."""
        if self.module is not module:
            self._place_model(module, datamodule)
        if ckpt_path:
            load_model_weights(module.model, ckpt_path)
        out = self._across_ranks(self._evaluate(
            datamodule.test_dataloader(), self.limit_test_batches,
            getattr(datamodule, "test_steps_per_epoch", None), "test"))
        self._log(out, self.state.step if self.state else 0)
        return out
