"""Trainer callbacks (counterpart of medmoe_tpu/train/callbacks.py;
reference configs/callbacks/default.yaml surface): ModelCheckpoint,
EarlyStopping, ProgressBar and ModelSummary.

Two things differ from the JAX package on purpose: only rank 0 deletes an
evicted checkpoint, and after a resume (``trainer.resumed_from`` set)
ModelCheckpoint rebuilds its kept top-k set (and its best value) from the
``*.meta.json`` sidecars already in its directory on its first save, so a
resumed run keeps ``save_top_k`` files and does not save a checkpoint
worse than the best one before the resume. A fresh run keeps a fresh set,
as JAX does, whatever an earlier run left in the directory.

Each saved file is handed to the loggers (``log_checkpoint``, alias
``best`` or ``last``), and a run whose loggers read those files (wandb with
``log_model``) saves blocking, so no logger reads a file still being
written.
"""

from __future__ import annotations

import glob
import math
import os
from typing import Any, Dict, Optional

from medmoe_torch.utils.checkpoint import (finalize_saves, read_meta,
                                           save_checkpoint)
from medmoe_torch.utils.loggers import BaseLogger
from medmoe_torch.utils.logging import _process_index, get_logger


class Callback:
    def on_train_start(self, trainer) -> None: ...
    def on_epoch_end(self, trainer, epoch: int,
                     metrics: Dict[str, float]) -> None: ...
    def on_train_end(self, trainer) -> None: ...

    @property
    def should_stop(self) -> bool:
        return False


def _reads_checkpoint_files(logger) -> bool:
    """True only for loggers that read the checkpoint files when a save is
    announced (WandbLogger with ``log_model``). Every logger inherits a
    no-op ``log_checkpoint`` from BaseLogger, so having the attribute is
    not the test: that would make every ``logger=csv`` run save blocking.
    The hook must be an override, and ``log_model`` (where the logger has
    the knob) must be on."""
    hook = getattr(type(logger), "log_checkpoint", None)
    if hook is None or hook is BaseLogger.log_checkpoint:
        return False
    return bool(getattr(logger, "log_model", True))


class ModelCheckpoint(Callback):
    """Monitors a metric, keeps the best ``save_top_k`` checkpoints and
    ``last`` (reference ModelCheckpoint: monitor val/loss, save_last,
    top-1)."""

    def __init__(self, dirpath: Optional[str] = "checkpoints",
                 filename: Optional[str] = "epoch_{epoch:03d}",
                 monitor: str = "val/loss", mode: str = "min",
                 save_last: bool = True, save_top_k: int = 1,
                 auto_insert_metric_name: bool = False,
                 async_save: bool = True):
        # Lightning semantics: a null dirpath resolves under the trainer's
        # root dir at save time, a null filename to the default
        self.dirpath = dirpath
        self.filename = filename or "epoch_{epoch:03d}"
        self.monitor = monitor
        self.mode = mode
        self.save_last = save_last
        self.save_top_k = save_top_k
        self.async_save = async_save
        self.best_value = math.inf if mode == "min" else -math.inf
        self.best_path: Optional[str] = None
        #: kept monitored checkpoints: [(score, path)], score smaller-is-
        #: better whatever the mode
        self._kept: list = []
        self._rebuilt = False

    def _is_better(self, value: float) -> bool:
        return value < self.best_value if self.mode == "min" \
            else value > self.best_value

    def _score(self, value: float) -> float:
        return value if self.mode == "min" else -value

    def _rebuild_kept(self, dirpath: str) -> None:
        """The kept set and best value from the sidecars a previous run
        left in ``dirpath`` (``last`` and sidecars of missing files
        excluded)."""
        for meta_path in sorted(glob.glob(os.path.join(dirpath,
                                                       "*.meta.json"))):
            path = meta_path[:-len(".meta.json")]
            if os.path.basename(path) == "last" or not os.path.isfile(path):
                continue
            value = (read_meta(path) or {}).get(self.monitor)
            if value is None or any(p == path for _, p in self._kept):
                continue
            self._kept.append((self._score(float(value)), path))
            if self._is_better(float(value)):
                self.best_value, self.best_path = float(value), path

    def _prune_kept(self) -> None:
        """Drop outperformed checkpoints beyond k (save_top_k=-1 keeps
        all). An evicted file was written at least one save barrier ago,
        so deleting it never races its write. Rank 0 deletes."""
        if self.save_top_k < 0:
            return
        self._kept.sort(key=lambda sp: sp[0])
        while len(self._kept) > self.save_top_k:
            _, path = self._kept.pop()           # worst
            if any(path == p for _, p in self._kept) \
                    or _process_index() != 0:
                continue
            for victim in (path, path + ".meta.json"):
                try:
                    os.remove(victim)
                except OSError:
                    pass

    def on_epoch_end(self, trainer, epoch: int,
                     metrics: Dict[str, float]) -> None:
        loop_extra = getattr(trainer, "checkpoint_extra", dict)()
        dirpath = self.dirpath or os.path.join(
            getattr(trainer, "default_root_dir", "."), "checkpoints")
        if not self._rebuilt:
            self._rebuilt = True
            if getattr(trainer, "resumed_from", None):
                self._rebuild_kept(dirpath)
        # a logger that reads the files at announce time must not find a
        # write still in flight
        blocking = (not self.async_save) or any(
            _reads_checkpoint_files(lg)
            for lg in getattr(trainer, "loggers", []) or [])
        value = metrics.get(self.monitor)
        if self.save_top_k != 0 and value is not None \
                and self._is_better(float(value)):
            self.best_value = float(value)
            self.best_path = os.path.join(dirpath,
                                          self.filename.format(epoch=epoch))
            save_checkpoint(self.best_path, trainer.state,
                            extra={"epoch": epoch, self.monitor: value,
                                   **loop_extra}, blocking=blocking)
            self._kept.append((self._score(float(value)), self.best_path))
            self._prune_kept()
            self._announce(trainer, self.best_path, "best",
                           {"epoch": epoch, self.monitor: float(value)})
        if self.save_last:
            last_path = os.path.join(dirpath, "last")
            save_checkpoint(last_path, trainer.state,
                            extra={"epoch": epoch, **loop_extra},
                            blocking=blocking)
            self._announce(trainer, last_path, "last", {"epoch": epoch})

    def on_train_end(self, trainer) -> None:
        """Commit the in-flight save before fit() returns: callers (test
        with the best checkpoint, serving, process exit) may read it at
        once."""
        finalize_saves()

    @staticmethod
    def _announce(trainer, path: str, alias: str,
                  metadata: Dict[str, Any]) -> None:
        """Offer the saved checkpoint to the loggers (reference wandb.yaml
        ``log_model: True`` uploads Lightning checkpoints)."""
        for logger in getattr(trainer, "loggers", []) or []:
            hook = getattr(logger, "log_checkpoint", None)
            if hook is not None:
                hook(path, alias=alias, metadata=metadata)


class EarlyStopping(Callback):
    """Stops on a plateau or a non-finite monitored metric (reference
    early_stopping.yaml: monitor val/loss, check_finite)."""

    def __init__(self, monitor: str = "val/loss", patience: int = 100,
                 mode: str = "min", min_delta: float = 0.0,
                 check_finite: bool = True):
        self.monitor = monitor
        self.patience = patience
        self.mode = mode
        self.min_delta = min_delta
        self.check_finite = check_finite
        self.best = math.inf if mode == "min" else -math.inf
        self.bad_epochs = 0
        self._stop = False

    @property
    def should_stop(self) -> bool:
        return self._stop

    def on_epoch_end(self, trainer, epoch: int,
                     metrics: Dict[str, float]) -> None:
        value = metrics.get(self.monitor)
        if value is None:
            return
        value = float(value)
        if self.check_finite and not math.isfinite(value):
            self._stop = True
            return
        improved = (value < self.best - self.min_delta if self.mode == "min"
                    else value > self.best + self.min_delta)
        if improved:
            self.best = value
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs >= self.patience:
                self._stop = True


class ProgressBar(Callback):
    """One progress line an epoch (the reference's RichProgressBar
    analogue): epoch counter, wall time, throughput and the losses. Rank 0
    prints it."""

    def __init__(self, refresh_rate: int = 1):
        self.refresh_rate = max(int(refresh_rate), 1)
        self._n = 0

    def on_epoch_end(self, trainer, epoch: int,
                     metrics: Dict[str, float]) -> None:
        self._n += 1
        if self._n % self.refresh_rate or _process_index() != 0:
            return
        total = getattr(trainer, "max_epochs", "?")
        parts = [f"epoch {epoch + 1}/{total}"]
        if "epoch_time_s" in metrics:
            parts.append(f"{metrics['epoch_time_s']:.1f}s")
        if "pairs_per_sec" in metrics:
            parts.append(f"{metrics['pairs_per_sec']:.1f} pairs/s")
        for key in ("train/loss", "val/loss"):
            if key in metrics:
                parts.append(f"{key}={metrics[key]:.4f}")
        print(" | ".join(parts), flush=True)


class ModelSummary(Callback):
    """Logs the model's parameter count at train start (reference
    RichModelSummary)."""

    def __init__(self, max_depth: int = -1):
        self.max_depth = max_depth

    def on_train_start(self, trainer) -> None:
        params = list(trainer.state.model.parameters())
        total = sum(p.numel() for p in params)
        trainable = sum(p.numel() for p in params if p.requires_grad)
        get_logger(__name__).info(
            f"model parameters: {total / 1e6:.1f}M ({len(params)} tensors, "
            f"{trainable / 1e6:.1f}M trainable)")
