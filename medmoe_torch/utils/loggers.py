"""Metric logger backends (reference configs/logger/* analogue; the
counterpart of medmoe_tpu/utils/loggers.py): CSV, JSONL, TensorBoard,
Comet / MLflow / Neptune / Aim and Weights & Biases.

Every backend exposes ``log_metrics(metrics: dict, step: int)`` and
``log_hyperparams(cfg: dict)``. Only rank 0 writes. The third-party SDKs
are imported when a logger is built; a backend whose SDK is absent or
fails writes ``<backend>_fallback.jsonl`` in its ``save_dir`` instead, as
in JAX (these loggers run on the host and decide nothing the card does).
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Any, Dict, Optional

from medmoe_torch.utils.logging import _process_index, get_logger

log = get_logger(__name__)


def _is_main_process() -> bool:
    return _process_index() == 0


class BaseLogger:
    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        raise NotImplementedError

    def log_hyperparams(self, params: Dict[str, Any]) -> None:
        pass

    def log_checkpoint(self, path: str, alias: str = "last",
                       metadata: Optional[Dict[str, Any]] = None) -> None:
        """Checkpoint-artifact hook (reference wandb.yaml `log_model: True`
        uploads Lightning ckpts). No-op for file-based backends."""

    def finalize(self) -> None:
        pass


class CSVLogger(BaseLogger):
    def __init__(self, save_dir: str, name: str = "csv"):
        self.save_dir = os.path.join(save_dir, name)
        self._file = None
        self._writer = None
        self._fields: list[str] = []

    def _ensure(self, metrics: Dict[str, Any]) -> None:
        if not _is_main_process():
            return
        new_fields = sorted(set(self._fields) | set(metrics) | {"step", "time"})
        if self._file is not None and new_fields == self._fields:
            return
        # The file is rewritten with the widened header, so existing rows
        # must be re-read whenever metrics.csv EXISTS ON DISK — not only
        # while our own handle is open: after finalize() (fit → test logs
        # into the same file) or on a resumed run, _file is None but the
        # history is there. The widened file is written to metrics.csv.tmp
        # and moved over the original, so a crash mid-rewrite loses no row.
        path = os.path.join(self.save_dir, "metrics.csv")
        rows = []
        if self._file is not None:
            self._file.close()
            self._file = None
        if os.path.exists(path):
            with open(path) as f:
                reader = csv.DictReader(f)
                rows = list(reader)
                if reader.fieldnames:        # keep prior-run-only columns
                    new_fields = sorted(set(new_fields)
                                        | set(reader.fieldnames))
        os.makedirs(self.save_dir, exist_ok=True)
        self._fields = new_fields
        tmp = path + ".tmp"
        with open(tmp, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._fields, restval="")
            writer.writeheader()
            for row in rows:
                writer.writerow(row)
        os.replace(tmp, path)
        self._file = open(path, "a", newline="")
        self._writer = csv.DictWriter(self._file, fieldnames=self._fields,
                                      restval="")

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        if not _is_main_process():
            return
        row = {k: float(v) for k, v in metrics.items()}
        row["step"] = step
        row["time"] = time.time()
        self._ensure(row)
        self._writer.writerow(row)
        self._file.flush()

    def log_hyperparams(self, params: Dict[str, Any]) -> None:
        if not _is_main_process():
            return
        os.makedirs(self.save_dir, exist_ok=True)
        with open(os.path.join(self.save_dir, "hparams.json"), "w") as f:
            json.dump(params, f, indent=2, default=str)

    def finalize(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None



class JSONLLogger(BaseLogger):
    """One JSON object per line — trivially machine-readable run history."""

    def __init__(self, save_dir: str, name: str = "metrics.jsonl"):
        self.path = os.path.join(save_dir, name)

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        if not _is_main_process():
            return
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        record = {"step": step, "time": time.time()}
        record.update({k: float(v) for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")


class TensorBoardLogger(BaseLogger):
    """Scalars through ``torch.utils.tensorboard``; without the
    ``tensorboard`` package it logs a warning once and writes nothing, as
    the JAX logger does."""

    def __init__(self, save_dir: str, name: Optional[str] = None):
        self.save_dir = os.path.join(save_dir, name) if name else save_dir
        self._writer = None

    def _ensure(self):
        if self._writer is None:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._writer = SummaryWriter(self.save_dir)
            except Exception as e:
                log.warning(f"TensorBoardLogger writes nothing: {e!r}")
                self._writer = False
        return self._writer

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        if not _is_main_process():
            return
        writer = self._ensure()
        if not writer:
            return
        for k, v in metrics.items():
            writer.add_scalar(k, float(v), step)

    def finalize(self) -> None:
        if self._writer:
            self._writer.close()
            self._writer = None


class ExternalLogger(BaseLogger):
    """Generic third-party backend wrapper (comet / mlflow / neptune / aim —
    the reference's remaining logger configs). Each degrades to a JSONL file
    when its SDK is absent or raises."""

    def __init__(self, backend: str, save_dir: str, **kwargs):
        self.backend = backend
        self._fallback = JSONLLogger(save_dir, f"{backend}_fallback.jsonl")
        self._impl = None
        if not _is_main_process():
            return
        try:
            if backend == "mlflow":
                import mlflow

                mlflow.set_tracking_uri(kwargs.get("tracking_uri",
                                                   f"file:{save_dir}/mlruns"))
                mlflow.start_run(run_name=kwargs.get("run_name"))
                self._impl = mlflow
            elif backend == "comet":
                import comet_ml

                self._impl = comet_ml.Experiment(**kwargs)
            elif backend == "neptune":
                import neptune

                self._impl = neptune.init_run(**kwargs)
            elif backend == "aim":
                import aim

                self._impl = aim.Run(repo=save_dir)
        except Exception as e:
            log.warning(f"{backend} logger falls back to "
                        f"{self._fallback.path}: {e!r}")
            self._impl = None

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        if self._impl is None:
            self._fallback.log_metrics(metrics, step)
            return
        try:
            if self.backend == "mlflow":
                self._impl.log_metrics(
                    {k.replace("/", "_"): float(v)
                     for k, v in metrics.items()}, step=step)
            elif self.backend == "comet":
                self._impl.log_metrics(metrics, step=step)
            elif self.backend == "neptune":
                for k, v in metrics.items():
                    self._impl[k].append(float(v), step=step)
            elif self.backend == "aim":
                for k, v in metrics.items():
                    self._impl.track(float(v), name=k, step=step)
        except Exception:
            self._fallback.log_metrics(metrics, step)

    def log_hyperparams(self, params: Dict[str, Any]) -> None:
        if self._impl is None:
            return
        try:
            if self.backend == "mlflow":
                # mlflow params are strings with a length cap
                self._impl.log_params({k: str(v)[:500]
                                       for k, v in params.items()})
            elif self.backend == "comet":
                self._impl.log_parameters(dict(params))
            elif self.backend == "neptune":
                self._impl["parameters"] = dict(params)
            elif self.backend == "aim":
                self._impl["hparams"] = {k: str(v)
                                         for k, v in params.items()}
        except Exception as e:
            log.warning(f"{self.backend} logger dropped the hyperparameters: "
                        f"{e!r}")

    def finalize(self) -> None:
        """End the backend run: mlflow's run would otherwise stay active and
        the next in-process sweep trial's ``start_run`` raise."""
        if self._impl is None:
            return
        try:
            if self.backend == "mlflow":
                self._impl.end_run()
            elif self.backend == "comet":
                self._impl.end()
            elif self.backend == "neptune":
                self._impl.stop()
            elif self.backend == "aim":
                self._impl.close()
        except Exception as e:
            log.warning(f"{self.backend} logger did not close: {e!r}")
        self._impl = None


def CometLogger(save_dir: str, **kw):  # noqa: N802 — config-surface names
    return ExternalLogger("comet", save_dir, **kw)


def MLFlowLogger(save_dir: str, **kw):  # noqa: N802
    return ExternalLogger("mlflow", save_dir, **kw)


def NeptuneLogger(save_dir: str, **kw):  # noqa: N802
    return ExternalLogger("neptune", save_dir, **kw)


def AimLogger(save_dir: str, **kw):  # noqa: N802
    return ExternalLogger("aim", save_dir, **kw)


class WandbLogger(BaseLogger):
    """Weights & Biases backend (offline unless ``WANDB_MODE`` says
    otherwise); a JSONL file when wandb is absent or fails.

    The reference's key surface (configs/logger/wandb.yaml): ``offline``
    forces offline mode, ``id`` resumes a run, ``log_model`` uploads each
    checkpoint file ModelCheckpoint hands over (:meth:`log_checkpoint`) as a
    model artifact."""

    def __init__(self, save_dir: str, project: str = "medmoe_torch",
                 group: str = "", tags: Optional[list] = None,
                 name: Optional[str] = None, offline: bool = False,
                 id: Optional[str] = None, anonymous: Optional[str] = None,
                 log_model: bool = False, prefix: str = "",
                 entity: Optional[str] = None, job_type: str = ""):
        self._run = None
        self.log_model = bool(log_model)
        self.prefix = prefix or ""
        self._fallback = JSONLLogger(save_dir, "wandb_fallback.jsonl")
        if not _is_main_process():
            return
        try:
            import wandb

            mode = "offline" if offline \
                else os.environ.get("WANDB_MODE", "offline")
            self._run = wandb.init(
                project=project, group=group or None, tags=tags or [],
                name=name or None, dir=save_dir, mode=mode,
                id=id or None, resume="must" if id else None,
                anonymous=anonymous, entity=entity or None,
                job_type=job_type or None,
            )
        except Exception as e:
            log.warning(f"wandb logger falls back to {self._fallback.path}: "
                        f"{e!r}")
            self._run = None

    def _key(self, k: str) -> str:
        return f"{self.prefix}{k}" if self.prefix else k

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        if self._run is not None:
            self._run.log({self._key(k): float(v)
                           for k, v in metrics.items()}, step=step)
        else:
            self._fallback.log_metrics(metrics, step)

    def log_hyperparams(self, params: Dict[str, Any]) -> None:
        if self._run is not None:
            self._run.config.update(params, allow_val_change=True)

    def log_checkpoint(self, path: str, alias: str = "last",
                       metadata: Optional[Dict[str, Any]] = None) -> None:
        """Upload a checkpoint file as a ``model`` artifact (reference
        wandb.yaml ``log_model: True``); without a run, record the event in
        the fallback file."""
        if not self.log_model:
            return
        if self._run is None:
            if _is_main_process():
                record = {"event": "checkpoint", "path": path, "alias": alias}
                if metadata:
                    record.update({k: (float(v) if hasattr(v, "item") else v)
                                   for k, v in metadata.items()})
                os.makedirs(os.path.dirname(self._fallback.path),
                            exist_ok=True)
                with open(self._fallback.path, "a") as f:
                    f.write(json.dumps(record, default=str) + "\n")
            return
        try:
            import wandb

            artifact = wandb.Artifact(
                name=f"model-{self._run.id}", type="model",
                metadata=dict(metadata or {}))
            artifact.add_file(path)          # a checkpoint is one file
            self._run.log_artifact(artifact, aliases=[alias])
        except Exception as e:
            log.warning(f"wandb logger did not upload {path}: {e!r}")

    def finalize(self) -> None:
        if self._run is not None:
            self._run.finish()
            # later logs (fit() finalizes, then trainer.test() logs) go to
            # the fallback, not a finished run
            self._run = None
