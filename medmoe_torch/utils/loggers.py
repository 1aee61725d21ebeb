"""Metric logger backends (reference configs/logger/* analogue).

Only the CSV backend that ``configs/logger/csv.yaml`` names is here.
Every backend exposes ``log_metrics(metrics: dict, step: int)`` and
``log_hyperparams(cfg: dict)``. Only rank 0 writes.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Any, Dict, Optional

from medmoe_torch.utils.logging import _process_index


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
        # history is there, and opening 'w' without the re-read would
        # silently destroy it.
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
        self._file = open(path, "w", newline="")
        self._writer = csv.DictWriter(self._file, fieldnames=self._fields,
                                      restval="")
        self._writer.writeheader()
        for row in rows:
            self._writer.writerow(row)

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

