"""Train CLI of the PyTorch port (counterpart of medmoe_tpu/cli/train.py;
reference ``python src/train.py experiment=...``). Overrides are
hydra-style ``key=value`` arguments.

    python -m medmoe_torch.cli.train experiment=pretraining_medmoe_ddp \\
        data=synthetic
    python -m medmoe_torch.cli.train experiment=pretraining_medmoe_ddp \\
        data=synthetic debug=fdr trainer.accelerator=cpu
    python -m medmoe_torch.cli.train experiment=pretraining_medmoe_ddp \\
        ckpt_path=logs/train/runs/checkpoints/last      # resume

Training runs on the CUDA card; ``trainer.accelerator=cpu`` asks for the
CPU. ``--multirun`` and ``hparams_search`` are not ported yet.
"""

from __future__ import annotations

import random
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from medmoe_torch.config import compose, to_dict
from medmoe_torch.utils.instantiate import instantiate
from medmoe_torch.utils.logging import get_logger
from medmoe_torch.utils.task import extras, get_metric_value, task_wrapper

log = get_logger(__name__)


def seed_everything(seed: Optional[int]) -> None:
    if seed is None:
        return
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def _instantiate_group(node) -> List:
    """A config group of named ``_target_`` entries (callbacks, logger) →
    the objects, in order."""
    if not node:
        return []
    return [instantiate(v) for v in node.values()
            if isinstance(v, dict) and "_target_" in v]


@task_wrapper
def train(cfg) -> Tuple[Dict[str, float], Dict]:
    """Instantiate everything from the config, fit (resuming from
    ``ckpt_path`` when set), optionally test with the best checkpoint
    (reference src/train.py:42-108)."""
    seed_everything(cfg.get("seed"))

    log.info(f"instantiating datamodule <{cfg.data._target_}>")
    datamodule = instantiate(cfg.data)
    # the embedding table must cover the tokenizer's vocabulary (a corpus-
    # built vocab can exceed the configured size); the model is built with
    # its final shape, so this is settled before the module exists
    tokenizer = getattr(datamodule, "tokenizer", None)
    if tokenizer is not None:
        text = cfg.model.model.text
        text["vocab_size"] = max(int(text.get("vocab_size", 0)),
                                 tokenizer.vocab_size)

    log.info(f"instantiating module <{cfg.model._target_}>")
    module = instantiate(cfg.model)
    callbacks = _instantiate_group(cfg.get("callbacks"))
    loggers = _instantiate_group(cfg.get("logger"))

    log.info("instantiating trainer")
    trainer = instantiate(cfg.trainer, callbacks=callbacks, loggers=loggers,
                          seed=cfg.get("seed") or 0)
    for logger in loggers:
        logger.log_hyperparams(to_dict(cfg))

    metrics: Dict[str, float] = {}
    if cfg.get("train", True):
        trainer.fit(module, datamodule, ckpt_path=cfg.get("ckpt_path"))
        if trainer.metrics_history:
            metrics.update(trainer.metrics_history[-1])
    if cfg.get("test", False):
        ckpt = trainer.best_model_path
        if not ckpt:
            log.warning("best ckpt not found — testing with current weights")
        metrics.update(trainer.test(module, datamodule, ckpt_path=ckpt))
    return metrics, {"trainer": trainer, "module": module,
                     "datamodule": datamodule}


def _run_one(overrides: List[str]) -> Dict[str, float]:
    cfg = compose("train", overrides)
    if cfg.get("hparams_search"):
        raise NotImplementedError("hparams_search sweeps are not ported yet")
    extras(cfg)
    metrics, _ = train(cfg)
    metric_name = cfg.get("optimized_metric")
    if metric_name:
        get_metric_value(metrics, metric_name)
    return metrics


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    overrides = list(argv if argv is not None else sys.argv[1:])
    if any(a in ("-h", "--help") for a in overrides):
        print(__doc__)
        return {}
    if any(a in ("-m", "--multirun") for a in overrides):
        raise NotImplementedError("--multirun is not ported yet")
    return _run_one(overrides)


if __name__ == "__main__":
    main()
