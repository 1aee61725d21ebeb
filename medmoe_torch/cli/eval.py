"""Supervised eval CLI of the PyTorch port (counterpart of
medmoe_tpu/cli/eval.py; reference configs/eval.yaml): load a checkpoint
and run the trainer's test loop, printing one JSON line of metrics.

    python -m medmoe_torch.cli.eval data=unimed ckpt_path=<checkpoint>
    python -m medmoe_torch.cli.eval data=unimed ckpt_path=... \\
        trainer.accelerator=cpu

The test loop runs on the CUDA card; ``trainer.accelerator=cpu`` asks for
the CPU.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional

from medmoe_torch.cli.train import _instantiate_group
from medmoe_torch.config import compose
from medmoe_torch.utils.instantiate import instantiate
from medmoe_torch.utils.logging import get_logger
from medmoe_torch.utils.task import extras, task_wrapper

log = get_logger(__name__)


@task_wrapper
def evaluate(cfg) -> Dict[str, float]:
    datamodule = instantiate(cfg.data)
    tokenizer = getattr(datamodule, "tokenizer", None)
    if tokenizer is not None:
        text = cfg.model.model.text
        text["vocab_size"] = max(int(text.get("vocab_size", 0)),
                                 tokenizer.vocab_size)
    module = instantiate(cfg.model)
    trainer = instantiate(cfg.trainer, loggers=_instantiate_group(
        cfg.get("logger")), seed=cfg.get("seed") or 0)
    metrics = trainer.test(module, datamodule, ckpt_path=cfg.get("ckpt_path"))
    log.info("eval results: " + json.dumps(metrics, indent=2))
    return metrics


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    overrides = list(argv if argv is not None else sys.argv[1:])
    if any(a in ("-h", "--help") for a in overrides):
        print(__doc__)
        return {}
    cfg = compose("eval", overrides)
    extras(cfg)
    metrics = evaluate(cfg)
    print(json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    main()
