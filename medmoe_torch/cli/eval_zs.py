"""Zero-shot eval CLI of the PyTorch port (counterpart of
medmoe_tpu/cli/eval_zs.py; reference configs/eval_zs.yaml): zero-shot
classification, retrieval or linear probing (``eval.protocol``), printing
one JSON line of metrics.

    python -m medmoe_torch.cli.eval_zs data=chexpert ckpt_path=...
    python -m medmoe_torch.cli.eval_zs data=unimed eval.protocol=retrieval \\
        ckpt_path=...
    python -m medmoe_torch.cli.eval_zs data=chexpert \\
        medclip_ckpt=pytorch_model.bin device=cpu

The model runs on ``device`` (default cuda; ``device=cpu`` asks for the
CPU) and raises when CUDA is asked for and absent. ``ckpt_path`` takes a
checkpoint the port's trainer wrote or a JAX ``weights.npz``;
``medclip_ckpt`` a torch MedCLIP ``pytorch_model.bin``, converted into
both towers before ``ckpt_path`` is applied.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional

from medmoe_torch.config import compose
from medmoe_torch.eval.zero_shot import run_eval_zs
from medmoe_torch.utils.logging import get_logger
from medmoe_torch.utils.task import extras

log = get_logger(__name__)


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    overrides = list(argv if argv is not None else sys.argv[1:])
    from medmoe_torch.cli._help import maybe_print_help

    if maybe_print_help(
            overrides, "python -m medmoe_torch.cli.eval_zs",
            "Zero-shot classification / retrieval / linear probing.",
            ["python -m medmoe_torch.cli.eval_zs data=chexpert ckpt_path=...",
             "python -m medmoe_torch.cli.eval_zs data=unimed "
             "eval.protocol=retrieval ckpt_path=..."]):
        return {}
    cfg = compose("eval_zs", overrides)
    extras(cfg)
    metrics = run_eval_zs(cfg)
    log.info("eval_zs results: " + json.dumps(metrics, indent=2))
    print(json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    main()
