"""Export CLI of the PyTorch port (counterpart of medmoe_tpu/cli/export.py):
write the deployed image and text encoders as ``torch.export`` programs
(medmoe_torch/eval/export.py), one per device, and print one JSON line.

    python -m medmoe_torch.cli.export ckpt_path=<checkpoint> export.dir=out/
    python -m medmoe_torch.cli.export ckpt_path=... export.batch=32 \\
        'export.platforms=[cuda]'
    python -m medmoe_torch.cli.export device=cpu export.dir=out/

The model loads on ``device`` (default cuda; ``device=cpu`` asks for the
CPU) and raises when CUDA is asked for and absent. ``export.platforms``
(null: ``device``) lists the devices to export for, each of which must be
present.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional

from medmoe_torch.config import compose
from medmoe_torch.utils.logging import get_logger
from medmoe_torch.utils.task import extras

log = get_logger(__name__)


def main(argv: Optional[List[str]] = None) -> Dict:
    overrides = list(argv if argv is not None else sys.argv[1:])
    if any(a in ("-h", "--help") for a in overrides):
        print(__doc__)
        return {}
    cfg = compose("eval_zs", overrides)
    extras(cfg)
    from medmoe_torch.eval.export import export_encoders
    from medmoe_torch.eval.zero_shot import load_for_eval
    from medmoe_torch.utils.instantiate import instantiate

    # an export host has a checkpoint, not an eval dataset: the datamodule
    # is built for its tokenizer's vocabulary only
    datamodule = instantiate(cfg.data)
    model, _, _ = load_for_eval(cfg, datamodule=datamodule)
    batch = cfg.export.get("batch")
    out_dir = str(cfg.export.dir)
    manifest = export_encoders(
        model, out_dir, platforms=cfg.export.get("platforms"),
        batch=int(batch) if batch is not None else None,
        bake_weights=bool(cfg.export.get("bake_weights", True)),
        check=bool(cfg.export.get("check", True)))
    sizes = {name: os.path.getsize(os.path.join(out_dir, name))
             for name in sorted(os.listdir(out_dir))}
    print(json.dumps({"export_dir": out_dir,
                      "embed_dim": manifest["embed_dim"],
                      "platforms": manifest["platforms"],
                      "bytes": sizes}))
    return manifest


if __name__ == "__main__":
    main()
