"""Online zero-shot serving CLI (counterpart of medmoe_tpu/cli/serve.py):
stream images through the deployed protocol (class prompts encoded once,
then encode_image + cosine argmax), emitting one JSON line per image.

  * images arrive as paths — one per line on stdin (``serve.input=-``), a
    file list, or a directory tree — and are decoded/resized on the host,
    on a prefetch thread that overlaps the device's work on the previous
    wave;
  * the device runs waves of ``serve.batch_size`` images (default 32);
  * ``serve.mode=classify`` emits {path, label, score, probs};
    ``serve.mode=embed`` emits {path, embedding} (the L2-normalized global
    image embedding);
  * JSONL goes to stdout, logs to stderr;
  * the model runs on ``device`` (default cuda; ``device=cpu`` asks for
    the CPU) and raises when CUDA is asked for and absent.

``serve_waves`` is the wave loop on already-decoded image arrays, so a
caller without an image decoder (chip_smoke.py) drives the same loop.

``ckpt_path`` takes a checkpoint the port's trainer wrote
(``<output_dir>/checkpoints/epoch_NNN`` or ``last``) or a ``weights.npz``
that ``python -m medmoe_tpu.cli.export`` wrote from a JAX run.

Usage:
  python -m medmoe_torch.cli.serve ckpt_path=<checkpoint or weights.npz> \\
      data=unimed serve.input=scans/ serve.mode=classify
  find scans -name '*.jpg' | python -m medmoe_torch.cli.serve \\
      ckpt_path=... serve.input=-
"""

from __future__ import annotations

import json
import logging
import os
import sys
from typing import Callable, Iterable, Iterator, List, Optional, Sequence, \
    TextIO, Tuple

import numpy as np

from medmoe_torch.utils.logging import get_logger

log = get_logger(__name__)

_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".gif", ".webp")

# one decoded wave: (paths kept, images [n, S, S, 3], (path, error) pairs)
Wave = Tuple[List[str], np.ndarray, List[Tuple[str, str]]]


def _iter_paths(spec: str) -> Iterator[str]:
    """Image paths from stdin ('-'), a directory tree, or a list file."""
    if spec == "-":
        for line in sys.stdin:
            line = line.strip()
            if line:
                yield line
        return
    if os.path.isdir(spec):
        for root, _, files in sorted(os.walk(spec)):
            for name in sorted(files):
                if name.lower().endswith(_IMAGE_EXTS):
                    yield os.path.join(root, name)
        return
    with open(spec) as f:
        for line in f:
            line = line.strip()
            if line:
                yield line


def _waves(paths: Iterator[str], size: int):
    wave: List[str] = []
    for p in paths:
        wave.append(p)
        if len(wave) == size:
            yield wave
            wave = []
    if wave:
        yield wave


def serve_waves(embed: Callable, waves: Iterable[Wave], mode: str,
                class_names: Sequence[str],
                class_emb: Optional[np.ndarray], temp3: float,
                out: TextIO) -> Tuple[int, int]:
    """Run decoded waves through ``embed`` (images → [n, D] unit-norm
    embeddings) and write one JSON line per image to ``out``. Classify
    mode scores against ``class_emb`` [C, D] with a softmax at the
    model's own similarity temperature ``temp3``. Returns (served, errors)."""
    from medmoe_torch.utils.trace import span

    n_ok = n_err = 0
    for kept, images, errors in waves:
        for path, msg in errors:
            n_err += 1
            out.write(json.dumps({"path": path, "error": msg}) + "\n")
        if not kept:
            continue
        emb = embed(images)
        with span("medmoe#serve.scores"):
            emb = emb.cpu().numpy()                          # [n, D]
            if mode == "embed":
                for path, e in zip(kept, emb):
                    out.write(json.dumps({"path": path,
                                          "embedding": e.tolist()}) + "\n")
            else:
                sims = emb @ class_emb.T                     # [n, C]
                z = sims * temp3
                ex = np.exp(z - z.max(axis=-1, keepdims=True))
                probs = ex / ex.sum(axis=-1, keepdims=True)
                for path, s, pr in zip(kept, sims, probs):
                    k = int(np.argmax(s))
                    out.write(json.dumps({
                        "path": path, "label": class_names[k],
                        "score": round(float(s[k]), 6),
                        "probs": {c: round(float(p), 6)
                                  for c, p in zip(class_names, pr)}}) + "\n")
            n_ok += len(kept)
            out.flush()
    return n_ok, n_err


def main(argv: Optional[List[str]] = None) -> int:
    from medmoe_torch.config import compose
    from medmoe_torch.data.prefetch import prefetch
    from medmoe_torch.data.transforms import ImageTransform, decode_image
    from medmoe_torch.eval.zero_shot import (default_class_names,
                                             encode_class_prompts,
                                             load_for_eval,
                                             make_image_embedder)
    from medmoe_torch.models.medmoe import check_tower_widths

    # the JSONL stream owns stdout: point stdout log handlers at stderr
    for h in logging.getLogger().handlers:
        if isinstance(h, logging.StreamHandler) and h.stream is sys.stdout:
            h.stream = sys.stderr

    overrides = list(argv if argv is not None else sys.argv[1:])
    from medmoe_torch.cli._help import maybe_print_help

    if maybe_print_help(
            overrides, "python -m medmoe_torch.cli.serve",
            "Online zero-shot serving: stream image paths -> JSONL.",
            ["find scans/ -name '*.jpg' | python -m medmoe_torch.cli.serve "
             "ckpt_path=... serve.input=-",
             "python -m medmoe_torch.cli.serve ckpt_path=... "
             "serve.input=scans/ serve.mode=embed"]):
        return 0
    cfg = compose("eval_zs", overrides)

    serve_cfg = cfg.get("serve") or {}
    spec = serve_cfg.get("input") or "-"
    wave_size = int(serve_cfg.get("batch_size", 32))
    mode = serve_cfg.get("mode", "classify")
    if mode not in ("classify", "embed"):
        # fail fast at config parse — not after model init
        raise SystemExit(f"serve.mode must be 'classify' or 'embed', "
                         f"got {mode!r}")

    model, datamodule, tokenizer = load_for_eval(cfg)
    if mode == "classify":
        check_tower_widths(model, "serve.mode=classify", local=False)
    image_size = int(cfg.model.model.vision.image_size)
    transform = ImageTransform(image_size, train=False)

    class_names = default_class_names(cfg, datamodule)
    class_emb = None
    if mode == "classify":
        class_emb = encode_class_prompts(
            model, tokenizer, class_names,
            cfg.eval.get("prompt_template", "this is a photo of {}"),
            int(cfg.model.model.text.max_length)).cpu().numpy()  # [C, D]

    def _decode_wave(wave) -> Wave:
        images, kept, errors = [], [], []
        for path in wave:
            try:
                with open(path, "rb") as f:
                    images.append(transform(decode_image(f.read())))
                kept.append(path)
            except Exception as exc:                     # nothrow per image
                errors.append((path, f"{type(exc).__name__}: {exc}"))
        batch = np.stack(images) if images else \
            np.zeros((0, image_size, image_size, 3), np.float32)
        return kept, batch, errors

    temp3 = float((cfg.model.get("loss") or {}).get("temp3", 10.0))
    n_ok, n_err = serve_waves(
        make_image_embedder(model),
        prefetch(_waves(_iter_paths(spec), wave_size), depth=2,
                 transform=_decode_wave),
        mode, class_names, class_emb, temp3, sys.stdout)
    log.info(f"served {n_ok} images ({n_err} errors)")
    return 0 if n_ok or not n_err else 1


if __name__ == "__main__":
    sys.exit(main())
