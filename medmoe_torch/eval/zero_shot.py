"""Zero-shot serving/eval path (counterpart of
medmoe_tpu/eval/zero_shot.py): encode one prompt per class ("this is a
photo of {label}", reference scripts/label_roco.py:26), encode images,
cosine similarity → class."""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from medmoe_torch.bridge import load_jax_params, load_npz
from medmoe_torch.models.medmoe import init_weights
from medmoe_torch.utils.checkpoint import (checkpoint_kind,
                                           load_model_weights)
from medmoe_torch.utils.instantiate import instantiate


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) and there is
    no card — it never falls back to the CPU on its own."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "medmoe_torch runs on CUDA, and no CUDA device is available; "
            "pass device='cpu' (CLI: device=cpu) to run on the CPU")
    return dev


def _normalize(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=1e-12)


@torch.inference_mode()
def encode_class_prompts(model: nn.Module, tokenizer, class_names: Sequence[str],
                         prompt_template: str = "this is a photo of {}",
                         max_length: int = 25) -> torch.Tensor:
    """[C, D] L2-normalized global text embeddings, one per class."""
    device = next(model.parameters()).device
    prompts = [prompt_template.format(name) for name in class_names]
    enc = tokenizer.encode_batch(prompts, max_length=max_length)
    ids, mask, types, segs = (
        torch.from_numpy(enc[k]).long().to(device)
        for k in ("input_ids", "attention_mask", "token_type_ids",
                  "segment_ids"))
    _, sent = model.encode_text(ids, mask, types, segs)
    return _normalize(sent)


def make_image_embedder(model: nn.Module
                        ) -> Callable[[Union[np.ndarray, torch.Tensor]],
                                      torch.Tensor]:
    """``encode_image`` + L2-norm — the single serving hot path
    (images [B, H, W, 3] float or uint8 → [B, D] unit-norm f32 embeddings
    on the model's device)."""
    device = next(model.parameters()).device

    @torch.inference_mode()
    def encode(images):
        x = torch.as_tensor(images).to(device, non_blocking=True)
        g, _, _ = model.encode_image(x)
        return _normalize(g)

    return encode


def default_class_names(cfg, datamodule) -> List[str]:
    """Precedence: explicit config > the dataset's own label space
    (CheXpert competition tasks / the UniMed modality classes) > bare
    indices."""
    return list(cfg.eval.get("class_names")
                or getattr(datamodule, "COMPETITION_TASKS", None)
                or getattr(datamodule, "CLASS_NAMES", None)
                or [str(i) for i in range(datamodule.num_classes)])


def load_weights(model: nn.Module, path: str) -> nn.Module:
    """Fill ``model`` from ``path``: a checkpoint the port's trainer wrote
    (its model ``state_dict``) or a ``weights.npz`` in the JAX exporter's
    layout (through the bridge). Both are zip archives; the archive's
    members decide, and anything else raises."""
    if checkpoint_kind(path) == "torch":
        load_model_weights(model, path)
    else:
        load_jax_params(model, load_npz(path))
    return model


def load_for_eval(cfg, device=None, datamodule=None, tokenizer=None):
    """(model, datamodule, tokenizer) for an eval/serving surface: build
    ``MedMoE`` from ``cfg.model.model``, fill it from a generator seeded
    with ``cfg.seed``, then load ``cfg.ckpt_path`` (``load_weights``: a
    port checkpoint or a JAX ``weights.npz``). ``device`` defaults to
    ``cfg.device``, and that to CUDA."""
    dev = resolve_device(device if device is not None else cfg.get("device"))
    datamodule = datamodule or instantiate(cfg.data)
    tokenizer = tokenizer or datamodule.tokenizer
    text = cfg.model.model.text
    text["vocab_size"] = max(int(text.get("vocab_size", 0)),
                             tokenizer.vocab_size)
    model = instantiate(cfg.model.model)
    init_weights(model, cfg.get("seed") or 0)
    if cfg.get("ckpt_path"):
        load_weights(model, cfg.ckpt_path)
    return model.to(dev).eval(), datamodule, tokenizer
