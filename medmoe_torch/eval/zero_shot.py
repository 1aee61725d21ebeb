"""Zero-shot serving and evaluation (counterpart of
medmoe_tpu/eval/zero_shot.py): encode one prompt per class ("this is a
photo of {label}", reference scripts/label_roco.py:26), encode images,
cosine similarity → class (CheXpert-5x200-style accuracy, per-task AUROC
for multilabel targets), plus bidirectional image↔text retrieval R@K.

Every image goes through ``make_image_embedder``, the serving hot path, so
the deployed math cannot diverge between serving, eval and the probe.
Metrics are computed on the host in numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch
from torch import nn

from medmoe_torch.bridge import load_jax_params, load_npz
from medmoe_torch.models.medmoe import check_tower_widths, init_weights
from medmoe_torch.utils.checkpoint import (checkpoint_kind,
                                           load_model_weights)
from medmoe_torch.utils.instantiate import instantiate
from medmoe_torch.utils.trace import span


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


def encode_class_prompts(model: nn.Module, tokenizer, class_names: Sequence[str],
                         prompt_template: str = "this is a photo of {}",
                         max_length: int = 25) -> torch.Tensor:
    """[C, D] L2-normalized global text embeddings, one per class."""
    prompts = [prompt_template.format(name) for name in class_names]
    enc = tokenizer.encode_batch(prompts, max_length=max_length)
    return make_text_embedder(model)(
        enc["input_ids"], enc["attention_mask"], enc["token_type_ids"],
        enc["segment_ids"])


def make_image_embedder(model: nn.Module, normalize: bool = True
                        ) -> Callable[[Union[np.ndarray, torch.Tensor]],
                                      torch.Tensor]:
    """``encode_image`` + L2-norm — the single serving hot path
    (images [B, H, W, 3] float or uint8 → [B, D] unit-norm f32 embeddings
    on the model's device). ``normalize=False`` keeps the f32 global
    embedding as it is (the linear probe's features)."""
    device = next(model.parameters()).device

    @torch.inference_mode()
    def encode(images):
        with span("medmoe#serve.h2d"):
            x = torch.as_tensor(images).to(device, non_blocking=True)
        g, _, _ = model.encode_image(x)
        return _normalize(g) if normalize else g.float()

    return encode


def make_text_embedder(model: nn.Module) -> Callable[..., torch.Tensor]:
    """``encode_text`` + L2-norm: (input_ids, attention_mask,
    token_type_ids, segment_ids) [B, T] → [B, D] unit-norm f32 sentence
    embeddings on the model's device."""
    device = next(model.parameters()).device

    @torch.inference_mode()
    def encode(ids, mask, types, segs):
        _, sent = model.encode_text(*(torch.as_tensor(t).long().to(device)
                                      for t in (ids, mask, types, segs)))
        return _normalize(sent)

    return encode


def encode_images(model: nn.Module, batches: Iterable[Dict[str, np.ndarray]]
                  ) -> Iterator[Tuple[torch.Tensor, Optional[np.ndarray]]]:
    """Yields ([B, D] normalized global image embeddings on the model's
    device, labels [B, ...])."""
    encode = make_image_embedder(model)
    for batch in batches:
        yield encode(batch["image"]), batch.get("label")


def _average_ranks(x: np.ndarray) -> np.ndarray:
    """1-based ranks with ties assigned their average rank."""
    order = np.argsort(x, kind="mergesort")
    ranks = np.empty(len(x), np.float64)
    sx = x[order]
    i = 0
    while i < len(x):
        j = i
        while j + 1 < len(x) and sx[j + 1] == sx[i]:
            j += 1
        ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    return ranks


def binary_auroc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Rank-based (Mann-Whitney U) AUROC; NaN if one class is absent."""
    pos = np.asarray(labels) > 0.5
    n_pos = int(pos.sum())
    n_neg = int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    r = _average_ranks(np.asarray(scores, np.float64))
    u = r[pos].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def zero_shot_classification(model: nn.Module, tokenizer,
                             batches: Iterable[Dict[str, np.ndarray]],
                             class_names: Sequence[str],
                             prompt_template: str = "this is a photo of {}",
                             max_length: int = 25) -> Dict[str, float]:
    """Prompt-based classification (paper Table 1 protocol).

    Single-label targets → argmax accuracy. Multilabel targets (CheXpert's
    5 competition tasks) → per-task AUROC over the prompt-similarity
    scores plus their macro mean, and argmax-vs-argmax accuracy."""
    class_emb = encode_class_prompts(model, tokenizer, class_names,
                                     prompt_template, max_length)
    all_sims: List[np.ndarray] = []
    all_labels: List[np.ndarray] = []
    for img_emb, labels in encode_images(model, batches):
        all_sims.append((img_emb @ class_emb.T).cpu().numpy())   # [B, C]
        all_labels.append(np.asarray(labels))
    sims = np.concatenate(all_sims)
    labels = np.concatenate(all_labels)

    out: Dict[str, float] = {"zero_shot/n": float(len(sims))}
    if labels.ndim > 1 and labels.shape[1] == len(class_names):
        aucs = []
        for c, name in enumerate(class_names):
            auc = binary_auroc(sims[:, c], labels[:, c])
            out[f"zero_shot/auroc/{name}"] = auc
            if np.isfinite(auc):
                aucs.append(auc)
        out["zero_shot/auroc"] = float(np.mean(aucs)) if aucs \
            else float("nan")
        hard = labels.argmax(-1)
    else:
        hard = labels.argmax(-1) if labels.ndim > 1 else labels
    out["zero_shot/accuracy"] = float((sims.argmax(-1) == hard).mean()) \
        if len(sims) else 0.0
    return out


def image_text_retrieval(model: nn.Module,
                         batches: Iterable[Dict[str, np.ndarray]],
                         ks: Sequence[int] = (1, 5, 10)) -> Dict[str, float]:
    """Bidirectional retrieval R@K and median rank over paired batches
    (ROCO-style)."""
    encode_image = make_image_embedder(model)
    encode_text = make_text_embedder(model)
    img_all: List[np.ndarray] = []
    txt_all: List[np.ndarray] = []
    for batch in batches:
        img_all.append(encode_image(batch["image"]).cpu().numpy())
        txt_all.append(encode_text(
            batch["input_ids"], batch["attention_mask"],
            batch["token_type_ids"], batch["segment_ids"]).cpu().numpy())
    img = np.concatenate(img_all)
    txt = np.concatenate(txt_all)
    sims = img @ txt.T                                      # [N, N]
    n = sims.shape[0]
    out: Dict[str, float] = {}
    for name, s in (("i2t", sims), ("t2i", sims.T)):
        ranks = (-s).argsort(-1)
        position = (ranks == np.arange(n)[:, None]).argmax(-1)
        for k in ks:
            out[f"retrieval/{name}_r@{k}"] = float((position < k).mean())
        out[f"retrieval/{name}_median_rank"] = float(
            np.median(position) + 1)
    return out


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
    with ``cfg.seed``, convert ``cfg.medclip_ckpt`` (a torch MedCLIP
    ``pytorch_model.bin``) into both towers, then load ``cfg.ckpt_path``
    (``load_weights``: a port checkpoint or a JAX ``weights.npz``).
    ``device`` defaults to ``cfg.device``, and that to CUDA."""
    dev = resolve_device(device if device is not None else cfg.get("device"))
    datamodule = datamodule or instantiate(cfg.data)
    tokenizer = tokenizer or datamodule.tokenizer
    text = cfg.model.model.text
    text["vocab_size"] = max(int(text.get("vocab_size", 0)),
                             tokenizer.vocab_size)
    model = instantiate(cfg.model.model)
    init_weights(model, cfg.get("seed") or 0)
    if cfg.get("medclip_ckpt"):
        # torch MedCLIP weights → both towers (reference med_moe.py:40-62)
        from medmoe_torch.models.convert import load_medclip_checkpoint

        load_medclip_checkpoint(
            model, cfg.medclip_ckpt,
            depths=tuple(cfg.model.model.vision.get("swin_depths",
                                                    (2, 2, 6, 2))),
            num_layers=int(text.get("num_layers", 12)))
    if cfg.get("ckpt_path"):
        load_weights(model, cfg.ckpt_path)
    return model.to(dev).eval(), datamodule, tokenizer


def run_eval_zs(cfg) -> Dict[str, float]:
    """Config-driven harness (configs/eval_zs.yaml): ``eval.protocol`` is
    ``zero_shot``, ``retrieval`` or ``linear_probe``."""
    protocol = cfg.eval.get("protocol", "zero_shot")
    if protocol not in ("zero_shot", "retrieval", "linear_probe"):
        raise ValueError(f"unknown eval protocol {protocol!r}")
    model, datamodule, tokenizer = load_for_eval(cfg)
    if protocol != "linear_probe":      # the probe reads image features only
        check_tower_widths(model, f"eval.protocol={protocol}", local=False)
    if protocol == "zero_shot":
        return zero_shot_classification(
            model, tokenizer, datamodule.test_dataloader(),
            default_class_names(cfg, datamodule),
            cfg.eval.get("prompt_template", "this is a photo of {}"),
            int(cfg.model.model.text.max_length))
    if protocol == "retrieval":
        return image_text_retrieval(model, datamodule.test_dataloader(),
                                    tuple(cfg.eval.get("retrieval_ks",
                                                       (1, 5, 10))))
    from medmoe_torch.eval.linear_probe import linear_probe

    probe = cfg.eval.linear_probe
    return linear_probe(model, datamodule,
                        fractions=tuple(probe.fractions),
                        lr=float(probe.lr), epochs=int(probe.epochs))
