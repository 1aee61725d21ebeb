"""Linear probing: frozen image encoder + a linear head trained on its
features (counterpart of medmoe_tpu/eval/linear_probe.py).

Reference analogue: PretrainedImageClassifier with a frozen encoder
(reference src/models/components/vision_encoder.py:140-158) — the paper's
Table 2 protocol at 1% / 10% / 100% training fractions.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from medmoe_torch.eval.zero_shot import make_image_embedder


def extract_features(model: nn.Module, batches: Iterable
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """The un-normalized f32 global image embeddings [N, D] (through the
    serving embedder) and the labels of ``batches``."""
    encode = make_image_embedder(model, normalize=False)
    feats, labels = [], []
    for batch in batches:
        feats.append(encode(batch["image"]).cpu().numpy())
        labels.append(np.asarray(batch["label"]))
    return np.concatenate(feats), np.concatenate(labels)


def _train_head(x: np.ndarray, y: np.ndarray, num_classes: int,
                lr: float = 1e-3, epochs: int = 50, multilabel: bool = False,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w [D, C], b [C]) from zeros by ``epochs`` full-batch Adam steps
    (the β and ε of ``optax.adam``) on the CE loss, or BCE for
    multilabel targets."""
    xt = torch.as_tensor(x, dtype=torch.float32, device=device)
    yt = torch.as_tensor(y, device=device)
    w = torch.zeros((x.shape[-1], num_classes), device=device,
                    requires_grad=True)
    b = torch.zeros((num_classes,), device=device, requires_grad=True)
    opt = torch.optim.Adam([w, b], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(epochs):
        logits = xt @ w + b
        if multilabel:
            loss = F.binary_cross_entropy_with_logits(logits, yt.float())
        else:
            loss = F.cross_entropy(logits, yt.long())
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return w.detach(), b.detach()


def linear_probe(model: nn.Module, datamodule,
                 fractions: Sequence[float] = (0.01, 0.1, 1.0),
                 lr: float = 1e-3, epochs: int = 50) -> Dict[str, float]:
    """Accuracy of a linear head on frozen global image features, at several
    training-data fractions (paper Table 2). The subsets come from
    ``np.random.RandomState(0).permutation``, as in the JAX package, so
    both pick the same rows. The head trains on the model's device."""
    device = next(model.parameters()).device
    test_x, test_y = extract_features(model, datamodule.test_dataloader())
    multilabel = test_y.ndim > 1
    num_classes = test_y.shape[-1] if multilabel else int(test_y.max()) + 1

    out: Dict[str, float] = {}
    full_x, full_y = extract_features(model,
                                      datamodule.train_dataloader(epoch=0))
    rng = np.random.RandomState(0)
    for frac in fractions:
        n = max(1, int(len(full_x) * frac))
        idx = rng.permutation(len(full_x))[:n]
        w, b = _train_head(full_x[idx], full_y[idx], num_classes, lr, epochs,
                           multilabel, device)
        logits = (torch.as_tensor(test_x, device=device) @ w + b).cpu().numpy()
        if multilabel:
            pred = (logits > 0).astype(np.float32)
            acc = float((pred == test_y).mean())
        else:
            acc = float((logits.argmax(-1) == test_y).mean())
        out[f"linear_probe/acc@{int(frac * 100)}%"] = acc
    return out
