"""Classification heads (counterpart of medmoe_tpu/models/heads.py;
reference vision_encoder.py:140-174).

``PretrainedImageClassifier`` — frozen pretrained encoder + linear head
(the linear-probing model of paper Table 2); ``ImageClassifier`` — backbone
+ head trained end to end.
"""

from __future__ import annotations

import torch
from torch import nn


class LinearHead(nn.Module):
    """One float32 linear layer (flax ``nn.Dense`` with float32
    parameters): features [B, D] → logits [B, C]."""

    def __init__(self, in_features: int, num_classes: int):
        super().__init__()
        self.classifier = nn.Linear(in_features, num_classes)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return self.classifier(feats.float())


def _global_features(encoder: nn.Module, pixels: torch.Tensor
                     ) -> torch.Tensor:
    out = encoder(pixels)
    return out[0] if isinstance(out, tuple) else out


class PretrainedImageClassifier(nn.Module):
    """Frozen encoder → linear classifier (reference
    vision_encoder.py:140-158). The encoder's parameters take no gradient
    (so no optimizer holds them) and its output is detached, so the
    backbone never sees a gradient."""

    def __init__(self, encoder: nn.Module, in_features: int,
                 num_classes: int, freeze_encoder: bool = True):
        super().__init__()
        self.encoder = encoder
        self.freeze_encoder = freeze_encoder
        if freeze_encoder:
            self.encoder.requires_grad_(False)
        self.head = LinearHead(in_features, num_classes)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        feats = _global_features(self.encoder, pixels)
        if self.freeze_encoder:
            feats = feats.detach()
        return self.head(feats)


class ImageClassifier(nn.Module):
    """End-to-end trainable backbone + head (reference
    vision_encoder.py:161-174)."""

    def __init__(self, encoder: nn.Module, in_features: int,
                 num_classes: int):
        super().__init__()
        self.encoder = encoder
        self.head = LinearHead(in_features, num_classes)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.head(_global_features(self.encoder, pixels))
