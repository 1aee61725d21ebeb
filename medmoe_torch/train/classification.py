"""Supervised classification task module (counterpart of
medmoe_tpu/train/classification.py; reference MedMoELitModule,
src/models/medmoe_module.py:17-169 — the base-class role: classification
fine-tuning / linear probing with accuracy metrics, Adam + plateau LR).

Drives ``PretrainedImageClassifier`` / ``ImageClassifier``
(medmoe_torch/models/heads.py) through the same Trainer as pretraining:
multiclass CE on integer labels, multilabel BCE on vector labels (e.g.
CheXpert's 5 competition tasks). With ``freeze_encoder=false`` a step
fine-tunes the whole vision tower, so it launches the expert branch's K1
and K2.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from medmoe_torch.config import DotDict
from medmoe_torch.models.heads import (ImageClassifier,
                                       PretrainedImageClassifier)
from medmoe_torch.models.medmoe import init_weights
from medmoe_torch.models.moe import ExpertBank
from medmoe_torch.models.vision_encoder import ImageEncoder
from medmoe_torch.ops import expert_fusion
from medmoe_torch.train.optim import Adam, adam


class ClassificationModule:
    def __init__(self, model: Any = None, optimizer: Any = None,
                 scheduler: Any = None, num_classes: int = 6,
                 freeze_encoder: bool = True, multilabel: bool = False,
                 vision: Any = None, loss: Any = None):
        # `model` arrives as the instantiated MedMoE of the model group (its
        # vision tower is reused, its text tower dropped) or as a config
        # node; `vision` overrides its vision config. `loss` is the
        # pretraining experiments' contrastive-loss block, which a
        # classification run composed over them carries and does not use
        self.optimizer_factory = optimizer
        self.scheduler_factory = scheduler
        self.num_classes = int(num_classes)
        self.multilabel = bool(multilabel)
        self.freeze_encoder = bool(freeze_encoder)
        encoder = None
        if vision is None:
            vision = model.vision if hasattr(model, "vision") else model
            encoder = getattr(model, "image_encoder", None)
        self.vision_cfg = vision if isinstance(vision, DotDict) \
            else DotDict(vision or {})
        self.text_cfg = DotDict({})         # no text tower in this task
        if encoder is None:
            encoder = ImageEncoder(self.vision_cfg)
        tower = encoder.swin_moe
        width = tower.moe.config.output_dim if tower.moe is not None \
            else tower.swin.config.stage_dims[-1]
        if self.freeze_encoder:
            self.model = PretrainedImageClassifier(encoder, width,
                                                   self.num_classes)
        else:
            self.model = ImageClassifier(encoder, width, self.num_classes)

    def init_params(self, seed: int) -> None:
        """Fill the parameters from ``seed`` (flax's initializer
        distributions; ``models.medmoe.init_weights``)."""
        init_weights(self.model, seed)

    def check_kernel_limits(self, batch_size: Optional[int] = None) -> None:
        """Raise ValueError before the first step on a card when the
        expert branch's K1/K2 do not take the banks' widths."""
        for m in self.model.modules():
            if isinstance(m, ExpertBank) and m.config.dtype == torch.bfloat16:
                e = m.config.output_dim
                expert_fusion.check_kernel_limits(e, e // 2,
                                                  m.config.hidden_dims)

    def loss_fn(self, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Forward + loss; train or eval mode is the model's own flag."""
        logits = self.model(batch["image"])
        labels = batch["label"]
        if self.multilabel or labels.ndim > 1:
            loss = F.binary_cross_entropy_with_logits(logits, labels.float())
            acc = ((logits > 0) == (labels > 0.5)).float().mean()
        else:
            loss = F.cross_entropy(logits, labels.long())
            acc = (logits.argmax(-1) == labels).float().mean()
        zero = torch.zeros((), device=logits.device)
        metrics = {"loss": loss, "acc": acc, "l_loss": zero, "g_loss": zero,
                   "c_loss": loss, "c_acc": acc}
        return loss, {k: v.detach() for k, v in metrics.items()}

    def trainable_mask(self) -> Dict[str, bool]:
        """Parameter name → trainable (False on a frozen encoder: linear
        probing keeps Adam state only for the head)."""
        return {n: p.requires_grad for n, p in self.model.named_parameters()}

    def make_optimizer(self, gradient_clip_val: Optional[float] = None
                       ) -> Adam:
        if self.optimizer_factory is None:
            return adam(lr=1e-3, gradient_clip_val=gradient_clip_val)
        return self.optimizer_factory(gradient_clip_val=gradient_clip_val)

    def make_scheduler(self):
        return self.scheduler_factory() if self.scheduler_factory else None
