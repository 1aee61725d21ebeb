"""Pretraining task module: the losses around the MedMoE model
(counterpart of medmoe_tpu/train/module.py; reference
src/models/medmoe_module.py:172-339).

    loss = local_w · (local.loss0 + local.loss1)
         + global_w · global_loss
         + classifier_w · CE(router_probs, modality_label)

Freezing (``freeze_bert`` / ``freeze_cnn``) sets ``requires_grad=False`` on
the tower: autograd then skips its backward, and the optimizer holds no
state for it. ``block_size`` computes the contrastive losses on blocks of
the batch and averages them — the per-rank losses of the reference's DDP
runs; ``global_negatives`` uses the whole batch instead.

The soft-label path (a frozen tool BERT scoring text similarity) is not
ported yet: ``soft_label: true`` raises.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from medmoe_torch.config import DotDict
from medmoe_torch.models.medmoe import MedMoE, init_weights
from medmoe_torch.models.moe import ExpertBank
from medmoe_torch.ops import expert_fusion, gloria_attention
from medmoe_torch.ops import losses as L
from medmoe_torch.train.optim import Adam, adam
from medmoe_torch.utils.instantiate import instantiate

_LOSS_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


class MedMoEPretrainingModule:
    def __init__(self, model: Any, loss: Any, optimizer: Any = None,
                 scheduler: Any = None):
        # `model` arrives instantiated (the config's nested `_target_`) or
        # as a config node with vision/text groups; `optimizer` and
        # `scheduler` arrive as partials
        self.loss_cfg = loss if isinstance(loss, DotDict) else DotDict(loss)
        self.optimizer_factory = optimizer
        self.scheduler_factory = scheduler
        if isinstance(model, MedMoE):
            self.model = model
        else:
            cfg = model if isinstance(model, DotDict) else DotDict(model)
            self.model = MedMoE(vision=cfg.vision if "vision" in cfg else cfg,
                                text=cfg.text)
        self.vision_cfg = self.model.vision
        self.text_cfg = self.model.text

        self.global_loss = instantiate(self.loss_cfg.get("global_loss")) \
            or L.GLORIAGlobalContrastiveLoss()
        self.local_loss = instantiate(self.loss_cfg.get("local_loss")) \
            or L.GLORIALocalContrastiveLoss()
        self.local_w = float(self.loss_cfg.get("local_loss_weight", 0.4))
        self.global_w = float(self.loss_cfg.get("global_loss_weight", 0.4))
        self.classifier_w = float(self.loss_cfg.get("classifier_loss_weight",
                                                    0.2))
        self.temp1 = float(self.loss_cfg.get("temp1", 4.0))
        self.temp2 = float(self.loss_cfg.get("temp2", 5.0))
        self.temp3 = float(self.loss_cfg.get("temp3", 10.0))
        self.agg = self.loss_cfg.get("agg", "sum")
        if bool(self.loss_cfg.get("soft_label", False)):
            raise NotImplementedError(
                "soft_label losses (the frozen tool-BERT targets) are not "
                "ported yet (ROADMAP.md Queue 1)")
        self.block_size = self.loss_cfg.get("block_size", None)
        if bool(self.loss_cfg.get("global_negatives", False)):
            self.block_size = None
        # local-loss inputs ride in the towers' compute dtype unless
        # loss.loss_dtype overrides it (null → float32)
        ldt = self.loss_cfg.get("loss_dtype",
                                self.vision_cfg.get("dtype", "bfloat16"))
        if isinstance(ldt, torch.dtype):
            ldt = str(ldt).replace("torch.", "")
        self.loss_dtype = _LOSS_DTYPES.get(ldt)
        self._freeze()

    # ------------------------------------------------------------------
    def init_params(self, seed: int) -> None:
        """Fill the model's parameters from ``seed`` (flax's initializer
        distributions; ``models.medmoe.init_weights``)."""
        init_weights(self.model, seed)

    def _freeze(self) -> None:
        if self.text_cfg.get("freeze_bert", False):
            self.model.text_encoder.bert.requires_grad_(False)
        if self.vision_cfg.get("freeze_cnn", False):
            self.model.image_encoder.requires_grad_(False)

    def check_kernel_limits(self, batch_size: Optional[int] = None) -> None:
        """Raise ValueError before the first step on a card when a kernel
        that the step would launch does not take the model's shapes: the
        expert branch's K1/K2 (bf16 expert banks) at the banks' widths, and
        the GLoRIA kernels, when the local loss would take its fused path
        at this batch size (None: any), at the local map's width, the text
        ``max_length`` and the loss's temp1."""
        for m in self.model.modules():
            if isinstance(m, ExpertBank) and m.config.dtype == torch.bfloat16:
                e = m.config.output_dim
                expert_fusion.check_kernel_limits(e, e // 2,
                                                  m.config.hidden_dims)
        if not isinstance(self.local_loss, L.GLORIALocalContrastiveLoss):
            return
        batch = batch_size
        if batch is not None and self.block_size:
            batch = min(batch, int(self.block_size))
        if self.local_loss.impl_for(self.agg, batch, True) == "pallas":
            tower = self.model.image_encoder.swin_moe
            d = tower.moe.config.output_dim if tower.moe is not None \
                else tower.swin.config.stage_dims[-1]
            gloria_attention.check_kernel_limits(
                d, int(self.text_cfg.get("max_length", 25)), self.temp1)

    def trainable_mask(self) -> Dict[str, bool]:
        """Parameter name → trainable (False on frozen towers)."""
        return {n: p.requires_grad for n, p in self.model.named_parameters()}

    def _blocked(self, fn, *tensors):
        """A loss over blocks of ``block_size`` rows, averaged (per-rank DDP
        loss semantics); the whole batch when unset or not smaller."""
        bs = self.block_size
        b = tensors[0].shape[0]
        if not bs or bs >= b:
            return fn(*tensors)
        nb = b // bs
        blocked = [t.reshape((nb, bs) + tuple(t.shape[1:])) for t in tensors]
        return torch.stack([fn(*[t[i] for t in blocked])
                            for i in range(nb)]).mean()

    # ------------------------------------------------------------------
    def loss_fn(self, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Forward + losses. Train or eval mode (dropout, drop-path) is the
        model's own ``training`` flag. Returns (loss, metrics), every metric
        a 0-d device tensor."""
        img_g, img_l, txt_g, txt_l, router_probs = self.model(batch)
        cap_lens = batch["cap_lens"]

        def local_fn(il, tl, cl):
            out = self.local_loss(il, tl, cl, temp1=self.temp1,
                                  temp2=self.temp2, temp3=self.temp3,
                                  agg=self.agg)
            return out.loss0 + out.loss1

        def global_fn(ig, tg):
            return self.global_loss(ig, tg, temp3=self.temp3)

        if self.loss_dtype is not None:
            img_l = img_l.to(self.loss_dtype)
            txt_l = txt_l.to(self.loss_dtype)
        l_loss = self._blocked(local_fn, img_l, txt_l, cap_lens)
        g_loss = self._blocked(global_fn, img_g, txt_g)

        if router_probs is not None and "label" in batch:
            c_loss = L.router_classification_loss(router_probs,
                                                   batch["label"])
            c_acc = L.router_accuracy(router_probs, batch["label"])
        else:
            c_loss = torch.zeros((), device=img_g.device)
            c_acc = torch.zeros((), device=img_g.device)

        loss = (self.local_w * l_loss + self.global_w * g_loss
                + self.classifier_w * c_loss)
        metrics = {"loss": loss, "l_loss": l_loss, "g_loss": g_loss,
                   "c_loss": c_loss, "c_acc": c_acc}
        return loss, {k: v.detach() for k, v in metrics.items()}

    # ------------------------------------------------------------------
    def make_optimizer(self, gradient_clip_val: Optional[float] = None
                       ) -> Adam:
        if self.optimizer_factory is None:
            return adam(gradient_clip_val=gradient_clip_val)
        return self.optimizer_factory(gradient_clip_val=gradient_clip_val)

    def make_scheduler(self):
        return self.scheduler_factory() if self.scheduler_factory else None
