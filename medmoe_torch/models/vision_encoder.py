"""Vision tower facade (counterpart of medmoe_tpu/models/vision_encoder.py):
Swin-T + MoE, the MedMoE pretraining tower (reference
src/models/components/vision_encoder.py:59-61), and the CNN backbones
(ResNet, ResNeXt, DenseNet; reference vision_encoder.py:85-104). Every
tower returns (global [B, D], local [B, D_l, H, W], router probabilities
or None)."""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from medmoe_torch.models.layers import resolve_dtype
from medmoe_torch.models.moe import MoE, MoEConfig
from medmoe_torch.models.swin import SwinBackbone, SwinConfig
from medmoe_torch.utils.trace import span


class SwinMoEVisionTower(nn.Module):
    """SwinBackbone → (pyramid, final) → MoE fusion.

    Mirrors reference SWIN.forward (swin.py:130-149): the router feature is
    the mean-pooled final hidden state; pyramid = hidden_states[0..3].
    With ``use_moe=False``: global = mean(final), local = final reshaped to
    a [B, D, 7, 7] grid, router probabilities None.
    """

    def __init__(self, cfg: Any):
        super().__init__()
        dtype = resolve_dtype(cfg.get("dtype", "bfloat16"))
        swin_cfg = SwinConfig(
            image_size=int(cfg.get("image_size", 224)),
            embed_dim=int(cfg.get("swin_embed_dim", 96)),
            depths=tuple(cfg.get("swin_depths", (2, 2, 6, 2))),
            num_heads=tuple(cfg.get("swin_num_heads", (3, 6, 12, 24))),
            window_size=int(cfg.get("swin_window_size", 7)),
            drop_path_rate=float(cfg.get("drop_path_rate", 0.1)),
            dtype=dtype)
        self.swin = SwinBackbone(swin_cfg)
        self.moe = None
        width = swin_cfg.stage_dims[-1]
        if cfg.get("use_moe", True):
            self.moe = MoE(MoEConfig(
                num_experts=int(cfg.get("num_experts", 6)),
                hidden_dims=tuple(swin_cfg.stage_dims),
                output_dim=int(cfg.get("embed_dim", 768)),
                router_input_dim=swin_cfg.stage_dims[-1],
                mode=str(cfg.get("moe_mode", "gather")),
                top_k=int(cfg.get("router_top_k", 1)),
                capacity_factor=float(cfg.get("capacity_factor", 1.25)),
                dtype=dtype))
            width = self.moe.config.output_dim
        #: (global width, local width)
        self.feature_dims = (width, width)

    def forward(self, pixels: torch.Tensor):
        with span("medmoe#swin"):
            pyramid, final = self.swin(pixels)
        router_feat = final.mean(dim=1)                      # [B, 768]
        if self.moe is not None:
            return self.moe(pyramid, router_feat)
        b, p, d = final.shape
        hw = int(round(p ** 0.5))
        local_feat = final.permute(0, 2, 1).reshape(b, d, hw, hw)
        return router_feat, local_feat, None


class ImageEncoder(nn.Module):
    """Backbone dispatch by ``cfg.model_name`` (reference
    vision_encoder.py:20-28, cnn_backbones.py): a name holding "swin"
    builds ``swin_moe``; "resnet" or "resnext" ``resnet``; "densenet"
    ``densenet`` (the JAX package's module names)."""

    def __init__(self, cfg: Any):
        super().__init__()
        name = cfg.get("model_name", "swin")
        if "swin" in name:
            self.swin_moe = SwinMoEVisionTower(cfg)
            self.tower_name = "swin_moe"
        elif "resnet" in name or "resnext" in name:
            from medmoe_torch.models.resnet import ResNetVisionTower

            self.resnet = ResNetVisionTower(cfg)
            self.tower_name = "resnet"
        elif "densenet" in name:
            from medmoe_torch.models.densenet import DenseNetVisionTower

            self.densenet = DenseNetVisionTower(cfg)
            self.tower_name = "densenet"
        else:
            raise ValueError(f"unknown vision backbone {name!r}")

    @property
    def tower(self) -> nn.Module:
        return getattr(self, self.tower_name)

    @property
    def feature_dims(self):
        """(global width, local width) of the tower's features."""
        return self.tower.feature_dims

    def forward(self, pixels: torch.Tensor):
        return self.tower(pixels)
