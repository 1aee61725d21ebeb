"""Vision tower facade (counterpart of medmoe_tpu/models/vision_encoder.py):
Swin-T + MoE, the MedMoE pretraining tower (reference
src/models/components/vision_encoder.py:59-61). The CNN backbones are not
ported yet."""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from medmoe_torch.models.layers import resolve_dtype
from medmoe_torch.models.moe import MoE, MoEConfig
from medmoe_torch.models.swin import SwinBackbone, SwinConfig


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
        if cfg.get("use_moe", True):
            self.moe = MoE(MoEConfig(
                num_experts=int(cfg.get("num_experts", 6)),
                hidden_dims=tuple(swin_cfg.stage_dims),
                output_dim=int(cfg.get("embed_dim", 768)),
                router_input_dim=swin_cfg.stage_dims[-1],
                mode=str(cfg.get("moe_mode", "gather")),
                top_k=int(cfg.get("router_top_k", 1)),
                dtype=dtype))

    def forward(self, pixels: torch.Tensor):
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
    vision_encoder.py:20-28)."""

    def __init__(self, cfg: Any):
        super().__init__()
        name = cfg.get("model_name", "swin")
        if "swin" not in name:
            raise NotImplementedError(
                f"vision backbone {name!r} is not ported yet; use 'swin'")
        self.swin_moe = SwinMoEVisionTower(cfg)

    def forward(self, pixels: torch.Tensor):
        return self.swin_moe(pixels)
