"""DenseNet backbone family (counterpart of medmoe_tpu/models/densenet.py;
reference src/models/components/cnn_backbones.py:63-81 exposes torchvision
densenet_121/161/169 with feature dims 1024/2208/1664).

The torchvision DenseNet-BC layout, NCHW, float32: 7×7/2 stem → 3×3/2
max pool → 4 dense blocks joined by 1×1-conv + 2×2 average-pool
transitions that halve the channels → final norm → global mean. Each dense
layer is norm-relu-conv1×1(bn_size·k) → norm-relu-conv3×3(k), concatenated
onto the running map. The convolutions pad explicitly (flax ``nn.Conv``
with ((p, p), (p, p))), and the group norm takes ``gcd(32, C)`` groups
(DenseNet-161's growth-48 maps land on 16).
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from medmoe_torch.models.resnet import make_norm, resize_pixels


class DenseLayer(nn.Module):
    def __init__(self, in_ch: int, growth_rate: int, bn_size: int = 4,
                 norm: str = "batch"):
        super().__init__()
        mid = bn_size * growth_rate
        self.norm1 = make_norm(norm, in_ch)
        self.conv1 = nn.Conv2d(in_ch, mid, 1, bias=False)
        self.norm2 = make_norm(norm, mid)
        self.conv2 = nn.Conv2d(mid, growth_rate, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(F.relu(self.norm1(x)))
        y = self.conv2(F.relu(self.norm2(y)))
        return torch.cat([x, y], dim=1)


class Transition(nn.Module):
    def __init__(self, in_ch: int, features: int, norm: str = "batch"):
        super().__init__()
        self.norm = make_norm(norm, in_ch)
        self.conv = nn.Conv2d(in_ch, features, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2, 2)


class DenseNet(nn.Module):
    """NCHW in; returns (global [B, C], local [B, C3, H/16, W/16]) with
    the ResNet family's contract: local = the stage-3 map (before its
    transition), global = the pooled final features."""

    def __init__(self, block_config: Sequence[int] = (6, 12, 24, 16),
                 growth_rate: int = 32, init_features: int = 64,
                 bn_size: int = 4, norm: str = "batch"):
        super().__init__()
        self.conv0 = nn.Conv2d(3, init_features, 7, 2, padding=3, bias=False)
        self.norm0 = make_norm(norm, init_features)
        self.stages = []
        ch = init_features
        local_ch = ch
        for i, n_layers in enumerate(block_config):
            names = []
            for j in range(n_layers):
                name = f"block{i + 1}_layer{j + 1}"
                setattr(self, name, DenseLayer(ch, growth_rate, bn_size,
                                               norm))
                names.append(name)
                ch += growth_rate
            if i == 2:
                local_ch = ch
            trans = None
            if i != len(block_config) - 1:
                trans = f"transition{i + 1}"
                setattr(self, trans, Transition(ch, ch // 2, norm))
                ch //= 2
            self.stages.append((names, trans))
        self.norm_final = make_norm(norm, ch)
        #: (global width, local width)
        self.feature_dims = (ch, local_ch)

    def forward(self, x: torch.Tensor):
        y = F.relu(self.norm0(self.conv0(x)))
        y = F.max_pool2d(y, 3, 2, padding=1)
        local = None
        for i, (names, trans) in enumerate(self.stages):
            for name in names:
                y = getattr(self, name)(y)
            if i == 2:
                local = y
            if trans is not None:
                y = getattr(self, trans)(y)
        y = F.relu(self.norm_final(y))
        return y.mean(dim=(2, 3)), local


def DenseNet121(**kw):
    return DenseNet(block_config=(6, 12, 24, 16), growth_rate=32,
                    init_features=64, **kw)


def DenseNet161(**kw):
    return DenseNet(block_config=(6, 12, 36, 24), growth_rate=48,
                    init_features=96, **kw)


def DenseNet169(**kw):
    return DenseNet(block_config=(6, 12, 32, 32), growth_rate=32,
                    init_features=64, **kw)


DENSENETS = {"densenet_121": DenseNet121, "densenet_161": DenseNet161,
             "densenet_169": DenseNet169}


class DenseNetVisionTower(nn.Module):
    """DenseNet path of the ImageEncoder facade (the CNN path of reference
    vision_encoder.py:85-104): resize to 299×299, run the backbone, return
    (global, local[stage 3], None). An unknown name builds DenseNet-121, as
    JAX's ``.get(name, DenseNet121)`` does."""

    def __init__(self, cfg: Any):
        super().__init__()
        name = cfg.get("model_name", "densenet_121")
        ctor = DENSENETS.get(name, DenseNet121)
        self.model = ctor(norm=cfg.get("norm", "group"))
        self.feature_dims = self.model.feature_dims

    def forward(self, pixels: torch.Tensor):
        global_feat, local_feat = self.model(resize_pixels(pixels))
        return global_feat, local_feat, None
