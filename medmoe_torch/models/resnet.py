"""ResNet backbone family with LoRA-capable convolutions (counterpart of
medmoe_tpu/models/resnet.py; reference src/models/components/resnet.py and
the CNN path of vision_encoder.py:85-104: bilinear resize to 299×299,
layer3's output as the local feature map, pooled layer4 as the global).

NCHW inside, float32 (``LoRAConv`` and flax's ``nn.Conv`` default to
float32 there). Every ``LoRAConv`` pads XLA's "SAME" from the size of its
input, as the JAX package's do. Normalization is 'group' (stateless,
``gcd(32, C)`` groups, eps 1e-6 as flax's) or 'batch' (flax's
``BatchNorm``: momentum 0.9, eps 1e-5, biased batch variance).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from medmoe_torch.models.lora import LoRAConv


class GroupNorm(nn.GroupNorm):
    """flax ``nn.GroupNorm`` over NCHW: ``gcd(32, channels)`` groups, so
    widths that 32 does not divide (DenseNet-161's growth-48 maps: 144,
    240, …) compose; epsilon 1e-6 (flax's default; torch's is 1e-5)."""

    def __init__(self, channels: int):
        super().__init__(math.gcd(32, int(channels)), channels, eps=1e-6)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW. In train
    mode it normalizes with the batch's mean and biased variance and moves
    the running statistics 10% of the way to them (torch's
    ``F.batch_norm`` would move them to the unbiased variance); in eval
    mode it reads the running statistics. The buffers are flax's
    ``batch_stats`` (``mean``, ``var`` → ``running_mean``,
    ``running_var``)."""

    def __init__(self, channels: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_(mean.detach(), alpha=1 - m)
            self.running_var.mul_(m).add_(var.detach(), alpha=1 - m)
        scale = self.weight * torch.rsqrt(var + self.eps)
        return (x - mean[:, None, None]) * scale[:, None, None] \
            + self.bias[:, None, None]


def make_norm(norm: str, channels: int) -> nn.Module:
    """The norm layer of ``medmoe_tpu.models.resnet._norm``: 'batch' or
    (anything else) 'group'."""
    return BatchNorm(channels) if norm == "batch" else GroupNorm(channels)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, features: int, strides: int = 1,
                 norm: str = "batch", lora_r: int = 0, lora_alpha: int = 16):
        super().__init__()
        s = (strides, strides)
        self.conv1 = LoRAConv(in_ch, features, (3, 3), s, r=lora_r,
                              alpha=lora_alpha, use_bias=False)
        self.bn1 = make_norm(norm, features)
        self.conv2 = LoRAConv(features, features, (3, 3), r=lora_r,
                              alpha=lora_alpha, use_bias=False)
        self.bn2 = make_norm(norm, features)
        # JAX adds the projection where the shapes differ: a stride or a
        # width change (a stride-2 "SAME" conv on a 1×1 map keeps its
        # shape, which no 299² input reaches)
        self.has_downsample = strides != 1 or in_ch != features
        if self.has_downsample:
            self.downsample_conv = LoRAConv(in_ch, features, (1, 1), s,
                                            use_bias=False)
            self.downsample_bn = make_norm(norm, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.has_downsample:
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(x + y)


class Bottleneck(nn.Module):
    """1×1 → 3×3 → 1×1 bottleneck (reference resnet.py:131-190). With
    ``groups > 1`` (ResNeXt) the 3×3 is a plain grouped conv with explicit
    (1, 1) padding and no LoRA; the 1×1 expansion and the projection never
    carry LoRA."""

    expansion = 4

    def __init__(self, in_ch: int, features: int, strides: int = 1,
                 norm: str = "batch", lora_r: int = 0, lora_alpha: int = 16,
                 groups: int = 1, base_width: int = 64):
        super().__init__()
        out_ch = features * self.expansion
        width = int(features * base_width / 64) * groups
        s = (strides, strides)
        self.conv1 = LoRAConv(in_ch, width, (1, 1), r=lora_r,
                              alpha=lora_alpha, use_bias=False)
        self.bn1 = make_norm(norm, width)
        if groups == 1:
            self.conv2 = LoRAConv(width, width, (3, 3), s, r=lora_r,
                                  alpha=lora_alpha, use_bias=False)
        else:
            self.conv2 = nn.Conv2d(width, width, 3, strides, padding=1,
                                   groups=groups, bias=False)
        self.bn2 = make_norm(norm, width)
        self.conv3 = LoRAConv(width, out_ch, (1, 1), use_bias=False)
        self.bn3 = make_norm(norm, out_ch)
        self.has_downsample = in_ch != out_ch or strides != 1
        if self.has_downsample:
            self.downsample_conv = LoRAConv(in_ch, out_ch, (1, 1), s,
                                            use_bias=False)
            self.downsample_bn = make_norm(norm, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.has_downsample:
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(x + y)


class ResNet(nn.Module):
    """torchvision's stage layout. NCHW in; returns (global [B, C4],
    local [B, C3, H/16, W/16]) where local is layer3's output (reference
    vision_encoder.py:96-100)."""

    def __init__(self, block: Any = Bottleneck,
                 layers: Sequence[int] = (3, 4, 6, 3), norm: str = "batch",
                 lora_r: int = 0, lora_alpha: int = 16):
        super().__init__()
        self.conv1 = LoRAConv(3, 64, (7, 7), (2, 2), r=lora_r,
                              alpha=lora_alpha, use_bias=False)
        self.bn1 = make_norm(norm, 64)
        expansion = getattr(block, "expansion", None) \
            or block.func.expansion
        self.names, in_ch, dims = [], 64, []
        for stage, n_blocks in enumerate(layers):
            features = 64 * (2 ** stage)
            for b in range(n_blocks):
                strides = 2 if (b == 0 and stage > 0) else 1
                name = f"layer{stage + 1}_block{b}"
                setattr(self, name, block(in_ch, features, strides, norm,
                                          lora_r, lora_alpha))
                self.names.append((stage, name))
                in_ch = features * expansion
            dims.append(in_ch)
        #: (global width, local width): layer4's and layer3's channels
        self.feature_dims: Tuple[int, int] = (dims[3], dims[2])

    def forward(self, x: torch.Tensor):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.max_pool2d(y, 3, 2, padding=1)
        feats = {}
        for stage, name in self.names:
            y = getattr(self, name)(y)
            feats[stage] = y
        return feats[3].mean(dim=(2, 3)), feats[2]


def ResNet18(**kw):
    return ResNet(block=BasicBlock, layers=(2, 2, 2, 2), **kw)


def ResNet34(**kw):
    return ResNet(block=BasicBlock, layers=(3, 4, 6, 3), **kw)


def ResNet50(**kw):
    return ResNet(block=Bottleneck, layers=(3, 4, 6, 3), **kw)


def ResNet101(**kw):
    return ResNet(block=Bottleneck, layers=(3, 4, 23, 3), **kw)


def ResNet152(**kw):
    return ResNet(block=Bottleneck, layers=(3, 8, 36, 3), **kw)


def ResNeXt50(**kw):
    """resnext50_32x4d (reference cnn_backbones.py:89-93)."""
    block = functools.partial(Bottleneck, groups=32, base_width=4)
    return ResNet(block=block, layers=(3, 4, 6, 3), **kw)


def ResNeXt101(**kw):
    """resnext101_32x8d (reference cnn_backbones.py:96-100)."""
    block = functools.partial(Bottleneck, groups=32, base_width=8)
    return ResNet(block=block, layers=(3, 4, 23, 3), **kw)


RESNETS = {"resnet_18": ResNet18, "resnet_34": ResNet34,
           "resnet_50": ResNet50, "resnet_101": ResNet101,
           "resnet_152": ResNet152, "resnext_50": ResNeXt50,
           "resnext_100": ResNeXt101}

#: the tower's input side (reference vision_encoder.py:89)
CNN_SIZE = 299


def resize_pixels(pixels: torch.Tensor, size: int = CNN_SIZE
                  ) -> torch.Tensor:
    """NHWC pixels (uint8 or float) → float32 NCHW at ``size``², as
    ``jax.image.resize(..., "bilinear")`` does it: half-pixel centres, and
    a triangle filter widened by the scale along an axis that shrinks
    (JAX antialiases a downsample; an upsample is plain bilinear). uint8
    becomes float32 unscaled, as JAX promotes it."""
    x = pixels.float().permute(0, 3, 1, 2)
    if tuple(x.shape[-2:]) == (size, size):
        return x.contiguous()
    shrinks = x.shape[-2] > size or x.shape[-1] > size
    return F.interpolate(x, size=(size, size), mode="bilinear",
                         align_corners=False, antialias=shrinks)


class ResNetVisionTower(nn.Module):
    """ResNet path of the ImageEncoder facade (reference
    vision_encoder.py:85-104): resize NHWC pixels to 299×299, run the
    backbone, return (global, local[layer3], None router probabilities).
    An unknown ``model_name`` builds ResNet-50, as JAX's
    ``{...}.get(name, ResNet50)`` does. The adapters take ``lora_r`` (and
    ``lora_alpha``) only with ``lora`` true; no CNN layer reads
    ``lora_dropout``."""

    def __init__(self, cfg: Any):
        super().__init__()
        name = cfg.get("model_name", "resnet_50")
        ctor = RESNETS.get(name, ResNet50)
        lora_r = int(cfg.get("lora_r", 8)) if cfg.get("lora", False) else 0
        self.model = ctor(norm=cfg.get("norm", "group"), lora_r=lora_r,
                          lora_alpha=int(cfg.get("lora_alpha", 16)))
        self.feature_dims = self.model.feature_dims

    def forward(self, pixels: torch.Tensor):
        global_feat, local_feat = self.model(resize_pixels(pixels))
        return global_feat, local_feat, None
