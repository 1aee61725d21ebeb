"""Backbone factory (counterpart of medmoe_tpu/models/cnn_backbones.py;
reference src/models/components/cnn_backbones.py): name → a builder that
returns (module, feature_dim, interm_feature_dim)."""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

from medmoe_torch.models import densenet as _densenet
from medmoe_torch.models import resnet as _resnet


def _entry(ctor: Callable, feature_dim: int, interm: Optional[int]):
    def build(**kw) -> Tuple[Any, int, Optional[int]]:
        return ctor(**kw), feature_dim, interm

    return build


# (feature_dim, interm_feature_dim) per reference cnn_backbones.py:19-100
resnet_18 = _entry(_resnet.ResNet18, 512, 256)
resnet_34 = _entry(_resnet.ResNet34, 512, 256)
resnet_50 = _entry(_resnet.ResNet50, 2048, 1024)
resnet_101 = _entry(_resnet.ResNet101, 2048, 1024)
resnet_152 = _entry(_resnet.ResNet152, 2048, 1024)

# DenseNet (reference cnn_backbones.py:63-81): torchvision classifier
# in_features 1024/2208/1664, interm None
densenet_121 = _entry(_densenet.DenseNet121, 1024, None)
densenet_161 = _entry(_densenet.DenseNet161, 2208, None)
densenet_169 = _entry(_densenet.DenseNet169, 1664, None)

# ResNeXt (reference cnn_backbones.py:89-100): resnext50_32x4d /
# resnext101_32x8d, fc in_features 2048, interm None
resnext_50 = _entry(_resnet.ResNeXt50, 2048, None)
resnext_100 = _entry(_resnet.ResNeXt101, 2048, None)


def swin(**kw):
    """Swin returns dims (768, 768) (reference cnn_backbones.py:52-55);
    the tower itself is built by the vision facade."""
    from medmoe_torch.models.swin import SwinBackbone, SwinConfig

    return SwinBackbone(SwinConfig()), 768, 768


BACKBONES = {
    "resnet_18": resnet_18,
    "resnet_34": resnet_34,
    "resnet_50": resnet_50,
    "resnet_101": resnet_101,
    "resnet_152": resnet_152,
    "densenet_121": densenet_121,
    "densenet_161": densenet_161,
    "densenet_169": densenet_169,
    "resnext_50": resnext_50,
    "resnext_100": resnext_100,
    "swin": swin,
}
