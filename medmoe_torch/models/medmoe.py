"""Top-level MedMoE model (counterpart of medmoe_tpu/models/medmoe.py,
reference src/models/components/med_moe.py).

Tokenization and image decoding live in the input pipeline; the model
takes device-ready tensors with the JAX package's layouts:
    image          [B, 224, 224, 3] float (normalized NHWC) or uint8
    input_ids / attention_mask / token_type_ids / segment_ids  [B, T=25]
and returns (img_emb_g [B,D], img_emb_l [B,D,H,W], text_emb_g [B,D],
text_emb_l [B,D,T], router_probs [B,K] or None).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from medmoe_torch.models.layers import Fp32LayerNorm, l2_normalize
from medmoe_torch.models.lora import (LoRAConv, LoRAEmbedding, LoRALinear,
                                      LoRAMergedLinear)
from medmoe_torch.models.moe import ExpertBank
from medmoe_torch.models.resnet import BatchNorm
from medmoe_torch.models.swin import WindowAttention
from medmoe_torch.models.text_encoder import BertTextEncoder
from medmoe_torch.models.vision_encoder import ImageEncoder
from medmoe_torch.utils.trace import span

# normalization stats mirrored from the host transforms
# (medmoe_torch/data/transforms.py NORM_STATS)
_DEVICE_NORM = {
    "imagenet": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    "half": ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
}


class MedMoE(nn.Module):
    def __init__(self, vision: Any, text: Any):
        super().__init__()
        self.vision = vision
        self.text = text
        self.image_encoder = ImageEncoder(vision)
        self.text_encoder = BertTextEncoder(text)

    def _maybe_normalize(self, images: torch.Tensor) -> torch.Tensor:
        """uint8 batches are normalized ON DEVICE (the host ships 4× fewer
        bytes); float batches are taken as host-normalized."""
        if images.dtype != torch.uint8:
            return images
        mean, std = _DEVICE_NORM[self.vision.get("norm_stats", "imagenet")]
        x = images.float() / 255.0
        mean = torch.tensor(mean, device=x.device)
        std = torch.tensor(std, device=x.device)
        return (x - mean) / std

    def encode_image(self, images: torch.Tensor):
        return self.image_encoder(self._maybe_normalize(images))

    def encode_text(self, input_ids, attention_mask, token_type_ids,
                    segment_ids):
        with span("medmoe#bert"):
            word, sent = self.text_encoder(input_ids, attention_mask,
                                           token_type_ids, segment_ids)
            if self.text.get("projection", False):
                # reference med_moe.py:87-90 (marked "not tested" there)
                return word, sent
            if self.text.get("norm", False):
                word = l2_normalize(word, dim=1)
                sent = l2_normalize(sent, dim=1)
            return word, sent

    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor, Optional[torch.Tensor]]:
        text_emb_l, text_emb_g = self.encode_text(
            batch["input_ids"], batch["attention_mask"],
            batch["token_type_ids"], batch["segment_ids"])
        img_emb_g, img_emb_l, router_probs = self.encode_image(batch["image"])
        return img_emb_g, img_emb_l, text_emb_g, text_emb_l, router_probs


def check_tower_widths(model: MedMoE, what: str, local: bool) -> None:
    """Raise ValueError before anything runs when ``what`` would compare a
    CNN tower's features with text features of another width: its global
    width (and, with ``local``, its local map's) against the text tower's.
    The JAX package fails there with a shape error inside the first product
    (2048- or 512-wide features against the 768-wide BERT: the local loss's
    einsum, the zero-shot and retrieval products). The Swin tower's width
    is the config's ``embed_dim`` and is not checked here."""
    if model.image_encoder.tower_name == "swin_moe":
        return
    g, l_dim = model.image_encoder.feature_dims
    text = model.text_encoder           # its words' and sentences' width
    t = int(text.cfg.get("embed_dim", 768)) \
        if text.cfg.get("projection", False) else text.bert.config.hidden_size
    if g == t and (l_dim == t or not local):
        return
    name = model.vision.get("model_name", "swin")
    local_part = f" and {l_dim}-wide local maps" if local else ""
    raise ValueError(
        f"{what} compares image and text features, but the {name!r} image "
        f"tower gives {g}-wide global features{local_part} against the text "
        f"tower's {t}: no projection joins them (a CNN backbone runs through "
        f"model=classification)")


# ---------------------------------------------------------------------------
# random initialization with the JAX package's (flax default) distributions
# ---------------------------------------------------------------------------

def _truncated_normal(shape, std: float, gen: torch.Generator) -> torch.Tensor:
    """Normal truncated to ±2 standard deviations, times ``std``."""
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, \
        (1 + math.erf(2 / math.sqrt(2))) / 2
    u = torch.rand(shape, generator=gen, dtype=torch.float64) * (hi - lo) + lo
    return (torch.erfinv(2 * u - 1) * math.sqrt(2) * std).float()


def _lecun_normal(shape, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    # flax lecun_normal: truncated normal rescaled to variance 1/fan_in
    return _truncated_normal(shape, math.sqrt(1.0 / fan_in) / .87962566103423978,
                             gen)


def _he_normal(shape, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    # flax he_normal: truncated normal rescaled to variance 2/fan_in
    return _truncated_normal(shape, math.sqrt(2.0 / fan_in)
                             / .87962566103423978, gen)


def _he_uniform(shape, gen: torch.Generator) -> torch.Tensor:
    # flax he_uniform of a 2-d factor: fan_in = shape[0]
    limit = math.sqrt(6.0 / shape[0])
    return (torch.rand(shape, generator=gen, dtype=torch.float64) * 2 - 1
            ).float() * limit


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fill every parameter from one seeded ``torch.Generator``, module by
    module in ``named_modules`` order, with the distributions of the JAX
    package's initializers: lecun-normal Dense/Conv kernels and expert
    bank (fan-in over all non-output axes, as flax computes it), zero
    biases, unit LayerNorm/GroupNorm/BatchNorm scales (and a BatchNorm's
    running statistics 0 and 1), normal(1/sqrt(features)) embeddings, a
    truncated-normal(0.02) relative-position-bias table; a ``LoRAConv``
    kernel he-normal, LoRA ``lora_a`` he-uniform (an embedding's zero) and
    ``lora_b`` zero (an embedding's normal(1))."""
    gen = torch.Generator().manual_seed(int(seed))
    for _, mod in model.named_modules():
        if isinstance(mod, nn.Linear):
            mod.weight.copy_(_lecun_normal(mod.weight.shape, mod.in_features,
                                           gen))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Conv2d):
            fan_in = mod.weight[0].numel()
            mod.weight.copy_(_lecun_normal(mod.weight.shape, fan_in, gen))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, LoRAConv):
            mod.weight.copy_(_he_normal(mod.weight.shape,
                                        mod.weight[0].numel(), gen))
            if mod.r > 0:
                mod.lora_a.copy_(_he_uniform(mod.lora_a.shape, gen))
                mod.lora_b.zero_()
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (LoRALinear, LoRAMergedLinear)):
            if getattr(mod, "lora_a", None) is not None:
                mod.lora_a.copy_(_he_uniform(mod.lora_a.shape, gen))
                mod.lora_b.zero_()
        elif isinstance(mod, LoRAEmbedding):
            if mod.r > 0:
                mod.lora_a.zero_()
                mod.lora_b.copy_(torch.randn(mod.lora_b.shape, generator=gen))
        elif isinstance(mod, (nn.GroupNorm, BatchNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, BatchNorm):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        elif isinstance(mod, nn.Embedding):
            std = 1.0 / math.sqrt(mod.embedding_dim)
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen)
                             * std)
        elif isinstance(mod, Fp32LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, WindowAttention):
            t = mod.relative_position_bias_table
            t.copy_(_truncated_normal(t.shape, 0.02, gen))
        elif isinstance(mod, ExpertBank):
            for name, p in mod.named_parameters(recurse=False):
                if "_w" in name:
                    # [K, in, out]: flax fan_in = in · K (receptive field K)
                    p.copy_(_lecun_normal(p.shape, p.shape[0] * p.shape[1],
                                          gen))
                else:
                    p.zero_()
    return model
