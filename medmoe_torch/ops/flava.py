"""FLAVA-style pretraining losses and heads (counterpart of
medmoe_tpu/ops/flava.py; reference src/losses.py:27-592, the vendored
torchmultimodal loss family): ITM, masked prediction (MLM/MIM) heads with
tied-bias decoders, and the CLIP-style global contrastive loss with a
learnable clamped temperature and cross-rank global negatives. The MedMoE
path uses the GLoRIA losses (ops/losses.py); nothing in the shipped
configs reaches these.

As in JAX, the masked-prediction losses take the cross entropy at every
position and mask it (no data-dependent gathers), the same numbers as the
reference's index-select + ``CrossEntropyLoss(ignore_index)``. The global
negatives go through ``parallel/collectives.gather_tensor`` over the data
group of the rank grid (``axis_name="data"``, where JAX gathers over
``axis_name``); outside a process group the gather is the identity.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from medmoe_torch.models.layers import Fp32LayerNorm, gelu_exact, safe_norm
from medmoe_torch.parallel import collectives as C


class ITMLossOutput(NamedTuple):
    logits: torch.Tensor
    loss: torch.Tensor


class MaskedPredictionLossOutput(NamedTuple):
    logits: torch.Tensor
    loss: torch.Tensor


class ContrastiveLossOutput(NamedTuple):
    loss: torch.Tensor
    logits_a: torch.Tensor
    logits_b: torch.Tensor
    loss_a: torch.Tensor
    loss_b: torch.Tensor


class FLAVAGlobalContrastiveLossOutput(NamedTuple):
    text_embedding: torch.Tensor
    image_embedding: torch.Tensor
    logit_scale: torch.Tensor
    image_logits: torch.Tensor
    text_logits: torch.Tensor
    image_loss: torch.Tensor
    text_loss: torch.Tensor
    loss: torch.Tensor


def _dense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """flax ``nn.Dense`` with float32 parameters and no compute dtype: the
    product runs in float32 (the input promoted)."""
    return layer(x.float())


class Pooler(nn.Module):
    """First-token pool + tanh (reference losses.py:92-104)."""

    def __init__(self, hidden_size: int = 768):
        super().__init__()
        self.dense = nn.Linear(hidden_size, hidden_size)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        return torch.tanh(_dense(hidden_states[:, 0], self.dense))


class TwoWayHead(nn.Module):
    """2-way ITM classifier (reference losses.py:106-114)."""

    def __init__(self, hidden_size: int = 768):
        super().__init__()
        self.seq_relationship = nn.Linear(hidden_size, 2)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        return _dense(pooled, self.seq_relationship)


def _masked_ce(logits: torch.Tensor, labels: torch.Tensor,
               ignore_index: int = -1) -> torch.Tensor:
    """CrossEntropyLoss(ignore_index) as the JAX package computes it: the
    float32 NLL at every position, summed over the valid ones and divided
    by their count (at least 1)."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logprobs = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logprobs, -1, safe.unsqueeze(-1)).squeeze(-1)
    n = valid.sum()
    return torch.where(valid, nll, torch.zeros_like(nll)).sum() \
        / torch.clamp(n, min=1)


class ITMLoss(nn.Module):
    """Image-text-matching cross entropy (reference losses.py:117-147)."""

    def __init__(self, hidden_size: int = 768, ignore_index: int = -1):
        super().__init__()
        self.ignore_index = ignore_index
        self.pooler = Pooler(hidden_size)
        self.cls = TwoWayHead(hidden_size)

    def forward(self, hidden_states: torch.Tensor,
                labels: Optional[torch.Tensor]) -> ITMLossOutput:
        pooled = self.pooler(hidden_states)
        scores = self.cls(pooled)
        if labels is None:
            loss = pooled.sum() * 0.0
        else:
            loss = _masked_ce(scores, labels, self.ignore_index)
        return ITMLossOutput(logits=scores, loss=loss)


class MaskedPredictionHead(nn.Module):
    """Dense → GELU → LayerNorm → vocabulary decoder + its own bias
    (reference losses.py:150-186)."""

    def __init__(self, hidden_size: int = 768, vocab_size: int = 30522,
                 layer_norm_eps: float = 1e-5):
        super().__init__()
        self.dense = nn.Linear(hidden_size, hidden_size)
        self.layer_norm = Fp32LayerNorm(hidden_size, eps=layer_norm_eps)
        self.decoder = nn.Linear(hidden_size, vocab_size, bias=False)
        self.bias = nn.Parameter(torch.zeros(vocab_size))

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        x = gelu_exact(_dense(hidden_states, self.dense))
        x = self.layer_norm(x)
        return self.decoder(x) + self.bias


class MaskedPredictionLoss(nn.Module):
    """MLM/MIM cross entropy over the masked positions (reference
    losses.py:189-245); ``ignore_nan`` turns the all-ignored NaN into 0
    like the reference."""

    def __init__(self, hidden_size: int = 768, vocab_size: int = 30522,
                 ignore_index: int = -1, ignore_nan: bool = False):
        super().__init__()
        self.ignore_index, self.ignore_nan = ignore_index, ignore_nan
        self.cls = MaskedPredictionHead(hidden_size, vocab_size)

    def forward(self, hidden_states: torch.Tensor,
                masked_labels: Optional[torch.Tensor]
                ) -> MaskedPredictionLossOutput:
        prediction = self.cls(hidden_states)
        if masked_labels is None:
            loss = prediction.sum() * 0.0
        else:
            loss = _masked_ce(prediction, masked_labels, self.ignore_index)
            if self.ignore_nan:
                loss = torch.nan_to_num(loss)
        return MaskedPredictionLossOutput(logits=prediction, loss=loss)


def _data_group(axis_name: Optional[str]):
    """(gathers, the process group) for JAX's ``axis_name``: None gathers
    nothing; "data" is the rank grid's data group."""
    if axis_name is None:
        return False, None
    if axis_name != "data":
        raise ValueError(f"axis_name={axis_name!r}: the port gathers global "
                         f"negatives over the 'data' group only")
    from medmoe_torch.parallel.mesh import get_grid

    return True, get_grid().data_group


def contrastive_loss_with_temperature(
        embeddings_a: torch.Tensor, embeddings_b: torch.Tensor,
        logit_scale: torch.Tensor, mask: Optional[torch.Tensor] = None,
        backprop_type: C.BackpropType = C.BackpropType.GLOBAL,
        axis_name: Optional[str] = None) -> ContrastiveLossOutput:
    """CLIP InfoNCE with a learnable temperature and global negatives
    (reference losses.py:527-592 + _gather_embeddings_and_labels
    :503-524): this rank's rows against every rank's, the labels offset by
    the rank's place in the data group."""
    temp = torch.exp(logit_scale)
    local_b = embeddings_a.shape[0]
    gathers, group = _data_group(axis_name)
    all_a, all_b, offset = embeddings_a, embeddings_b, 0
    if gathers and C.in_group():
        import torch.distributed as dist

        all_a = C.gather_tensor(embeddings_a, backprop_type, group)
        all_b = C.gather_tensor(embeddings_b, backprop_type, group)
        offset = dist.get_rank(group) * local_b
    labels = offset + torch.arange(local_b, device=embeddings_a.device)

    logits_a = (embeddings_a @ all_b.T).float() * temp
    logits_b = (embeddings_b @ all_a.T).float() * temp
    if mask is not None:
        logits_a = torch.where(mask, logits_a,
                               torch.full_like(logits_a, -math.inf))
        logits_b = torch.where(mask, logits_b,
                               torch.full_like(logits_b, -math.inf))
    lp_a = F.log_softmax(logits_a, dim=-1)
    lp_b = F.log_softmax(logits_b, dim=-1)
    pick = labels[:, None]
    loss_a = -torch.gather(lp_a, 1, pick).mean()
    loss_b = -torch.gather(lp_b, 1, pick).mean()
    return ContrastiveLossOutput(loss=(loss_a + loss_b) / 2.0,
                                 logits_a=logits_a, logits_b=logits_b,
                                 loss_a=loss_a, loss_b=loss_b)


class FLAVAGlobalContrastiveLoss(nn.Module):
    """L2-normalize, clip the learnable ``logit_scale`` to [0, ln 100],
    InfoNCE (reference losses.py:248-301)."""

    def __init__(self, axis_name: Optional[str] = None):
        super().__init__()
        self.axis_name = axis_name
        self.logit_scale = nn.Parameter(
            torch.tensor(math.log(1.0 / 0.07), dtype=torch.float32))

    def forward(self, image_sequence: torch.Tensor,
                text_sequence: torch.Tensor,
                mask: Optional[torch.Tensor] = None
                ) -> FLAVAGlobalContrastiveLossOutput:
        logit_scale = torch.clamp(self.logit_scale, 0.0, 4.6052)
        txt = text_sequence / safe_norm(text_sequence)
        img = image_sequence / safe_norm(image_sequence)
        out = contrastive_loss_with_temperature(
            img, txt, logit_scale, mask, C.BackpropType.GLOBAL,
            self.axis_name)
        return FLAVAGlobalContrastiveLossOutput(
            text_embedding=txt, image_embedding=img, logit_scale=logit_scale,
            image_logits=out.logits_a, text_logits=out.logits_b,
            image_loss=out.loss_a, text_loss=out.loss_b, loss=out.loss)


class FLAVAPretrainingLoss(nn.Module):
    """MLM + MIM + ITM + global contrastive (reference losses.py:304-492):
    the weighted sum of whichever terms' inputs are given. The MMM weights
    are accepted and, as in the JAX package, no MMM term is computed."""

    def __init__(self, hidden_size: int = 768, text_vocab_size: int = 30522,
                 image_vocab_size: int = 8192, ignore_index: int = -1,
                 mlm_weight: float = 1.0, mim_weight: float = 1.0,
                 contrastive_loss_weight: float = 1.0,
                 mmm_image_loss_weight: float = 1.0,
                 mmm_text_loss_weight: float = 1.0,
                 itm_loss_weight: float = 1.0,
                 axis_name: Optional[str] = None):
        super().__init__()
        self.mlm_weight, self.mim_weight = mlm_weight, mim_weight
        self.contrastive_loss_weight = contrastive_loss_weight
        self.mmm_image_loss_weight = mmm_image_loss_weight
        self.mmm_text_loss_weight = mmm_text_loss_weight
        self.itm_loss_weight = itm_loss_weight
        self.mlm_loss = MaskedPredictionLoss(hidden_size, text_vocab_size,
                                             ignore_index)
        self.mim_loss = MaskedPredictionLoss(hidden_size, image_vocab_size,
                                             ignore_index)
        self.itm_loss = ITMLoss(hidden_size, ignore_index)
        self.contrastive_loss = FLAVAGlobalContrastiveLoss(axis_name)

    def forward(self,
                image_sequence: Optional[torch.Tensor] = None,
                text_sequence: Optional[torch.Tensor] = None,
                image_masked_sequence: Optional[torch.Tensor] = None,
                text_masked_sequence: Optional[torch.Tensor] = None,
                multimodal_masked_sequence: Optional[torch.Tensor] = None,
                itm_labels: Optional[torch.Tensor] = None,
                mlm_labels: Optional[torch.Tensor] = None,
                mim_labels: Optional[torch.Tensor] = None
                ) -> Dict[str, Any]:
        losses: Dict[str, Any] = {}
        dev = next(self.parameters()).device
        total = torch.zeros((), dtype=torch.float32, device=dev)
        if text_masked_sequence is not None and mlm_labels is not None:
            out = self.mlm_loss(text_masked_sequence, mlm_labels)
            losses["mlm_loss"] = out.loss
            total = total + self.mlm_weight * out.loss
        if image_masked_sequence is not None and mim_labels is not None:
            out = self.mim_loss(image_masked_sequence, mim_labels)
            losses["mim_loss"] = out.loss
            total = total + self.mim_weight * out.loss
        if multimodal_masked_sequence is not None and itm_labels is not None:
            out = self.itm_loss(multimodal_masked_sequence, itm_labels)
            losses["itm_loss"] = out.loss
            total = total + self.itm_loss_weight * out.loss
        if image_sequence is not None and text_sequence is not None:
            out = self.contrastive_loss(image_sequence, text_sequence)
            losses["global_contrastive_loss"] = out.loss
            total = total + self.contrastive_loss_weight * out.loss
        losses["loss"] = total
        return losses
