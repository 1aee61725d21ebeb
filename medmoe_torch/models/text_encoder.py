"""Text tower: BERT + last-N-layer aggregation + wordpiece merging
(counterpart of medmoe_tpu/models/text_encoder.py, reference
src/models/components/text_encoder.py).

Semantics:
  * stack the last ``last_n_layers`` hidden states  (text_encoder.py:97-103)
  * sum consecutive '##' pieces into their word's slot through the
    tokenizer's segment ids; [SEP] gets its own slot; negative ids (padding
    after [SEP]) are dropped                         (text_encoder.py:48-77)
  * sent_embeddings = mean over ALL T positions (zero padding included)
  * 'sum' or 'mean' aggregation over layers          (text_encoder.py:112-117)
  * optional global/local projection heads + L2 norm (text_encoder.py:128-142)
  * returns word_embeddings [B, D, T] (channel-first)

The aggregation after BERT's layers runs in the span ``medmoe#bert.merge``
(inside the caller's ``medmoe#bert``), so its device time and its
backward's read apart from the layers'.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from medmoe_torch.models.bert import BertConfig, BertModel
from medmoe_torch.models.layers import Dense, l2_normalize
from medmoe_torch.utils.trace import span


def merge_wordpieces(stacked: torch.Tensor,
                     segment_ids: torch.Tensor) -> torch.Tensor:
    """Sum token embeddings into merged-word slots.

    stacked:     [B, L, T, D] per-layer token embeddings
    segment_ids: [B, T] slot index for every token (< 0 → dropped)
    returns      [B, L, T, D] with slot j = Σ_{t: seg[t]=j} token_t, zero-padded.
    """
    t = stacked.shape[2]
    slots = torch.arange(t, device=stacked.device)
    onehot = (segment_ids[:, :, None] == slots[None, None, :]).float()
    merged = torch.einsum("bts,bltd->blsd", onehot, stacked.float())
    return merged.to(stacked.dtype)


class BertTextEncoder(nn.Module):
    """PyTorch analogue of the reference BertEncoder facade."""

    def __init__(self, cfg: Any):
        super().__init__()
        self.cfg = cfg
        self.bert = BertModel(BertConfig.from_cfg(cfg))
        if cfg.get("projection", False):
            d = self.bert.config.hidden_size
            embed_dim = int(cfg.get("embed_dim", 768))
            self.emb_local = Dense(d, embed_dim, dtype=torch.float32)
            self.emb_global = Dense(d, embed_dim, dtype=torch.float32)

    def forward(self, input_ids, attention_mask, token_type_ids, segment_ids):
        cfg = self.cfg
        last_n = int(cfg.get("last_n_layers", 4))
        agg_method = cfg.get("aggregate_method", "sum")
        _, _, hidden_states = self.bert(input_ids, attention_mask,
                                        token_type_ids)
        with span("medmoe#bert.merge"):
            if last_n > 1:
                # [B, L, T, D]
                stacked = torch.stack(hidden_states[-last_n:], dim=1)
                if cfg.get("agg_tokens", True):
                    stacked = merge_wordpieces(stacked, segment_ids)
                sent = stacked.mean(dim=2)                     # [B, L, D]
                if agg_method == "sum":
                    word = stacked.sum(dim=1)                  # [B, T, D]
                    sent = sent.sum(dim=1)                     # [B, D]
                elif agg_method == "mean":
                    word = stacked.mean(dim=1)
                    sent = sent.mean(dim=1)
                else:
                    raise ValueError(
                        f"aggregate_method {agg_method!r} not implemented")
            else:
                word = hidden_states[-1]
                sent = word.mean(dim=1)

        if cfg.get("projection", False):
            word = self.emb_local(word)
            sent = self.emb_global(sent)

        word = word.permute(0, 2, 1)                               # [B, D, T]
        if cfg.get("norm", False):
            word = l2_normalize(word, dim=1)
            sent = l2_normalize(sent, dim=1)
        return word, sent
