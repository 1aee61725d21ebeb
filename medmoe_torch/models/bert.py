"""BERT text encoder (counterpart of medmoe_tpu/models/bert.py): a
BERT-base encoder returning all per-layer hidden states so the caller can
aggregate the last N layers (reference text_encoder.py:18-22, HF
Bio_ClinicalBERT). bf16 activations, f32 parameters, attention logits in
f32, additive mask. The word table is a plain ``nn.Embedding``: the JAX
package's one-hot embedding forms were TPU workarounds. Train-mode dropout
draws from an explicit generator (``layers.Dropout``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
from torch import nn

from medmoe_torch.models.layers import Dense, Dropout, Fp32LayerNorm, \
    gelu_exact, resolve_dtype


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 28996          # Bio_ClinicalBERT (bert-base-cased vocab)
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    # HF bert-base defaults; active only in train mode
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def from_cfg(cls, cfg) -> "BertConfig":
        """Build from a `text` config node."""
        return cls(
            vocab_size=int(cfg.get("vocab_size", 28996)),
            hidden_size=int(cfg.get("hidden_size", 768)),
            num_layers=int(cfg.get("num_layers", 12)),
            num_heads=int(cfg.get("num_heads", 12)),
            intermediate_size=int(cfg.get("intermediate_size", 3072)),
            max_position_embeddings=int(
                cfg.get("max_position_embeddings", 512)),
            hidden_dropout_prob=float(cfg.get("hidden_dropout_prob", 0.1)),
            attention_probs_dropout_prob=float(
                cfg.get("attention_probs_dropout_prob", 0.1)),
            dtype=resolve_dtype(cfg.get("dtype", "bfloat16")))


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dtype = cfg.dtype
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.norm = Fp32LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: torch.Tensor) -> torch.Tensor:
        t = input_ids.shape[1]
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings.weight[None, :t]
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.norm(x)).to(self.dtype)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.dtype = cfg.dtype
        self.query = Dense(d, d, dtype=cfg.dtype)
        self.key = Dense(d, d, dtype=cfg.dtype)
        self.value = Dense(d, d, dtype=cfg.dtype)
        self.dropout = Dropout(cfg.attention_probs_dropout_prob)

    def forward(self, x: torch.Tensor,
                additive_mask: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        nh = self.num_heads
        hd = d // nh
        q = self.query(x).reshape(b, t, nh, hd)
        k = self.key(x).reshape(b, t, nh, hd)
        v = self.value(x).reshape(b, t, nh, hd)
        attn = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        attn = attn / torch.sqrt(torch.tensor(hd, dtype=torch.float32)) \
            + additive_mask
        attn = self.dropout(torch.softmax(attn, dim=-1).to(self.dtype))
        out = torch.matmul(attn, v.permute(0, 2, 1, 3))       # [b, nh, t, hd]
        return out.permute(0, 2, 1, 3).reshape(b, t, d)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        d = cfg.hidden_size
        self.attention = BertSelfAttention(cfg)
        self.attention_output = Dense(d, d, dtype=cfg.dtype)
        self.attention_norm = Fp32LayerNorm(d, cfg.layer_norm_eps)
        self.intermediate = Dense(d, cfg.intermediate_size, dtype=cfg.dtype)
        self.output = Dense(cfg.intermediate_size, d, dtype=cfg.dtype)
        self.output_norm = Fp32LayerNorm(d, cfg.layer_norm_eps)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, x: torch.Tensor,
                additive_mask: torch.Tensor) -> torch.Tensor:
        attn_out = self.dropout(self.attention_output(
            self.attention(x, additive_mask)))
        x = self.attention_norm(x + attn_out)
        ffn = self.dropout(self.output(gelu_exact(self.intermediate(x))))
        return self.output_norm(x + ffn)


class BertModel(nn.Module):
    """``forward`` returns (last_hidden, pooled, all_hidden_states) like HF
    with output_hidden_states=True."""

    def __init__(self, config: BertConfig):
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config)
        for i in range(config.num_layers):
            self.add_module(f"layer_{i}", BertLayer(config))
        self.pooler = Dense(config.hidden_size, config.hidden_size,
                            dtype=config.dtype)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, ...]]:
        x = self.embeddings(input_ids, token_type_ids)
        additive_mask = torch.where(attention_mask[:, None, None, :] > 0,
                                    0.0, -1e9).float()
        hidden_states = (x,)
        for i in range(self.config.num_layers):
            x = getattr(self, f"layer_{i}")(x, additive_mask)
            hidden_states = hidden_states + (x,)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled, hidden_states
