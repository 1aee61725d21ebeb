"""Generic transformer components (counterpart of
medmoe_tpu/models/transformer.py; reference vendored-torchmultimodal files
multimodal_transformer.py, attention.py, transformer.py,
multi_head_attention.py, common.py).

Pre-/post-norm encoder layers with stochastic depth, decoder layers with
cross-attention and a key/value cache for decoding token by token, a
functional scaled-dot-product attention with attention and head masks,
and the axis-shift helper. Attention is written as plain products and a
softmax, as the JAX function is, so its masks mean the same: a boolean
``attention_mask`` is True where attention is allowed (a masked logit is
-1e30, not -inf), and ``head_mask`` multiplies the probabilities.

The JAX package keeps its cache as a flax ``cache`` collection with a
static ``max_cache_length`` and a position index. Here it is explicit
state: ``init_cache`` makes it, and a module built with ``use_cache``
takes it with ``decode_step`` and returns the updated copy beside its
output.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from medmoe_torch.models.layers import Dense, Fp32LayerNorm, Mlp

Cache = Dict[str, torch.Tensor]


class TransformerOutput(NamedTuple):
    """reference transformer.py:23-29."""

    last_hidden_state: Optional[torch.Tensor] = None
    pooler_output: Optional[torch.Tensor] = None
    hidden_states: Optional[Tuple[torch.Tensor, ...]] = None
    attentions: Optional[Tuple[torch.Tensor, ...]] = None


def shift_dim(x: torch.Tensor, src_dim: int = -1, dest_dim: int = -1
              ) -> torch.Tensor:
    """Move one axis to another position (reference common.py:12-52)."""
    n = x.ndim
    src, dest = src_dim % n, dest_dim % n
    perm = [i for i in range(n) if i != src]
    perm.insert(dest, src)
    return x.permute(perm)


def scaled_dot_product_attention(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        head_mask: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., H, T, hd] attention with an optional boolean mask and head
    mask (reference attention.py:185-241): the logits and the weighted sum
    accumulate in float32; returns (out in v's dtype, probabilities)."""
    attn = torch.einsum("...qd,...kd->...qk", q.float(), k.float())
    attn = attn / math.sqrt(q.shape[-1])
    if attention_mask is not None:
        attn = torch.where(attention_mask, attn, torch.full_like(attn, -1e30))
    attn = torch.softmax(attn, dim=-1)
    if head_mask is not None:
        attn = attn * head_mask
    out = torch.einsum("...qk,...kd->...qd", attn.to(v.dtype).float(),
                       v.float()).to(v.dtype)
    return out, attn


def split_multihead(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, T, D] → [B, H, T, D/H] (reference attention.py:244-250)."""
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads).permute(0, 2, 1, 3)


def merge_multihead(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, hd] → [B, T, D] (reference attention.py:252-256)."""
    b, h, t, hd = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, t, h * hd)


class MultiHeadAttention(nn.Module):
    """q/k/v/out-projected attention with an optional key/value cache
    (reference attention.py:70-182 + multi_head_attention.py). ``kv_dim``
    is the width of the key and value inputs (``dim`` by default; a
    decoder's memory may be wider or narrower)."""

    def __init__(self, dim: int, num_heads: int, use_cache: bool = False,
                 max_cache_length: int = 64,
                 dtype: torch.dtype = torch.float32,
                 kv_dim: Optional[int] = None):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.use_cache, self.max_cache_length = use_cache, max_cache_length
        self.dtype = dtype
        kv_dim = kv_dim or dim
        self.q_proj = Dense(dim, dim, dtype=dtype)
        self.k_proj = Dense(kv_dim, dim, dtype=dtype)
        self.v_proj = Dense(kv_dim, dim, dtype=dtype)
        self.out_proj = Dense(dim, dim, dtype=dtype)

    def init_cache(self, batch: int, device=None) -> Cache:
        """Zero keys and values, [B, H, max_cache_length, hd] each."""
        shape = (batch, self.num_heads, self.max_cache_length,
                 self.dim // self.num_heads)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=device),
                "v": torch.zeros(shape, dtype=self.dtype, device=device)}

    def forward(self, query: torch.Tensor,
                key: Optional[torch.Tensor] = None,
                value: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                head_mask: Optional[torch.Tensor] = None,
                decode_step: Optional[int] = None,
                cache: Optional[Cache] = None):
        """(output [B, T, D], probabilities); with ``use_cache`` also the
        cache with this call's keys and values written at ``decode_step``
        (a fresh zero cache when ``cache`` is None)."""
        key = query if key is None else key
        value = key if value is None else value
        q = split_multihead(self.q_proj(query), self.num_heads)
        k = split_multihead(self.k_proj(key), self.num_heads)
        v = split_multihead(self.v_proj(value), self.num_heads)
        if not self.use_cache:
            out, attn = scaled_dot_product_attention(q, k, v, attention_mask,
                                                     head_mask)
            return self.out_proj(merge_multihead(out)), attn
        if cache is None:
            cache = self.init_cache(query.shape[0], query.device)
        pos, t = int(decode_step or 0), k.shape[2]
        # lax.dynamic_update_slice's write: the start clamped so the slice
        # fits; the validity mask reads the position as given
        start = min(max(pos, 0), self.max_cache_length - t)
        ck, cv = cache["k"].clone(), cache["v"].clone()
        ck[:, :, start:start + t] = k.to(ck.dtype)
        cv[:, :, start:start + t] = v.to(cv.dtype)
        valid = (torch.arange(self.max_cache_length, device=query.device)
                 <= pos + query.shape[1] - 1)[None, None, None, :]
        mask = valid if attention_mask is None \
            else torch.logical_and(attention_mask, valid)
        out, attn = scaled_dot_product_attention(q, ck, cv, mask, head_mask)
        return self.out_proj(merge_multihead(out)), attn, {"k": ck, "v": cv}


class SelfAttention(nn.Module):
    """Attention over arbitrary flattened spatial dims (reference
    attention.py:15-67): [B, ..., D] is flattened to a sequence, attended,
    and reshaped back."""

    def __init__(self, dim: int, num_heads: int, causal: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.causal = causal
        self.mha = MultiHeadAttention(dim, num_heads, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        seq = x.reshape(shape[0], -1, shape[-1])
        mask = None
        if self.causal:
            t = seq.shape[1]
            mask = torch.tril(torch.ones(t, t, dtype=torch.bool,
                                         device=x.device))[None, None]
        out, _ = self.mha(seq, attention_mask=mask)
        return out.reshape(shape)


class TransformerEncoderLayer(nn.Module):
    """Pre- or post-norm encoder layer with stochastic depth (reference
    transformer.py:32-156 / multimodal_transformer.py:81-221). Drop-path
    keeps a sample's branch with probability 1 − ``drop_path`` (scaled by
    its inverse), drawn from ``self.generator`` in train mode."""

    generator: Optional[torch.Generator] = None

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 norm_first: bool = True, drop_path: float = 0.0,
                 eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm_first, self.drop_path = norm_first, float(drop_path)
        self.attention = MultiHeadAttention(dim, num_heads, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dtype=dtype)
        self.norm1 = Fp32LayerNorm(dim, eps=eps)
        self.norm2 = Fp32LayerNorm(dim, eps=eps)

    def _drop_path(self, y: torch.Tensor) -> torch.Tensor:
        if not self.training or self.drop_path == 0.0:
            return y
        keep = 1.0 - self.drop_path
        mask = torch.rand((y.shape[0],) + (1,) * (y.ndim - 1),
                          generator=self.generator, device=y.device) < keep
        return torch.where(mask, y / keep, torch.zeros_like(y))

    def forward(self, x: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                head_mask: Optional[torch.Tensor] = None):
        if self.norm_first:
            y, attn_w = self.attention(self.norm1(x),
                                       attention_mask=attention_mask,
                                       head_mask=head_mask)
            x = x + self._drop_path(y)
            x = x + self._drop_path(self.mlp(self.norm2(x)))
        else:
            y, attn_w = self.attention(x, attention_mask=attention_mask,
                                       head_mask=head_mask)
            x = self.norm1(x + self._drop_path(y))
            x = self.norm2(x + self._drop_path(self.mlp(x)))
        return x, attn_w


class TransformerEncoder(nn.Module):
    """Layer stack returning every hidden state (reference
    transformer.py:159-257 / multimodal_transformer.py:224-295); layer i's
    drop-path rate is ``drop_path_rate · i / (num_layers − 1)``."""

    def __init__(self, num_layers: int, dim: int, num_heads: int,
                 mlp_ratio: float = 4.0, norm_first: bool = True,
                 drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            dp = drop_path_rate * i / max(num_layers - 1, 1)
            setattr(self, f"layer_{i}", TransformerEncoderLayer(
                dim, num_heads, mlp_ratio, norm_first, dp, dtype=dtype))

    def forward(self, x: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> TransformerOutput:
        hidden_states, attentions = (x,), ()
        for i in range(self.num_layers):
            x, attn = getattr(self, f"layer_{i}")(
                x, attention_mask=attention_mask)
            hidden_states += (x,)
            attentions += (attn,)
        return TransformerOutput(last_hidden_state=x,
                                 hidden_states=hidden_states,
                                 attentions=attentions)


class TransformerDecoderLayer(nn.Module):
    """Self-attention (cached) + cross-attention + FFN, pre-norm (reference
    transformer.py:259-661)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 use_cache: bool = False, max_cache_length: int = 64,
                 eps: float = 1e-6, dtype: torch.dtype = torch.float32,
                 memory_dim: Optional[int] = None):
        super().__init__()
        self.use_cache = use_cache
        self.self_attention = MultiHeadAttention(
            dim, num_heads, use_cache=use_cache,
            max_cache_length=max_cache_length, dtype=dtype)
        self.cross_attention = MultiHeadAttention(dim, num_heads, dtype=dtype,
                                                  kv_dim=memory_dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dtype=dtype)
        self.norm1 = Fp32LayerNorm(dim, eps=eps)
        self.norm2 = Fp32LayerNorm(dim, eps=eps)
        self.norm3 = Fp32LayerNorm(dim, eps=eps)

    def init_cache(self, batch: int, device=None) -> Dict[str, Cache]:
        return {"self_attention": self.self_attention.init_cache(batch,
                                                                 device)}

    def forward(self, x: torch.Tensor, memory: torch.Tensor,
                self_mask: Optional[torch.Tensor] = None,
                cross_mask: Optional[torch.Tensor] = None,
                decode_step: Optional[int] = None,
                cache: Optional[Dict[str, Cache]] = None):
        """x, or (x, cache) with ``use_cache``."""
        out = self.self_attention(
            self.norm1(x), attention_mask=self_mask, decode_step=decode_step,
            cache=None if cache is None else cache["self_attention"])
        x = x + out[0]
        y, _ = self.cross_attention(self.norm2(x), memory, memory,
                                    attention_mask=cross_mask)
        x = x + y
        x = x + self.mlp(self.norm3(x))
        return (x, {"self_attention": out[2]}) if self.use_cache else x


class TransformerDecoder(nn.Module):
    """Decoder stack; with ``use_cache`` the cache is
    {"layer_i": {"self_attention": {"k", "v"}}}, the JAX ``cache``
    collection's tree."""

    def __init__(self, num_layers: int, dim: int, num_heads: int,
                 mlp_ratio: float = 4.0, use_cache: bool = False,
                 max_cache_length: int = 64,
                 dtype: torch.dtype = torch.float32,
                 memory_dim: Optional[int] = None):
        super().__init__()
        self.num_layers, self.use_cache = num_layers, use_cache
        for i in range(num_layers):
            setattr(self, f"layer_{i}", TransformerDecoderLayer(
                dim, num_heads, mlp_ratio, use_cache, max_cache_length,
                dtype=dtype, memory_dim=memory_dim))

    def init_cache(self, batch: int, device=None) -> Dict[str, Dict]:
        return {f"layer_{i}": getattr(self, f"layer_{i}").init_cache(
            batch, device) for i in range(self.num_layers)}

    def forward(self, x: torch.Tensor, memory: torch.Tensor,
                self_mask: Optional[torch.Tensor] = None,
                cross_mask: Optional[torch.Tensor] = None,
                decode_step: Optional[int] = None,
                cache: Optional[Dict[str, Dict]] = None):
        """x, or (x, cache) with ``use_cache`` (a fresh zero cache when
        ``cache`` is None)."""
        if not self.use_cache:
            for i in range(self.num_layers):
                x = getattr(self, f"layer_{i}")(x, memory, self_mask,
                                                cross_mask)
            return x
        if cache is None:
            cache = self.init_cache(x.shape[0], x.device)
        new = {}
        for i in range(self.num_layers):
            name = f"layer_{i}"
            x, new[name] = getattr(self, name)(x, memory, self_mask,
                                               cross_mask, decode_step,
                                               cache[name])
        return x, new


class FLAVATransformerWithoutEmbeddings(nn.Module):
    """CLS prepend + pre-norm encoder + final LayerNorm + tanh pooler
    (reference multimodal_transformer.py:19-78): FLAVA's multimodal
    encoder, 12 × 768 with 12 heads and eps 1e-6 by default."""

    def __init__(self, num_layers: int = 12, dim: int = 768,
                 num_heads: int = 12, mlp_ratio: float = 4.0,
                 use_cls_token: bool = True, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim = dim
        if use_cls_token:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        else:
            self.cls_token = None
        self.encoder = TransformerEncoder(num_layers, dim, num_heads,
                                          mlp_ratio, norm_first=True,
                                          dtype=dtype)
        self.final_norm = Fp32LayerNorm(dim, eps=eps)
        self.pooler = nn.Linear(dim, dim)

    def forward(self, hidden_states: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> TransformerOutput:
        b = hidden_states.shape[0]
        if self.cls_token is not None:
            cls = self.cls_token.expand(b, 1, self.dim).to(hidden_states.dtype)
            hidden_states = torch.cat([cls, hidden_states], dim=1)
        out = self.encoder(hidden_states, attention_mask=attention_mask)
        last = self.final_norm(out.last_hidden_state)
        # flax's nn.Dense promotes to its float32 parameters
        pooled = torch.tanh(self.pooler(last[:, 0].float()))
        return TransformerOutput(last_hidden_state=last,
                                 pooler_output=pooled,
                                 hidden_states=out.hidden_states,
                                 attentions=out.attentions)
