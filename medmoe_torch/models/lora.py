"""LoRA adapters (counterpart of medmoe_tpu/models/lora.py; reference
src/models/components/lora_layers.py, the Microsoft LoRA reference
implementation).

Each adapted layer owns its base parameters plus low-rank ``lora_a`` /
``lora_b`` factors; the effective weight is ``W + (B @ A) * (alpha / r)``.
The factors keep the JAX package's layouts, so ``bridge.from_jax_params``
carries them over unchanged:

  * ``LoRALinear``: ``lora_a`` [in, r], ``lora_b`` [r, out], and the update
    ``x @ a @ b`` computed in float32;
  * ``LoRAConv``: ``lora_a`` [r, kh·kw·in], ``lora_b`` [out, r], and the
    kernel delta ``(b @ a).T.reshape(kh, kw, in, out)`` — HWIO order, which
    is permuted to the port's OIHW (it is not the reference ConvLoRA's
    ``(B @ A).view(out, in, kh, kw)``);
  * ``LoRAEmbedding``: ``lora_a`` [num_embeddings, r], ``lora_b`` [r, out].

Freezing the base weights is the caller's job (``lora_param_mask``);
merging is the pure ``merge_lora`` transform, which returns a new
``state_dict``.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from medmoe_torch.models.layers import Dense, Dropout


class LoRALinear(nn.Module):
    """Dense layer with an optional low-rank update (reference
    lora_layers.py:90-152). The base computes in ``dtype``; the update in
    float32, so the sum is float32 when ``r > 0``."""

    def __init__(self, in_features: int, features: int, r: int = 0,
                 alpha: int = 1, dropout_rate: float = 0.0,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.r, self.alpha = int(r), alpha
        self.base = Dense(in_features, features, bias=use_bias, dtype=dtype)
        if self.r > 0:
            self.lora_a = nn.Parameter(torch.zeros(in_features, self.r))
            self.lora_b = nn.Parameter(torch.zeros(self.r, features))
            self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.base(x)
        if self.r > 0:
            h = self.dropout(x)
            y = y + (h.float() @ self.lora_a @ self.lora_b) \
                * (self.alpha / self.r)
        return y


class LoRAEmbedding(nn.Module):
    """Embedding with a low-rank update (reference lora_layers.py:32-87)."""

    def __init__(self, num_embeddings: int, features: int, r: int = 0,
                 alpha: int = 1):
        super().__init__()
        self.r, self.alpha = int(r), alpha
        self.base = nn.Embedding(num_embeddings, features)
        if self.r > 0:
            self.lora_a = nn.Parameter(torch.zeros(num_embeddings, self.r))
            self.lora_b = nn.Parameter(torch.zeros(self.r, features))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        y = self.base(ids)
        if self.r > 0:
            y = y + (F.embedding(ids, self.lora_a) @ self.lora_b) \
                * (self.alpha / self.r)
        return y


def same_padding(size: Tuple[int, int], kernel: Tuple[int, int],
                 stride: Tuple[int, int]) -> Tuple[int, int, int, int]:
    """XLA's "SAME" padding of an [.., H, W] input, in ``F.pad`` order
    (left, right, top, bottom): the output is ceil(in / stride) and the odd
    pixel goes after, so a stride-2 conv on an even input pads (0, 1)
    around a 3×3 kernel and (2, 3) around a 7×7."""
    pads = []
    for n, k, s in zip(size, kernel, stride):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    (top, bottom), (left, right) = pads
    return left, right, top, bottom


class LoRAConv(nn.Module):
    """Conv2d with a low-rank update on the flattened kernel (reference
    ConvLoRA, lora_layers.py:246-309). NCHW input, OIHW ``weight``;
    ``padding`` is "SAME" (XLA's, computed per call from the input's size)
    or explicit ((top, bottom), (left, right))."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1),
                 padding: Union[str, Sequence[Tuple[int, int]]] = "SAME",
                 r: int = 0, alpha: int = 1, use_bias: bool = True):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides)
        self.padding = padding
        self.r, self.alpha = int(r), alpha
        kh, kw = self.kernel_size
        self.weight = nn.Parameter(torch.zeros(features, in_channels, kh, kw))
        if self.r > 0:
            self.lora_a = nn.Parameter(torch.zeros(self.r,
                                                   kh * kw * in_channels))
            self.lora_b = nn.Parameter(torch.zeros(features, self.r))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def kernel(self) -> torch.Tensor:
        """The effective OIHW kernel."""
        w = self.weight
        if self.r > 0:
            out, cin, kh, kw = w.shape
            # (b @ a) is [out, (kh, kw, in)]: JAX's HWIO delta, transposed
            delta = (self.lora_b @ self.lora_a).reshape(out, kh, kw, cin)
            w = w + delta.permute(0, 3, 1, 2) * (self.alpha / self.r)
        return w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == "SAME":
            pad = same_padding(tuple(x.shape[-2:]), self.kernel_size,
                               self.strides)
        else:
            (top, bottom), (left, right) = self.padding
            pad = (left, right, top, bottom)
        if pad[0] == pad[1] and pad[2] == pad[3]:
            return F.conv2d(x, self.kernel(), self.bias, self.strides,
                            (pad[2], pad[0]))
        return F.conv2d(F.pad(x, pad), self.kernel(), self.bias, self.strides)


class LoRAMergedLinear(nn.Module):
    """qkv-style fused projection with LoRA on a subset of its equal output
    blocks (reference MergedLinear, lora_layers.py:155-244). Computes in
    float32, as flax's ``nn.Dense`` promotes to its float32 parameters."""

    def __init__(self, in_features: int, features: int,
                 enable_lora: Sequence[bool] = (True, False, True),
                 r: int = 0, alpha: int = 1, use_bias: bool = True):
        super().__init__()
        self.enable_lora = tuple(bool(e) for e in enable_lora)
        self.r, self.alpha = int(r), alpha
        self.block = features // len(self.enable_lora)
        self.base = nn.Linear(in_features, features, bias=use_bias)
        n_on = sum(self.enable_lora)
        self.adapted = self.r > 0 and n_on > 0
        if self.adapted:
            self.lora_a = nn.Parameter(torch.zeros(in_features,
                                                   self.r * n_on))
            self.lora_b = nn.Parameter(torch.zeros(self.r * n_on,
                                                   self.block))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        y = self.base(x)
        if not self.adapted:
            return y
        deltas, on, r = [], 0, self.r
        for enabled in self.enable_lora:
            if enabled:
                a = self.lora_a[:, on * r:(on + 1) * r]
                b = self.lora_b[on * r:(on + 1) * r]
                deltas.append((x @ a @ b) * (self.alpha / r))
                on += 1
            else:
                deltas.append(x.new_zeros(x.shape[:-1] + (self.block,)))
        return y + torch.cat(deltas, dim=-1)


class LoRAMultiheadAttention(nn.Module):
    """Multi-head attention with LoRA on the chosen q/k/v/out projections
    (reference PlainMultiheadAttentionLoRA, lora_layers.py:312-501).
    ``mask`` is boolean, True where attention is allowed."""

    def __init__(self, dim: int, num_heads: int, r: int = 8,
                 alpha: int = 16, dropout_rate: float = 0.0,
                 enable_lora: Tuple[bool, bool, bool, bool] = (True, False,
                                                              True, True),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads

        def proj(enabled):
            return LoRALinear(dim, dim, r=r if enabled else 0, alpha=alpha,
                              dropout_rate=dropout_rate, dtype=dtype)

        q_on, k_on, v_on, o_on = enable_lora
        self.q_proj, self.k_proj = proj(q_on), proj(k_on)
        self.v_proj, self.out_proj = proj(v_on), proj(o_on)

    def forward(self, query: torch.Tensor,
                key: Optional[torch.Tensor] = None,
                value: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        key = query if key is None else key
        value = key if value is None else value
        b, tq, _ = query.shape
        h, hd = self.num_heads, self.dim // self.num_heads
        q = self.q_proj(query).reshape(b, tq, h, hd)
        k = self.k_proj(key).reshape(b, key.shape[1], h, hd)
        v = self.v_proj(value).reshape(b, value.shape[1], h, hd)
        attn = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        attn = attn / math.sqrt(hd)
        if mask is not None:
            attn = torch.where(mask, attn, torch.full_like(attn, -1e30))
        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", attn.to(v.dtype).float(),
                           v.float())
        out = out.to(query.dtype).reshape(b, tq, self.dim)
        return self.out_proj(out)


# --------------------------------------------------------------------------
# functional utilities on a state_dict (the JAX package's tree transforms)
# --------------------------------------------------------------------------

def lora_param_mask(state: Mapping[str, torch.Tensor]) -> Dict[str, bool]:
    """Name → True for LoRA factors, False elsewhere (reference
    mark_only_lora_as_trainable): ``{n for n, v in mask.items() if v}`` is
    the set to train."""
    return {name: any(part.startswith("lora_") for part in name.split("."))
            for name in state}


def _scaled(alpha_over_r: Optional[float]) -> float:
    if alpha_over_r is None:
        raise ValueError("merge_lora: alpha_over_r is required to fold LoRA "
                         "factors (pass alpha / r)")
    return alpha_over_r


def _kinds(model: nn.Module) -> Dict[str, str]:
    """``state_dict`` prefix → the kind of LoRA module that owns it."""
    kinds = {}
    for name, mod in model.named_modules():
        kind = {LoRALinear: "linear", LoRAEmbedding: "embedding",
                LoRAConv: "conv", LoRAMergedLinear: "merged"}.get(type(mod))
        if kind:
            kinds[f"{name}." if name else ""] = kind
    return kinds


def _infer_kind(state: Mapping[str, torch.Tensor], p: str) -> Optional[str]:
    """The kind of the factor pair at prefix ``p``, from the shapes alone;
    raises where a square table leaves linear and embedding apart only by
    the module."""
    a, b = state[p + "lora_a"], state[p + "lora_b"]
    base, conv = state.get(p + "base.weight"), state.get(p + "weight")
    if base is not None and base.ndim == 2:
        linear = tuple(base.shape) == (b.shape[1], a.shape[0])
        embedding = tuple(base.shape) == (a.shape[0], b.shape[1])
        if linear and embedding:
            raise ValueError(f"merge_lora: {p}base.weight is square, so its "
                             f"factors fit a LoRALinear and a LoRAEmbedding "
                             f"alike: pass the model")
        return "linear" if linear else "embedding" if embedding else None
    if conv is not None and conv.ndim == 4:
        o, cin, kh, kw = conv.shape
        if tuple(b.shape) == (o, a.shape[0]) and a.shape[1] == kh * kw * cin:
            return "conv"
    return None


def merge_lora(state: Union[nn.Module, Mapping[str, torch.Tensor]],
               alpha_over_r: Optional[float] = None
               ) -> Dict[str, torch.Tensor]:
    """Fold ``lora_a``/``lora_b`` into the base weights and drop the factors
    (the functional analogue of the reference's eval-time merge): a new
    ``state_dict``, the input unchanged. ``state`` is a ``state_dict`` or a
    module (whose own ``state_dict`` is merged, each pair by its module's
    kind; a ``state_dict`` is read by shapes). ``alpha_over_r`` (LoRA
    alpha / r) is required whenever a pair is folded. Handles
    ``LoRALinear`` (``base.weight`` [out, in]), ``LoRAConv`` (``weight``,
    factors over the flattened HWIO kernel) and ``LoRAEmbedding``
    (``base.weight`` as a table). ``LoRAMergedLinear`` factors are
    block-structured (which output blocks are adapted is a module
    attribute, not recoverable from the state): they stay in place,
    unmerged, so the module gives the same outputs."""
    kinds = None
    if isinstance(state, nn.Module):
        kinds, state = _kinds(state), state.state_dict()
    out = dict(state)
    for p in sorted({k[:-len("lora_a")] for k in state
                     if k.endswith("lora_a")
                     and k[:-len("lora_a")] + "lora_b" in state}):
        kind = kinds.get(p) if kinds is not None else _infer_kind(state, p)
        a, b = state[p + "lora_a"], state[p + "lora_b"]
        if kind == "linear":            # weight [out, in] += (a @ b).T
            out[p + "base.weight"] = state[p + "base.weight"] \
                + (a @ b).T * _scaled(alpha_over_r)
        elif kind == "embedding":       # table [num, out] += a @ b
            out[p + "base.weight"] = state[p + "base.weight"] \
                + (a @ b) * _scaled(alpha_over_r)
        elif kind == "conv":            # (b @ a) is [out, (kh, kw, in)]
            w = state[p + "weight"]
            o, cin, kh, kw = w.shape
            delta = (b @ a).reshape(o, kh, kw, cin).permute(0, 3, 1, 2)
            out[p + "weight"] = w + delta * _scaled(alpha_over_r)
        else:                           # LoRAMergedLinear: factors stay
            continue
        del out[p + "lora_a"], out[p + "lora_b"]
    return out
