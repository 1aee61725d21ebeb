"""Swin Transformer (Tiny) vision backbone in PyTorch (counterpart of
medmoe_tpu/models/swin.py).

A 4-stage hierarchical transformer emitting the feature pyramid
``[B,3136,96], [B,784,192], [B,196,384], [B,49,768]`` plus the LayerNorm'd
final hidden state — the inputs to the MoE block. Tokens stay NHWC
(``[B, H·W, C]``) as in the JAX package; only the patch-embed convolution
sees NCHW.

Numerics follow the JAX module step for step: bf16 activations, f32
parameters, attention logits computed from bf16 q/k in f32, softmax in f32
then rounded to bf16, LayerNorm in f32. Window attention, LayerNorm and the
dense projections are library calls here as they were XLA ops there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from medmoe_torch.models.layers import Dense, Fp32LayerNorm, Mlp


@dataclass(frozen=True)
class SwinConfig:
    image_size: int = 224
    patch_size: int = 4
    in_channels: int = 3
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_path_rate: float = 0.1
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @property
    def num_stages(self) -> int:
        return len(self.depths)

    @property
    def stage_dims(self) -> Tuple[int, ...]:
        return tuple(self.embed_dim * (2 ** i) for i in range(self.num_stages))


def _relative_position_index(window: int) -> np.ndarray:
    """Static [w², w²] index into the (2w-1)² relative-position-bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij"))          # [2, w, w]
    coords = coords.reshape(2, -1)                          # [2, w²]
    rel = coords[:, :, None] - coords[:, None, :]           # [2, w², w²]
    rel = rel.transpose(1, 2, 0).astype(np.int64)           # [w², w², 2]
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)                                      # [w², w²]


def _shift_attention_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """Static [nW, w², w²] additive mask (-100 across shift boundaries)."""
    img = np.zeros((h, w))
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    img = img.reshape(h // window, window, w // window, window)
    img = img.transpose(0, 2, 1, 3).reshape(-1, window * window)  # [nW, w²]
    diff = img[:, None, :] - img[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, H, W, C] → [B·nW, w², C]."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, window * window, c)


def window_reverse(x: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    """[B·nW, w², C] → [B, H, W, C]."""
    b = x.shape[0] // ((h // window) * (w // window))
    x = x.reshape(b, h // window, w // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


def drop_path(x: torch.Tensor, rate: float, training: bool,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stochastic depth on the residual branch (per sample), the mask drawn
    from ``generator`` (None: the global generator)."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand((x.shape[0],) + (1,) * (x.ndim - 1),
                      generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class WindowAttention(nn.Module):
    """Multi-head self-attention within a window, with relative position bias."""

    def __init__(self, dim: int, num_heads: int, window: int,
                 qkv_bias: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.dtype = dtype
        self.query = Dense(dim, dim, bias=qkv_bias, dtype=dtype)
        self.key = Dense(dim, dim, bias=qkv_bias, dtype=dtype)
        self.value = Dense(dim, dim, bias=qkv_bias, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(_relative_position_index(window).reshape(-1)),
            persistent=False)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        # x: [nB, w², C]; mask: [nW, w², w²] or None
        nb, n, _ = x.shape
        nh = self.num_heads
        head_dim = self.dim // nh
        q = (self.query(x) * head_dim ** -0.5).reshape(nb, n, nh, head_dim)
        k = self.key(x).reshape(nb, n, nh, head_dim)
        v = self.value(x).reshape(nb, n, nh, head_dim)

        # logits from the compute-dtype q/k, accumulated and kept in f32
        attn = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        bias = self.relative_position_bias_table[self.relative_position_index]
        attn = attn + bias.reshape(n, n, nh).permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(nb // nw, nw, nh, n, n) + mask[None, :, None]
            attn = attn.reshape(nb, nh, n, n)
        attn = torch.softmax(attn, dim=-1).to(self.dtype)
        out = torch.matmul(attn, v.permute(0, 2, 1, 3))      # [nB, nH, n, hd]
        out = out.permute(0, 2, 1, 3).reshape(nb, n, self.dim)
        return self.proj(out)


class SwinBlock(nn.Module):
    # drop-path noise source, set by layers.set_generator
    generator: Optional[torch.Generator] = None

    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 input_resolution: Tuple[int, int], mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path: float = 0.0,
                 eps: float = 1e-5, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        h, w = input_resolution
        self.input_resolution = input_resolution
        self.window = window
        self.shift = shift if min(h, w) > window else 0
        self.drop_path = drop_path
        self.norm1 = Fp32LayerNorm(dim, eps)
        self.attn = WindowAttention(dim, num_heads, window, qkv_bias, dtype)
        self.norm2 = Fp32LayerNorm(dim, eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, dtype=dtype)
        mask = None
        if self.shift > 0:
            mask = torch.from_numpy(
                _shift_attention_mask(h, w, window, self.shift))
        self.register_buffer("attn_mask", mask, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: [B, H·W, C]
        h, w = self.input_resolution
        b, n, c = x.shape
        shift = self.shift

        shortcut = x
        y = self.norm1(x).reshape(b, h, w, c)
        if shift > 0:
            y = torch.roll(y, shifts=(-shift, -shift), dims=(1, 2))
        y = window_partition(y, self.window)
        y = self.attn(y, self.attn_mask)
        y = window_reverse(y, self.window, h, w)
        if shift > 0:
            y = torch.roll(y, shifts=(shift, shift), dims=(1, 2))
        y = y.reshape(b, n, c)
        x = shortcut + drop_path(y, self.drop_path, self.training,
                                 self.generator)

        y = self.mlp(self.norm2(x))
        return x + drop_path(y, self.drop_path, self.training, self.generator)


class PatchMerging(nn.Module):
    """2×2 patch concat → LayerNorm → Linear(4C→2C)."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 eps: float = 1e-5, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.input_resolution = input_resolution
        self.norm = Fp32LayerNorm(4 * dim, eps)
        self.reduction = Dense(4 * dim, 2 * dim, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = self.input_resolution
        b, _, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c)
        # concat order matches HF SwinPatchMerging for checkpoint parity
        x = torch.cat([x[:, :, 0, :, 0], x[:, :, 1, :, 0],
                       x[:, :, 0, :, 1], x[:, :, 1, :, 1]], dim=-1)
        x = x.reshape(b, (h // 2) * (w // 2), 4 * c)
        return self.reduction(self.norm(x))


class PatchEmbed(nn.Module):
    """Conv patchify (4×4 stride 4) + LayerNorm."""

    def __init__(self, embed_dim: int, patch_size: int, in_channels: int = 3,
                 eps: float = 1e-5, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_channels, embed_dim, patch_size,
                              stride=patch_size)
        self.norm = Fp32LayerNorm(embed_dim, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: [B, H, W, 3] NHWC → NCHW for the convolution only
        dt = self.dtype
        y = F.conv2d(x.permute(0, 3, 1, 2).to(dt), self.proj.weight.to(dt),
                     self.proj.bias.to(dt), stride=self.patch_size)
        b, c, h, w = y.shape
        y = y.permute(0, 2, 3, 1).reshape(b, h * w, c)
        return self.norm(y)


class SwinBackbone(nn.Module):
    """The full tower. ``forward`` returns ``(pyramid, final)``: the
    embedding output plus each stage output after downsampling, and the
    LayerNorm'd last hidden state (reference swin.py:134-139)."""

    def __init__(self, config: SwinConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        res = cfg.image_size // cfg.patch_size
        self.patch_embed = PatchEmbed(cfg.embed_dim, cfg.patch_size,
                                      cfg.in_channels, cfg.layer_norm_eps,
                                      cfg.dtype)
        self.layout: List[Tuple[str, ...]] = []
        total_blocks = sum(cfg.depths)
        block_idx = 0
        for stage in range(cfg.num_stages):
            dim = cfg.stage_dims[stage]
            h = w = res // (2 ** stage)
            names = []
            for d in range(cfg.depths[stage]):
                rate = cfg.drop_path_rate * block_idx / max(total_blocks - 1, 1)
                name = f"stage{stage}_block{d}"
                self.add_module(name, SwinBlock(
                    dim=dim, num_heads=cfg.num_heads[stage],
                    window=cfg.window_size,
                    shift=0 if d % 2 == 0 else cfg.window_size // 2,
                    input_resolution=(h, w), mlp_ratio=cfg.mlp_ratio,
                    qkv_bias=cfg.qkv_bias, drop_path=rate,
                    eps=cfg.layer_norm_eps, dtype=cfg.dtype))
                names.append(name)
                block_idx += 1
            if stage < cfg.num_stages - 1:
                name = f"stage{stage}_downsample"
                self.add_module(name, PatchMerging(dim, (h, w),
                                                   cfg.layer_norm_eps,
                                                   cfg.dtype))
                names.append(name)
            self.layout.append(tuple(names))
        self.norm = Fp32LayerNorm(cfg.stage_dims[-1], cfg.layer_norm_eps)

    def forward(self, pixels: torch.Tensor):
        x = self.patch_embed(pixels.to(self.config.dtype))
        pyramid = [x]
        for stage, names in enumerate(self.layout):
            for name in names:
                x = getattr(self, name)(x)
            if stage < len(self.layout) - 1:
                pyramid.append(x)
        return pyramid, self.norm(x)
