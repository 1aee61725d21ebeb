"""Shared building blocks (counterpart of medmoe_tpu/models/layers.py).

Precision policy, the same as the JAX package's:
  * parameters live in float32; activations compute in a configurable
    dtype (bfloat16 by default): a ``Dense`` layer casts its input, weight
    and bias to that dtype, and the product accumulates in float32;
  * LayerNorm always computes in float32 and casts back (the reference's
    ``Fp32LayerNorm``, reference src/models/components/normalizations.py).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_dtype(name) -> torch.dtype:
    """Config dtype string (or torch dtype) → torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return _DTYPES[str(name)]


class Dense(nn.Linear):
    """``nn.Linear`` with float32 parameters that computes in ``dtype``
    (flax ``nn.Dense(dtype=..., param_dtype=float32)``)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Fp32LayerNorm(nn.Module):
    """LayerNorm computed in float32 regardless of input dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias,
                         self.eps)
        return y.to(x.dtype)


class Dropout(nn.Module):
    """Dropout whose mask draws from ``self.generator`` (a
    ``torch.Generator`` on the input's device, set by ``set_generator``;
    None draws from the global generator), as flax's ``nn.Dropout`` draws
    from the explicit "dropout" key: keep with probability 1 − p, scale
    kept values by 1/(1 − p). Active in train mode only."""

    generator: Optional[torch.Generator] = None

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        mask = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


def set_generator(model: nn.Module,
                  generator: Optional[torch.Generator]) -> None:
    """Point every module of ``model`` that draws training-mode noise
    (``Dropout``, the Swin blocks' drop-path) at ``generator``."""
    for mod in model.modules():
        if hasattr(type(mod), "generator"):
            mod.generator = generator


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """erf-based GELU (HF 'gelu'; the tanh approximation diverges ~1e-3)."""
    return F.gelu(x, approximate="none")


class Mlp(nn.Module):
    """Transformer FFN: Linear → exact GELU → Linear."""

    def __init__(self, dim: int, hidden_dim: int,
                 out_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.fc1 = Dense(dim, hidden_dim, dtype=dtype)
        self.fc2 = Dense(hidden_dim, out_dim or dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu_exact(self.fc1(x)))


def safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = True,
              eps: float = 1e-12) -> torch.Tensor:
    """||x||_2 with the eps floor INSIDE the sqrt (medmoe_tpu
    ops/losses.py:31-41): the same values as ``max(norm, eps)`` but a
    finite gradient at x = 0."""
    s = torch.sum(x * x, dim=dim, keepdim=keepdim)
    return torch.sqrt(torch.clamp(s, min=eps * eps))


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """x / ||x||_2 along ``dim``, computed in float32 and cast back."""
    xf = x.float()
    return (xf / safe_norm(xf, dim=dim, eps=eps)).to(x.dtype)
