"""Softmax with a bfloat16 backward residual (counterpart of
medmoe_tpu/ops/softmax.py).

The forward value is the exact float32 softmax; only the tensor kept for
the backward is rounded to bfloat16. The vjp y·(g − Σ y·g) needs only y, a
probability in [0, 1] where bf16 costs ~0.4% relative — the rounding both
consumers (the GLoRIA word-region attention) already apply to y before
their products. At B=32 and M=3136 the attention keeps two [Bt, Bi, M, T]
residuals, 2 × 321 MB in float32, half that in bf16.
"""

from __future__ import annotations

import torch


class _SoftmaxBf16Residual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int) -> torch.Tensor:
        y = torch.softmax(x, dim=dim)
        ctx.dim = dim
        ctx.save_for_backward(y.to(torch.bfloat16))
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (y16,) = ctx.saved_tensors
        y = y16.float()
        gf = g.float()
        d = y * (gf - torch.sum(y * gf, dim=ctx.dim, keepdim=True))
        # the cotangent carries the primal's dtype, as the JAX custom-vjp does
        return d.to(g.dtype), None


def softmax_bf16_residual(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.softmax(x, dim)`` whose backward residual is kept in bf16."""
    return _SoftmaxBf16Residual.apply(x, dim)
