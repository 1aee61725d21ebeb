"""Modality-routed Mixture-of-Experts multi-scale fusion (counterpart of
medmoe_tpu/models/moe.py), gather mode.

  * ``Expert``: per-scale 1×1 projection (+ReLU) to a common dim, linear
    interpolation of every scale to the largest patch count, cross-scale
    attention (MLP → softmax over scales), weighted sum (reference
    src/models/components/swin.py:32-80).
  * Routing: router MLP(768→128→K) on the mean-pooled final hidden state,
    softmax, top-1 argmax (reference swin.py:94-108). Gather mode computes
    only each sample's selected expert — the same outputs as the
    reference's all-experts-then-select at 1/K the work.

The expert branch itself is ``ops/expert_fusion.py``: a hand-written CUDA
kernel in bfloat16, its plain PyTorch version in float32 (the
numerics-debug setting) and on the CPU. The ``dense``/``topk``/``ep``
modes of the JAX package are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from medmoe_torch.models.layers import Dense
from medmoe_torch.ops import expert_fusion


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 6
    hidden_dims: Tuple[int, ...] = (96, 192, 384, 768)
    output_dim: int = 768
    router_input_dim: int = 768
    router_hidden_dim: int = 128
    mode: str = "gather"
    top_k: int = 1
    dtype: torch.dtype = torch.bfloat16


def _interp_coords(src_len: int, dst_len: int):
    """Gather indices + blend weights reproducing
    torch.nn.functional.interpolate(mode='linear', align_corners=False):
    y[j] = (1-w_j)·x[lo_j] + w_j·x[hi_j] with
    in_coord = (j + 0.5)·(src/dst) - 0.5, clamped to [0, src-1]."""
    scale = src_len / dst_len
    coord = (np.arange(dst_len) + 0.5) * scale - 0.5
    coord = np.clip(coord, 0.0, src_len - 1)
    lo = np.floor(coord).astype(np.int64)
    hi = np.minimum(lo + 1, src_len - 1)
    w = (coord - lo).astype(np.float32)
    return lo, hi, w


def linear_interp_matrix(src_len: int, dst_len: int) -> np.ndarray:
    """The same interpolation as a dense [src_len, dst_len] matrix."""
    lo, hi, w = _interp_coords(src_len, dst_len)
    mat = np.zeros((src_len, dst_len), dtype=np.float32)
    np.add.at(mat, (lo, np.arange(dst_len)), 1.0 - w)
    np.add.at(mat, (hi, np.arange(dst_len)), w)
    return mat


def interp_patches(h: torch.Tensor, dst_len: int, dim: int) -> torch.Tensor:
    """Linear patch-axis interpolation of ``h`` along ``dim`` to
    ``dst_len``, computed in float32 and rounded back to ``h``'s dtype.

    For an integer ratio r, output q·r+ph blends x[q+c] and x[q+c+1] with
    a phase-constant offset c ∈ {-1, 0} and weight w, edge-padded — the
    same arithmetic as the JAX package's ``interp_patches`` and equal to
    ``F.interpolate(mode='linear', align_corners=False)``. Other ratios
    use the dense matrix."""
    src = h.shape[dim]
    if src == dst_len:
        return h
    if dst_len % src != 0:
        mat = torch.from_numpy(linear_interp_matrix(src, dst_len)).to(h.device)
        out = torch.matmul(h.movedim(dim, -1).float(), mat)
        return out.movedim(-1, dim).to(h.dtype)

    r = dst_len // src
    offs = (np.arange(r) + 0.5) / r - 0.5
    c = np.floor(offs).astype(np.int64)              # -1 or 0 per phase
    w = (offs - c).astype(np.float32)                # phase-constant weight

    x = h.movedim(dim, -2).float()                   # [..., src, E]
    x_m1 = torch.cat([x[..., :1, :], x[..., :-1, :]], dim=-2)
    x_p1 = torch.cat([x[..., 1:, :], x[..., -1:, :]], dim=-2)
    n_lo = int(np.sum(c == -1))
    parts = []
    if n_lo:
        w_lo = torch.from_numpy(w[:n_lo]).to(h.device)[:, None]   # [r_lo, 1]
        parts.append(x_m1[..., :, None, :] * (1.0 - w_lo)
                     + x[..., :, None, :] * w_lo)
    if n_lo < r:
        w_hi = torch.from_numpy(w[n_lo:]).to(h.device)[:, None]   # [r_hi, 1]
        parts.append(x[..., :, None, :] * (1.0 - w_hi)
                     + x_p1[..., :, None, :] * w_hi)
    out = torch.cat(parts, dim=-2).to(h.dtype)       # [..., src, r, E]
    out = out.reshape(out.shape[:-3] + (src * r, out.shape[-1]))
    return out.movedim(-2, dim)


class ExpertBank(nn.Module):
    """All K experts' parameters, stacked with a leading expert axis:
    ``proj_w{s}`` [K, D_s, E], ``proj_b{s}`` [K, E], ``attn_w1`` [K, E, H],
    ``attn_b1`` [K, H], ``attn_w2`` [K, H, 1], ``attn_b2`` [K, 1]."""

    def __init__(self, config: MoEConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        k, d_out = cfg.num_experts, cfg.output_dim
        h = d_out // 2
        for s, d_s in enumerate(cfg.hidden_dims):
            self.register_parameter(
                f"proj_w{s}", nn.Parameter(torch.zeros(k, d_s, d_out)))
            self.register_parameter(
                f"proj_b{s}", nn.Parameter(torch.zeros(k, d_out)))
        self.attn_w1 = nn.Parameter(torch.zeros(k, d_out, h))
        self.attn_b1 = nn.Parameter(torch.zeros(k, h))
        self.attn_w2 = nn.Parameter(torch.zeros(k, h, 1))
        self.attn_b2 = nn.Parameter(torch.zeros(k, 1))

    @property
    def proj_w(self):
        return tuple(getattr(self, f"proj_w{s}")
                     for s in range(len(self.config.hidden_dims)))

    @property
    def proj_b(self):
        return tuple(getattr(self, f"proj_b{s}")
                     for s in range(len(self.config.hidden_dims)))

    def apply_gathered(self, pyramid: Sequence[torch.Tensor],
                       expert_idx: torch.Tensor) -> torch.Tensor:
        """expert_idx [B] or [B, 1] (top-1; its combine weight is exactly
        1.0) → the routed expert's fused map [B, P, E]."""
        if expert_idx.ndim == 2:
            expert_idx = expert_idx[:, 0]
        return self._gather_one(pyramid, expert_idx)

    def _gather_one(self, pyramid: Sequence[torch.Tensor],
                    expert_idx: torch.Tensor) -> torch.Tensor:
        """pyramid[s]: [B, P_s, D_s]; expert_idx: [B] → [B, P, E] f32.

        bfloat16 runs the expert-fusion kernel (its plain version for CPU
        tensors); float32 — the numerics-debug setting — runs the plain
        version in float32, as the JAX package's ``use_fused_expert``
        sends float32 to its XLA path."""
        dt = self.config.dtype
        p_list = [f.shape[1] for f in pyramid]
        args = (tuple(self.proj_w), tuple(self.proj_b), self.attn_w1,
                self.attn_b1, self.attn_w2, self.attn_b2,
                expert_idx.to(torch.int32))
        if expert_fusion.use_fused_expert(p_list, max(p_list), dt):
            xs = tuple(f.to(dt).contiguous() for f in pyramid)
            return expert_fusion.expert_fusion_gather(xs, *args)
        return expert_fusion.expert_fusion_gather_reference(
            tuple(pyramid), *args, dtype=dt)


def topk_routing(router_probs: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, K] router probs → ([B, 1] expert ids int32, [B, 1] combine
    weights, the top probability renormalized: exactly 1.0).

    Top-1 takes the first maximum (``argmax``), so ties go to the lower
    index as in ``jax.lax.top_k``. k > 1 is not ported yet."""
    if k != 1:
        raise NotImplementedError(f"top-{k} routing is not ported yet; "
                                  f"use router_top_k=1")
    idx = torch.argmax(router_probs, dim=-1, keepdim=True)
    vals = torch.gather(router_probs, -1, idx)
    weights = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    return idx.to(torch.int32), weights.float()


class MoE(nn.Module):
    """Router + expert bank. Returns (global_feat, local_feat,
    router_probs) like the reference MoE.forward (swin.py:94-117):
      global_feat  [B, D]        mean over patches
      local_feat   [B, D, H, W]  H = W = sqrt(P) (56 for Swin-T @224)
      router_probs [B, K]        softmax(router logits) — the reference
                                 calls them 'router_logits'.
    """

    def __init__(self, config: MoEConfig):
        super().__init__()
        cfg = config
        if cfg.mode != "gather" or cfg.top_k != 1:
            raise NotImplementedError(
                f"moe mode {cfg.mode!r} with top_k={cfg.top_k} is not "
                f"ported yet; use 'gather' with top_k=1")
        self.config = cfg
        self.router_fc1 = Dense(cfg.router_input_dim, cfg.router_hidden_dim,
                                dtype=torch.float32)
        self.router_fc2 = Dense(cfg.router_hidden_dim, cfg.num_experts,
                                dtype=torch.float32)
        self.experts = ExpertBank(cfg)

    def forward(self, pyramid: Sequence[torch.Tensor],
                router_feat: torch.Tensor):
        x = torch.relu(self.router_fc1(router_feat.float()))
        router_probs = torch.softmax(self.router_fc2(x), dim=-1)   # [B, K]
        top_idx, _ = topk_routing(router_probs, 1)
        fused = self.experts.apply_gathered(pyramid, top_idx)
        b, p, d = fused.shape
        hw = int(round(p ** 0.5))
        global_feat = fused.mean(dim=1)                             # [B, D]
        local_feat = fused.permute(0, 2, 1).reshape(b, d, hw, hw)
        return global_feat, local_feat, router_probs
