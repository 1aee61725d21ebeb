"""Modality-routed Mixture-of-Experts multi-scale fusion (counterpart of
medmoe_tpu/models/moe.py).

  * ``Expert``: per-scale 1×1 projection (+ReLU) to a common dim, linear
    interpolation of every scale to the largest patch count, cross-scale
    attention (MLP → softmax over scales), weighted sum (reference
    src/models/components/swin.py:32-80).
  * Routing: router MLP(768→128→K) on the mean-pooled final hidden state,
    softmax, top-k (reference swin.py:94-108), the combine weights the
    top-k probabilities renormalized (exactly 1.0 at k = 1).
  * Modes (``MoEConfig.mode``):
      - ``gather``: only each sample's selected experts, one expert-branch
        pass per slot, weighted sum — at k = 1 the reference's
        all-experts-then-select at 1/K the work;
      - ``dense``: every expert on every sample, contracted with a [B, K]
        combine matrix;
      - ``topk``: capacity dispatch (GShard): each (sample, slot) lands in
        a [K, C] slot table, the experts run grouped over it, assignments
        past an expert's capacity are dropped;
      - ``ep``: ``topk`` (the JAX package runs both through
        ``apply_dispatched``; the bank's sharding is the trainer's).

Under a process group the batch is the ranks' rows of a global batch, as
JAX's batch is sharded over ``data``: top-k capacity and positions are
the global batch's (``apply_dispatched``). With the expert axis of the
grid above 1 (``parallel/mesh.py``) each bank holds K/e experts
(``ExpertBank.shard``), and the e ranks of an expert group hold the same
rows:

  * ``topk``/``ep`` and ``dense`` compute the dispatch and combine for all
    K, keep this rank's experts, run them, and sum the partial outputs
    over the expert group (``leave_experts``); the pyramid and the combine
    weights enter through ``enter_experts``, whose backward sums their
    gradient over the group;
  * ``gather`` all-gathers the bank (``gather_experts``) and runs K1/K2 on
    it as in one process.

The gather mode's expert branch is ``ops/expert_fusion.py``: in bfloat16
the autograd Function ``FusedExpertGather`` (hand-written CUDA kernels for
the forward, K1, and the backward, K2, on a card; the plain version and
autograd through it on the CPU), the plain PyTorch version in float32 (the
numerics-debug setting). ``dense`` and ``topk`` are grouped products in
PyTorch, with the JAX package's rounding points: biases rounded to the
compute dtype, products of compute-dtype values summed in float32, and the
fused map kept float32 in every mode.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from medmoe_torch.models.layers import Dense
from medmoe_torch.ops import expert_fusion
from medmoe_torch.parallel import collectives as C
from medmoe_torch.parallel.mesh import Grid, get_grid
from medmoe_torch.utils import trace


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 6
    hidden_dims: Tuple[int, ...] = (96, 192, 384, 768)
    output_dim: int = 768
    router_input_dim: int = 768
    router_hidden_dim: int = 128
    mode: str = "gather"
    top_k: int = 1
    capacity_factor: float = 1.25
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
        #: the grid whose expert axis this bank is sharded over (None: all
        #: K experts here)
        self.grid: Optional[Grid] = None

    def shard(self, grid: Grid) -> None:
        """Keep only this rank's K/e experts of ``grid``'s expert axis (the
        whole bank is initialized first, so every rank cuts the same
        weights). Raises ValueError when e does not divide K."""
        from medmoe_torch.parallel.sharding import expert_slice

        if self.grid is not None:
            raise RuntimeError("the expert bank is already sharded")
        sl = expert_slice(self.config.num_experts, grid.expert_index,
                          grid.expert)
        for name, p in list(self.named_parameters(recurse=False)):
            setattr(self, name, nn.Parameter(p.detach()[sl].clone(),
                                             requires_grad=p.requires_grad))
        self.grid = grid

    @property
    def local_experts(self) -> slice:
        """The experts this bank holds, as a slice of all K."""
        from medmoe_torch.parallel.sharding import expert_slice

        grid = self.grid or Grid()
        return expert_slice(self.config.num_experts, grid.expert_index,
                            grid.expert)

    def _enter(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.grid is None else C.enter_experts(
            x, self.grid.expert_group)

    def _leave(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.grid is None else C.leave_experts(
            x, self.grid.expert_group)

    def _whole_bank(self):
        """(proj_w, proj_b, w1, b1, w2, b2) over all K experts: the
        parameters, or under a sharded bank their all-gather over the
        expert group."""
        n = len(self.config.hidden_dims)
        params = (*self.proj_w, *self.proj_b, self.attn_w1, self.attn_b1,
                  self.attn_w2, self.attn_b2)
        if self.grid is not None:
            params = tuple(C.gather_experts(p, self.grid.expert_group)
                           for p in params)
        return (params[:n], params[n:2 * n]) + params[2 * n:]

    @property
    def proj_w(self):
        return tuple(getattr(self, f"proj_w{s}")
                     for s in range(len(self.config.hidden_dims)))

    @property
    def proj_b(self):
        return tuple(getattr(self, f"proj_b{s}")
                     for s in range(len(self.config.hidden_dims)))

    def apply_gathered(self, pyramid: Sequence[torch.Tensor],
                       expert_idx: torch.Tensor,
                       weights: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """expert_idx [B] (top-1) or [B, k] with combine ``weights`` [B, k]
        → the weighted sum of the slots' gathered-expert maps [B, P, E]
        float32. One slot (k = 1) has combine weight exactly 1.0 and is
        returned unscaled."""
        bank = self._whole_bank()
        if expert_idx.ndim == 1:
            return self._gather_one(pyramid, expert_idx, bank)
        k = expert_idx.shape[1]
        if k == 1:
            return self._gather_one(pyramid, expert_idx[:, 0], bank)
        if weights is None:
            raise ValueError(
                f"apply_gathered: expert_idx has k={k} slots; pass the "
                f"[B, k] combine weights from topk_routing")
        out = None
        for j in range(k):
            slot = self._gather_one(pyramid, expert_idx[:, j], bank)
            slot = slot * weights[:, j, None, None].to(slot.dtype)
            out = slot if out is None else out + slot
        return out

    def _gather_one(self, pyramid: Sequence[torch.Tensor],
                    expert_idx: torch.Tensor, bank) -> torch.Tensor:
        """pyramid[s]: [B, P_s, D_s]; expert_idx: [B]; ``bank`` the whole
        bank (``_whole_bank``) → [B, P, E] f32.

        bfloat16 runs ``FusedExpertGather`` (kernels K1/K2 on CUDA
        tensors, the plain version and autograd through it on CPU
        tensors); float32 — the numerics-debug setting — runs the plain
        version in float32, as the JAX package's ``use_fused_expert``
        sends float32 to its XLA path."""
        dt = self.config.dtype
        p_list = [f.shape[1] for f in pyramid]
        args = (*bank, expert_idx.to(torch.int32).contiguous())
        if expert_fusion.use_fused_expert(p_list, max(p_list), dt):
            xs = tuple(f.to(dt).contiguous() for f in pyramid)
            wp, bp, w1, b1, w2, b2, idx = args
            return expert_fusion.FusedExpertGather.apply(
                idx, w1, b1, w2, b2, *xs, *wp, *bp)
        return expert_fusion.expert_fusion_gather_reference(
            tuple(pyramid), *args, dtype=dt)


    def _rounded(self, param: torch.Tensor) -> torch.Tensor:
        """``param`` rounded to the compute dtype, as float32."""
        return param.to(self.config.dtype).float()

    def _grouped(self, xs: Sequence[torch.Tensor], eq_proj: str,
                 eq_attn: str, eq_logit: str) -> torch.Tensor:
        """The expert branch over every expert's rows: ``xs[s]`` [..., P_s,
        D_s] of compute-dtype values (the rows of each expert's slots, or
        every sample) → the fused maps [K, N, P, E] float32. ``eq_proj``
        contracts a scale with the stacked projections to [K, N, P_s, E];
        ``eq_attn`` and ``eq_logit`` the attention MLP."""
        dt = self.config.dtype
        p_max = max(x.shape[-2] for x in xs)
        scale_feats = []
        for s, x in enumerate(xs):
            h = torch.einsum(eq_proj, x.float(), self._rounded(self.proj_w[s]))
            h = torch.relu(h + self._rounded(self.proj_b[s])[:, None, None, :])
            scale_feats.append(interp_patches(h.to(dt), p_max, dim=2))
        logits = []
        for h in scale_feats:
            a = torch.einsum(eq_attn, h.float(), self._rounded(self.attn_w1))
            a = torch.relu(a + self._rounded(self.attn_b1)[:, None, None, :])
            l = torch.einsum(eq_logit, a.to(dt).float(),
                             self._rounded(self.attn_w2))
            logits.append(l[..., 0] + self._rounded(self.attn_b2)[:, None,
                                                                  None, 0])
        attn = torch.softmax(torch.stack(logits, dim=-1), dim=-1).to(dt)
        fused = None
        for s, h in enumerate(scale_feats):
            term = h.float() * attn[..., s, None].float()
            fused = term if fused is None else fused + term
        return fused

    def apply_dispatched(self, pyramid: Sequence[torch.Tensor],
                         expert_idx: torch.Tensor, capacity_factor: float,
                         weights: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """Capacity dispatch (``topk`` mode): every (sample, slot)
        assignment lands in a [K, C] slot table, C = ceil(B·k·factor / K);
        the experts run grouped over their slots; each slot's output is
        scaled by its combine weight and summed back per sample.
        Assignments past an expert's capacity contribute zero.

        Under a process group the B rows are this rank's of the global
        batch, its d data ranks' rows in rank order (JAX's batch sharded
        over ``data``): C comes from B·d, and each position is offset by
        the earlier data ranks' assignments to the same expert (their
        counts all-gathered over the data group), so the kept assignments
        are the global batch's. A rank's slot grid stays [K, C]: it may
        hold up to C of one expert's kept assignments.

        expert_idx [B] (top-1) or [B, k]; weights the matching combine
        weights (None: 1.0 a slot). → [B, P, E] float32."""
        dt = self.config.dtype
        k = self.config.num_experts
        if expert_idx.ndim == 1:
            expert_idx = expert_idx[:, None]
        b, k_slots = expert_idx.shape
        if weights is None:
            weights = torch.ones((b, k_slots), dtype=torch.float32,
                                 device=expert_idx.device)
        grid = self.grid or get_grid()
        capacity = max(1, int(np.ceil(b * grid.data * k_slots
                                      * capacity_factor / k)))
        offsets = None
        if grid.data > 1:
            counts = torch.bincount(expert_idx.reshape(-1).long(),
                                    minlength=k)               # [K]
            counts = C.all_gather_stack(counts, grid.data_group)  # [d, K]
            offsets = counts[:grid.data_index].sum(dim=0)
        local = self.local_experts
        with trace.span("medmoe#moe.dispatch"):
            dispatch, combine = make_dispatch_tensors(
                expert_idx, self._enter(weights), k, capacity, offsets)
            if trace.enabled():
                trace.count("moe.assignments", b * k_slots)
                trace.count("moe.slots", k * capacity)
                trace.count("moe.kept", dispatch.sum())
            disp = dispatch[local].to(dt).float()
            xs = [torch.einsum("kcb,bpd->kcpd", disp,
                               self._enter(f).to(dt).float()).to(dt)
                  for f in pyramid]
        with trace.span("medmoe#moe.grouped"):
            fused = self._grouped(xs, "kcpd,kde->kcpe", "kcpe,keh->kcph",
                                  "kcph,kho->kcpo")          # [K, C, P, E]
        with trace.span("medmoe#moe.combine"):
            return self._leave(torch.einsum("kcb,kcpe->bpe", combine[local],
                                            fused))

    def apply_dense(self, pyramid: Sequence[torch.Tensor],
                    combine: torch.Tensor) -> torch.Tensor:
        """Every expert on every sample (``dense`` mode), the expert axis
        contracted with the [B, K] ``combine`` matrix (one-hot rows at top-1,
        the reference's all-then-select; renormalized top-k probabilities
        otherwise). → [B, P, E] float32."""
        dt = self.config.dtype
        xs = [self._enter(f).to(dt) for f in pyramid]
        combine = self._enter(combine.float())[:, self.local_experts]
        fused = self._grouped(xs, "bpd,kde->kbpe", "kbpe,keh->kbph",
                              "kbph,kho->kbpo")              # [K, B, P, E]
        return self._leave(torch.einsum("bk,kbpe->bpe", combine, fused))


def topk_routing(router_probs: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, K] router probs → ([B, k] expert ids int32, [B, k] combine
    weights float32: the top-k probabilities renormalized to sum to 1; one
    probability renormalizes to exactly 1.0).

    The experts come in descending order of probability, and equal
    probabilities in ascending expert order, as ``jax.lax.top_k`` gives
    them (a stable sort)."""
    if not 1 <= k <= router_probs.shape[-1]:
        raise ValueError(f"top-{k} routing over {router_probs.shape[-1]} "
                         f"experts")
    _, order = torch.sort(router_probs, dim=-1, descending=True, stable=True)
    idx = order[..., :k]
    vals = torch.gather(router_probs, -1, idx)
    weights = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    return idx.to(torch.int32), weights.float()


def make_dispatch_tensors(expert_idx: torch.Tensor, weights: torch.Tensor,
                          num_experts: int, capacity: int,
                          offsets: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard-form dispatch and combine tensors.

    expert_idx [B, k], weights [B, k] →
      dispatch [K, C, B]: 1.0 where slot (e, c) holds sample b;
      combine  [K, C, B]: dispatch times the assignment's combine weight.

    An assignment's position in its expert is the count of earlier
    assignments to the same expert, sample-major over the flattened [B·k]
    list, plus ``offsets[e]`` (int [K]: the assignments to e that come
    before these rows, on earlier data ranks). Assignments at a position
    ≥ ``capacity`` are dropped from both."""
    b, k_slots = expert_idx.shape
    flat = expert_idx.reshape(-1).long()                           # [B·k]
    onehot = (flat[:, None] == torch.arange(
        num_experts, device=flat.device)[None, :]).to(torch.int64)
    position = torch.cumsum(onehot, dim=0) - onehot
    if offsets is not None:
        position = position + offsets.to(position)[None, :]
    pos = torch.sum(position * onehot, dim=1)                      # [B·k]
    kept = (pos < capacity).float()
    oh_e = onehot.float() * kept[:, None]
    oh_c = (torch.clamp(pos, max=capacity - 1)[:, None] == torch.arange(
        capacity, device=flat.device)[None, :]).float()
    assign = (oh_e[:, :, None] * oh_c[:, None, :]).reshape(
        b, k_slots, num_experts, capacity)
    dispatch = assign.sum(dim=1).permute(1, 2, 0)                  # [K, C, B]
    combine = torch.einsum("bjkc,bj->kcb", assign, weights.float())
    return dispatch, combine


class MoE(nn.Module):
    """Router + expert bank. Returns (global_feat, local_feat,
    router_probs) like the reference MoE.forward (swin.py:94-117):
      global_feat  [B, D]        mean over patches
      local_feat   [B, D, H, W]  H = W = sqrt(P) (56 for Swin-T @224)
      router_probs [B, K]        softmax(router logits) — the reference
                                 calls them 'router_logits'.
    """

    MODES = ("gather", "dense", "topk", "ep")

    def __init__(self, config: MoEConfig):
        super().__init__()
        cfg = config
        if cfg.mode not in self.MODES:
            raise ValueError(f"unknown moe mode {cfg.mode!r}")
        if not 1 <= int(cfg.top_k) <= cfg.num_experts:
            raise ValueError(f"router top_k={cfg.top_k} with "
                             f"{cfg.num_experts} experts")
        self.config = cfg
        self.router_fc1 = Dense(cfg.router_input_dim, cfg.router_hidden_dim,
                                dtype=torch.float32)
        self.router_fc2 = Dense(cfg.router_hidden_dim, cfg.num_experts,
                                dtype=torch.float32)
        self.experts = ExpertBank(cfg)

    def forward(self, pyramid: Sequence[torch.Tensor],
                router_feat: torch.Tensor):
        cfg = self.config
        with trace.span("medmoe#moe.router"):
            x = torch.relu(self.router_fc1(router_feat.float()))
            router_probs = torch.softmax(self.router_fc2(x), dim=-1)  # [B, K]
            top_idx, top_w = topk_routing(router_probs, int(cfg.top_k))
            if trace.enabled():      # a comparison: bincount syncs the host
                trace.count("moe.images_per_expert", (
                    top_idx[:, :1].long() == torch.arange(
                        cfg.num_experts, device=top_idx.device)).sum(0))
        with trace.span("medmoe#moe.experts"):
            if cfg.mode == "gather":
                fused = self.experts.apply_gathered(pyramid, top_idx, top_w)
            elif cfg.mode == "dense":
                onehot = (top_idx.long()[..., None] == torch.arange(
                    cfg.num_experts, device=top_idx.device)).float()
                combine = torch.sum(onehot * top_w[..., None], dim=1)  # [B, K]
                fused = self.experts.apply_dense(pyramid, combine)
            else:
                fused = self.experts.apply_dispatched(
                    pyramid, top_idx, cfg.capacity_factor, top_w)
        b, p, d = fused.shape
        hw = int(round(p ** 0.5))
        global_feat = fused.mean(dim=1)                             # [B, D]
        local_feat = fused.permute(0, 2, 1).reshape(b, d, hw, hw)
        return global_feat, local_feat, router_probs
