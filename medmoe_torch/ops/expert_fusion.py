"""Fused MedMoE expert branch (gather mode): CUDA kernel wrapper, its plain
PyTorch version, and the launch counter.

What it computes (reference src/models/components/swin.py:11-80): for
each sample b with routed expert e = expert_idx[b] and each scale s,
  h_s = relu(x_s·Wp[e,s] + bp[e,s])      bf16 products, f32 sum, → bf16
  u_s = linear upsample of h_s to P      f32 lerp of bf16 values, → bf16
  a_s = relu(u_s·W1[e] + b1[e])          → bf16
  logit_s = a_s·w2[e]                    f32
then att = softmax over scales (f32, → bf16) and out = Σ_s att_s·u_s in f32.
Biases round through bf16 before they are added in f32. ``attn_b2`` adds
one constant to every scale's logit and cancels in the softmax, so the
kernel skips it.

Kernel note. ``csrc/expert_fusion.cu`` replaces the Pallas TPU kernel
``_fwd_kernel`` driven by ``_fwd_pallas`` in
medmoe_tpu/ops/pallas/expert_fusion.py. On the H100 it is bound by
operations: at B=32 and flagship shapes it does ≈265 GFLOP (≈0.87 GFLOP
of projections and ≈7.4 GFLOP of attention MLP per sample) against ≈344
MB of traffic, ≈0.27 ms of bf16 tensor-core time against ≈0.10 ms of
memory time. The design puts the attention MLP — 90% of the operations —
on the tensor cores (WMMA bf16 tiles, f32 accumulators) and keeps its
[P, H] activations out of device memory:

  1. a projection launch writes h_s for every scale to a bf16 scratch
     buffer [B, P_s, E] (≈205 MB at B=32), which the wrapper allocates;
  2. an attention launch runs one block per (sample, 64-row tile of P):
     for each scale it lerps the tile's u rows from h_s into shared memory
     (the TPU kernel's dense interpolation matrix existed only because
     Mosaic cannot gather), multiplies them by W1[e] streamed through
     shared memory in 32-row chunks, and folds relu(·+b1)·w2 into the
     logits without storing a; it then takes the softmax over scales,
     recomputes the u rows and writes ``out`` once.

Each block reads expert_idx[b] itself and offsets its weight pointers,
in place of the TPU kernel's scalar-prefetch index maps. A shared-memory
block holds one [64, E] tile, never a whole [P, E] map (the TPU kernel
kept every map of a sample in 100 MiB of VMEM).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

# kernel launches made by expert_fusion_gather (one per call on a CUDA
# tensor; the plain version for CPU tensors does not count)
LAUNCHES = 0

MAX_SCALES = 4          # csrc/expert_fusion.cu MAX_SCALES
MAX_HIDDEN = 384        # 8 warps × 16 columns × MAX_NF fragments
_SMEM_LIMIT = 232448    # bytes of shared memory a block may use (H100)


def expert_fusion_supported(p_list: Sequence[int], p_max: int) -> bool:
    """The fused path needs integer upsample ratios (the pyramid always
    has them: each Swin stage halves the grid)."""
    return all(p_max % p_s == 0 for p_s in p_list)


def use_fused_expert(p_list: Sequence[int], p_max: int,
                     dtype: torch.dtype) -> bool:
    """Same gate as medmoe_tpu's ``use_fused_expert``: the kernel is bf16
    by design, so a float32 model (the numerics-debug setting) takes the
    plain path, and non-integer ratios take it too."""
    return dtype == torch.bfloat16 and expert_fusion_supported(p_list, p_max)


def _attn_smem_bytes(e: int, h: int) -> int:
    """Dynamic shared memory of the attention launch (mirrors the .cu)."""
    def up(n):
        return (n + 127) // 128 * 128

    tile = up(max(64 * (e + 8) * 2, 64 * (h + 4) * 4))
    w1 = up(2 * 32 * (h + 8) * 2)
    return tile + w1 + MAX_SCALES * 64 * 4


def _check(xs, wp, bp, w1, b1, w2, b2, expert_idx) -> Tuple[int, ...]:
    """Raise on anything the kernel does not take; return (B, K, E, H, P)."""
    tensors = list(xs) + list(wp) + list(bp) + [w1, b1, w2, b2, expert_idx]
    if not all(isinstance(t, torch.Tensor) for t in tensors):
        raise TypeError("expert_fusion_gather takes torch tensors")
    device = expert_idx.device
    if any(t.device != device for t in tensors):
        raise ValueError("expert_fusion_gather: all inputs must be on one "
                         f"device, got {sorted({str(t.device) for t in tensors})}")
    n = len(xs)
    if not (1 <= n <= MAX_SCALES) or len(wp) != n or len(bp) != n:
        raise ValueError(f"expert_fusion_gather takes 1..{MAX_SCALES} scales "
                         f"with one proj weight and bias each, got "
                         f"{len(xs)}/{len(wp)}/{len(bp)}")
    if any(x.dtype != torch.bfloat16 for x in xs):
        raise TypeError("expert_fusion_gather: the pyramid must be bfloat16, "
                        f"got {[x.dtype for x in xs]}")
    params = list(wp) + list(bp) + [w1, b1, w2, b2]
    if any(p.dtype != torch.float32 for p in params):
        raise TypeError("expert_fusion_gather: expert parameters must be "
                        "float32 (they round to bf16 on entry)")
    if expert_idx.dtype not in (torch.int32, torch.int64) \
            or expert_idx.ndim != 1:
        raise TypeError("expert_fusion_gather: expert_idx must be a [B] "
                        "int32/int64 tensor")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("expert_fusion_gather: inputs must be contiguous")
    if w1.ndim != 3:
        raise ValueError(f"attn_w1 must be [K, E, H], got {tuple(w1.shape)}")
    k, e, h = w1.shape
    b = expert_idx.shape[0]
    p = max(x.shape[1] for x in xs)
    for s, (x, w, bias) in enumerate(zip(xs, wp, bp)):
        if x.ndim != 3 or x.shape[0] != b:
            raise ValueError(f"pyramid[{s}] must be [B={b}, P_s, D_s], got "
                             f"{tuple(x.shape)}")
        if tuple(w.shape) != (k, x.shape[2], e):
            raise ValueError(f"proj_w{s} must be [{k}, {x.shape[2]}, {e}], "
                             f"got {tuple(w.shape)}")
        if tuple(bias.shape) != (k, e):
            raise ValueError(f"proj_b{s} must be [{k}, {e}], got "
                             f"{tuple(bias.shape)}")
        if x.shape[2] % 8:
            raise ValueError(f"pyramid[{s}] width {x.shape[2]} is not a "
                             f"multiple of 8")
    if (tuple(b1.shape), tuple(w2.shape), tuple(b2.shape)) != \
            ((k, h), (k, h, 1), (k, 1)):
        raise ValueError("attention parameters must be attn_b1 [K, H], "
                         "attn_w2 [K, H, 1], attn_b2 [K, 1]")
    if not expert_fusion_supported([x.shape[1] for x in xs], p):
        raise ValueError("expert_fusion_gather needs integer upsample "
                         f"ratios, got P_s={[x.shape[1] for x in xs]}")
    if e % 32 or h % 16 or h > MAX_HIDDEN:
        raise ValueError(f"expert_fusion_gather takes E % 32 == 0 and "
                         f"H % 16 == 0 with H <= {MAX_HIDDEN}; got E={e}, "
                         f"H={h}")
    if _attn_smem_bytes(e, h) > _SMEM_LIMIT:
        raise ValueError(f"E={e} needs more shared memory than a block has")
    return b, k, e, h, p


def expert_fusion_gather(xs: Sequence[torch.Tensor],
                         wp: Sequence[torch.Tensor],
                         bp: Sequence[torch.Tensor],
                         w1: torch.Tensor, b1: torch.Tensor,
                         w2: torch.Tensor, b2: torch.Tensor,
                         expert_idx: torch.Tensor) -> torch.Tensor:
    """Fused gather-mode expert branch: pyramid (tuple of [B, P_s, D_s]
    bf16) + stacked float32 expert parameters + per-sample expert ids
    → fused [B, P, E] float32 map.

    CUDA tensors launch the kernel (or raise); CPU tensors run the plain
    version. A CUDA sample whose expert id is out of range gets a NaN
    output row block instead of a host sync to check the ids."""
    global LAUNCHES
    b, k, e, h, p = _check(xs, wp, bp, w1, b1, w2, b2, expert_idx)
    if expert_idx.device.type == "cpu":
        if b and (int(expert_idx.min()) < 0 or int(expert_idx.max()) >= k):
            raise IndexError(f"expert_idx out of range [0, {k})")
        return expert_fusion_gather_reference(xs, wp, bp, w1, b1, w2, b2,
                                              expert_idx)
    if expert_idx.device.type != "cuda":
        raise ValueError("expert_fusion_gather runs on CUDA or CPU tensors, "
                         f"got {expert_idx.device}")
    out = torch.empty((b, p, e), dtype=torch.float32, device=xs[0].device)
    if b == 0:
        return out
    from medmoe_torch.ops import _build

    lib = _build.load("expert_fusion")
    bf = torch.bfloat16
    # parameters round through bf16 on entry, as the JAX wrapper does
    wp_k = [w.to(bf).contiguous() for w in wp]
    bp_k = [x.to(bf).float().contiguous() for x in bp]
    w1_k = w1.to(bf).contiguous()
    b1_k = b1.to(bf).float().contiguous()
    w2_k = w2.reshape(k, h).to(bf).float().contiguous()
    idx_k = expert_idx.to(torch.int32).contiguous()
    hs = [torch.empty((b, x.shape[1], e), dtype=bf, device=x.device)
          for x in xs]
    n = len(xs)
    ptrs = ctypes.c_void_p * MAX_SCALES
    ints = ctypes.c_int * MAX_SCALES

    def arr(ts):
        return ptrs(*[t.data_ptr() for t in ts])

    with torch.cuda.device(xs[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.medmoe_expert_fusion_fwd(
            n, arr(xs), arr(wp_k), arr(bp_k), arr(hs),
            ints(*[x.shape[1] for x in xs]), ints(*[x.shape[2] for x in xs]),
            w1_k.data_ptr(), b1_k.data_ptr(), w2_k.data_ptr(),
            idx_k.data_ptr(), out.data_ptr(), b, k, e, h, p, stream)
    if rc != 0:
        raise RuntimeError("expert_fusion kernel launch failed: "
                           + lib.medmoe_cuda_error_string(rc).decode())
    LAUNCHES += 1
    return out


def expert_fusion_gather_reference(xs: Sequence[torch.Tensor],
                                   wp: Sequence[torch.Tensor],
                                   bp: Sequence[torch.Tensor],
                                   w1: torch.Tensor, b1: torch.Tensor,
                                   w2: torch.Tensor, b2: torch.Tensor,
                                   expert_idx: torch.Tensor,
                                   dtype: torch.dtype = torch.bfloat16
                                   ) -> torch.Tensor:
    """Plain PyTorch version with the rounding points of the JAX package's
    ``ExpertBank._gather_one`` (medmoe_tpu/models/moe.py:246-289): every
    parameter is picked per sample and rounded to ``dtype``; products take
    ``dtype`` inputs and sum in float32. Returns [B, P, E] float32."""
    from medmoe_torch.models.moe import interp_patches

    dt = dtype
    idx = expert_idx.long()
    p_max = max(x.shape[1] for x in xs)

    def sel(param):                       # [K, ...] → per-sample [B, ...]
        return param[idx].to(dt).float()

    scale_feats = []
    for s, feats in enumerate(xs):
        h = torch.bmm(feats.to(dt).float(), sel(wp[s]))
        h = torch.relu(h + sel(bp[s])[:, None, :]).to(dt)
        scale_feats.append(interp_patches(h, p_max, dim=1))

    w1s, b1s, w2s, b2s = sel(w1), sel(b1), sel(w2), sel(b2)
    logits = []
    for u in scale_feats:
        a = torch.bmm(u.float(), w1s)
        a = torch.relu(a + b1s[:, None, :]).to(dt)
        l = torch.bmm(a.float(), w2s)                       # [B, P, 1]
        logits.append(l[..., 0] + b2s[:, :1])
    att = torch.softmax(torch.stack(logits, dim=-1), dim=-1).to(dt)
    out = None
    for s, u in enumerate(scale_feats):
        term = u.float() * att[:, :, s, None].float()
        out = term if out is None else out + term
    return out
