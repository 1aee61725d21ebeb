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

Kernel note. ``csrc/expert_fusion.cu`` (K1) replaces the Pallas TPU
kernel ``_fwd_kernel`` driven by ``_fwd_pallas`` in
medmoe_tpu/ops/pallas/expert_fusion.py. On the H100 it is bound by
operations: at B=32 and flagship shapes it does ≈265 GFLOP (≈0.87 GFLOP
of projections and ≈7.4 GFLOP of attention MLP per sample) against ≈344
MB of traffic, ≈0.27 ms of bf16 tensor-core time against ≈0.10 ms of
memory time. It runs four passes over chunks of images
(``fwd_image_chunk``: as many as fit in the scratch budget, 80 flagship
images), the attention MLP — 90% of the operations — on the GEMM core of
``csrc/gemm_core.cuh``:

  1. a projection pass writes h_s for every scale to a bf16 scratch;
  2. a streaming pass writes u_s = bf16(lerp(h_s)) for each scale with
     P_s < P (the TPU kernel's dense interpolation matrix existed only
     because Mosaic cannot gather);
  3. a product u_s·W1 per scale whose epilogue folds bf16(relu(·+b1))·w2
     into each 128-wide tile's partial logits, never storing a_s;
  4. a streaming pass sums the partial logits in tile order, takes the
     softmax over scales and writes ``out`` = Σ_s att_s·u_s once.

Passes 2 and 3 are the backward's first two passes without d_att and a_s
(``csrc/expert_fusion_passes.cuh``), so K2 differentiates the forward K1
took. Each block reads expert_idx[b] itself and offsets its weight
pointers, in place of the TPU kernel's scalar-prefetch index maps; no
block holds a whole [P, E] map (the TPU kernel kept every map of a sample
in 100 MiB of VMEM).

The backward (K2, ``csrc/expert_fusion_bwd.cu``) replaces the Pallas
``_bwd_kernel`` driven by ``_bwd_pallas``. ``expert_fusion_gather_bwd``
recomputes h_s with K1's projection launch (the TPU kernel recomputes its
forward chain too, so nothing but the inputs is kept between forward and
backward), runs K2, and returns d_x_s and the per-sample parameter
gradients; ``FusedExpertGather`` scatters those into the expert bank with
``index_add_``, as the JAX package's one-hot einsum does (``_fe_bwd``).
``attn_b2`` gets an exact zero gradient.

K2 is bound by operations: five products of ≈7.4 GFLOP a flagship sample
for the a recompute, d_u and dW1, ≈0.87 for d_x and dWp. It runs them as
dense tile products on the shared GEMM core (``csrc/gemm_core.cuh``),
every operand a bf16 scratch read with 16-byte copies, between streaming
passes that are bound by bytes (O(P·E) bf16 a sample and scale):

  1. u_s = bf16(lerp(h_s)) and d_att_s = Σ_E d_out·u_s, d_out read once;
  2. a_s = bf16(relu(u_s·W1 + b1)) with each N tile's partial logits;
  3. the row step: softmax over scales and its backward, bf16(dz_a);
  4. d_u = att·d_out + bf16(dz_a)·W1ᵀ, written as bf16(d_u) (what Gᵀ
     reads), or, at the identity scale, masked into bf16(dz_h_0);
  5. the transposed upsample Gᵀ·bf16(d_u), banded: each source row sums
     its ≤ 2r + 1 destination rows in increasing order, from the table of
     ``transposed_lerp_plan``; the mask h_s > 0 gives bf16(dz_h_s);
  6. d_x = bf16(dz_h)·Wpᵀ;
  7. dW1 = Σ_s u_sᵀ·bf16(dz_a) and dWp_s = x_sᵀ·bf16(dz_h_s);
  8. the per-tile partial sums of db1, dw2 and dbp, in tile order.

No atomics: two calls give the same bits. The scratch (≈52 MB a flagship
image, ``bwd_scratch_bytes``) lives in chunks of images
(``bwd_image_chunk``); the single-pass design it replaces held an f32
d_u of 38.5 MB an image for the whole batch (9.87 GB at B=256).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from medmoe_torch.ops._scratch import images_in_budget

# kernel launches made by expert_fusion_gather (K1) and
# expert_fusion_gather_bwd (K2): one per call on CUDA tensors; the plain
# versions for CPU tensors do not count
LAUNCHES = 0
BWD_LAUNCHES = 0

MAX_SCALES = 4          # csrc/expert_fusion_passes.cuh MAX_SCALES
MAX_HIDDEN = 2048       # K2's row step: a thread for each 8 columns of H
# the tiles that size the kernels' partial sums (their C entries reject
# scratch that holds fewer): the products' 128-wide tiles (K1's and K2's
# partial logits), K2's row step's ROW_TM rows of P and its transposed
# upsample's T_ROWS source rows
_TM, _BWD_ROW_TM, _BWD_T_ROWS = 128, 64, 8


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


def check_kernel_limits(e: int, h: int, d_list: Sequence[int]) -> None:
    """Raise ValueError unless the expert-branch kernels K1 (forward) and
    K2 (backward) both take expert width E, attention hidden width H and
    pyramid widths D_s: 1..4 scales, D_s % 8 == 0 (16-byte rows of x),
    E % 32 == 0 (K1's projection pass; K2 takes E % 8), H % 8 == 0 (16-byte
    rows of a_s and W1) and 8 <= H <= 2048 (K2's row step takes a thread for
    each 8 columns of H). Shapes only, so a trainer calls it before the
    first step and K1's wrapper before its launch: a forward that K2 cannot
    differentiate never starts."""
    d_list = list(d_list)
    if not 1 <= len(d_list) <= MAX_SCALES or any(d % 8 for d in d_list):
        raise ValueError(f"the expert-branch kernels take 1..{MAX_SCALES} "
                         f"pyramid widths, each a multiple of 8; got {d_list}")
    if e % 32 or h % 8 or not 8 <= h <= MAX_HIDDEN:
        raise ValueError(f"the expert-branch kernels take E % 32 == 0 and "
                         f"H % 8 == 0 with 8 <= H <= {MAX_HIDDEN}; got E={e}, "
                         f"H={h}")


def _check(xs, wp, bp, w1, b1, w2, b2, expert_idx) -> Tuple[int, ...]:
    """Raise on anything the kernels do not take (``b2`` None for the
    backward, which does not read it); return (B, K, E, H, P)."""
    b2_list = [] if b2 is None else [b2]
    tensors = list(xs) + list(wp) + list(bp) + [w1, b1, w2] + b2_list \
        + [expert_idx]
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
    params = list(wp) + list(bp) + [w1, b1, w2] + b2_list
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
    if (tuple(b1.shape), tuple(w2.shape), tuple(b2.shape)
            if b2 is not None else (k, 1)) != ((k, h), (k, h, 1), (k, 1)):
        raise ValueError("attention parameters must be attn_b1 [K, H], "
                         "attn_w2 [K, H, 1], attn_b2 [K, 1]")
    if not expert_fusion_supported([x.shape[1] for x in xs], p):
        raise ValueError("expert_fusion_gather needs integer upsample "
                         f"ratios, got P_s={[x.shape[1] for x in xs]}")
    check_kernel_limits(e, h, [x.shape[2] for x in xs])
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

    CUDA tensors launch the kernel over chunks of images (or raise); CPU
    tensors run the plain version. A CUDA sample whose expert id is out of
    range gets a NaN output instead of a host sync to check the ids."""
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
    dev = xs[0].device
    wp_k, bp_k, w1_k, b1_k, w2_k, idx_k = _kernel_params(
        wp, bp, w1, b1, w2, k, h, expert_idx)
    n = len(xs)
    p_s = [x.shape[1] for x in xs]
    # scratch for one chunk of images (fwd_scratch_bytes; ≈21 MB a flagship
    # image): h_s, u_s (P_s < P only) and the partial logits
    nc, _ = fwd_image_chunk(b, p_s, e, h)
    tiles = -(-h // _TM)
    hs = [torch.empty((nc, q, e), dtype=torch.bfloat16, device=dev)
          for q in p_s]
    us = [torch.empty((nc, p, e), dtype=torch.bfloat16, device=dev)
          if q != p else None for q in p_s]
    lpart = torch.empty((nc, n, tiles, p), dtype=torch.float32, device=dev)
    ptrs = ctypes.c_void_p * MAX_SCALES
    ints = ctypes.c_int * MAX_SCALES

    def arr(ts, c0=0):            # pointers to image c0 of each tensor
        return ptrs(*[None if t is None else t[c0:].data_ptr() for t in ts])

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for c0 in range(0, b, nc):
            rc = lib.medmoe_expert_fusion_fwd(
                n, arr(xs, c0), arr(wp_k), arr(bp_k), arr(hs), arr(us),
                ints(*p_s), ints(*[x.shape[2] for x in xs]),
                w1_k.data_ptr(), b1_k.data_ptr(), w2_k.data_ptr(),
                idx_k[c0:].data_ptr(), lpart.data_ptr(), tiles,
                out[c0:].data_ptr(), min(b, c0 + nc) - c0, k, e, h, p, stream)
            if rc:
                break
    if rc != 0:
        raise RuntimeError("expert_fusion kernel launch failed: "
                           + lib.medmoe_cuda_error_string(rc).decode())
    LAUNCHES += 1
    return out


@torch.library.custom_op("medmoe::expert_fusion_gather", mutates_args=())
def expert_fusion_gather_op(xs: List[torch.Tensor], wp: List[torch.Tensor],
                            bp: List[torch.Tensor], w1: torch.Tensor,
                            b1: torch.Tensor, w2: torch.Tensor,
                            b2: torch.Tensor,
                            expert_idx: torch.Tensor) -> torch.Tensor:
    """``expert_fusion_gather`` as a registered op, the one entry to K1 for
    training, serving and the exported graph: on CUDA tensors it launches
    K1 (or raises), on CPU tensors it runs the plain version. The pointer
    arrays and the CPU range check stay inside the op, out of any graph
    that ``torch.export`` traces."""
    return expert_fusion_gather(xs, wp, bp, w1, b1, w2, b2, expert_idx)


@expert_fusion_gather_op.register_fake
def _expert_fusion_gather_fake(xs, wp, bp, w1, b1, w2, b2, expert_idx):
    p = max(x.shape[1] for x in xs)
    return xs[0].new_empty((expert_idx.shape[0], p, w1.shape[1]),
                           dtype=torch.float32)


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


def _kernel_params(wp, bp, w1, b1, w2, k, h, expert_idx):
    """Parameters as the kernels take them: rounded through bf16 on entry,
    biases as bf16 values in float32, as the JAX wrapper passes them."""
    bf = torch.bfloat16
    return ([w.to(bf).contiguous() for w in wp],
            [x.to(bf).float().contiguous() for x in bp],
            w1.to(bf).contiguous(), b1.to(bf).float().contiguous(),
            w2.reshape(k, h).to(bf).float().contiguous(),
            expert_idx.to(torch.int32).contiguous())


def expert_fusion_gather_bwd(xs: Sequence[torch.Tensor],
                             wp: Sequence[torch.Tensor],
                             bp: Sequence[torch.Tensor],
                             w1: torch.Tensor, b1: torch.Tensor,
                             w2: torch.Tensor, expert_idx: torch.Tensor,
                             d_out: torch.Tensor):
    """Backward of the fused expert branch for the cotangent ``d_out``
    [B, P, E] float32. Returns ``(d_xs, d_wp, d_bp, d_w1, d_b1, d_w2)``:
    d_xs like the pyramid, and per-sample float32 parameter gradients
    d_wp[s] [B, D_s, E], d_bp[s] [B, E], d_w1 [B, E, H], d_b1 [B, H],
    d_w2 [B, H] (attn_b2's gradient is exactly zero).

    CUDA tensors run K1's projection pass and K2 (or raise); CPU tensors
    run the plain version. A CUDA sample whose expert id is out of range
    gets NaN in all of its outputs."""
    global BWD_LAUNCHES
    b, k, e, h, p = _check(xs, wp, bp, w1, b1, w2, None, expert_idx)
    if not isinstance(d_out, torch.Tensor) or d_out.dtype != torch.float32 \
            or tuple(d_out.shape) != (b, p, e) or not d_out.is_contiguous() \
            or d_out.device != expert_idx.device:
        raise ValueError(f"d_out must be a contiguous float32 [{b}, {p}, {e}] "
                         f"tensor on {expert_idx.device}")
    if expert_idx.device.type == "cpu":
        if b and (int(expert_idx.min()) < 0 or int(expert_idx.max()) >= k):
            raise IndexError(f"expert_idx out of range [0, {k})")
        return expert_fusion_gather_bwd_reference(xs, wp, bp, w1, b1, w2,
                                                  expert_idx, d_out)
    if expert_idx.device.type != "cuda":
        raise ValueError("expert_fusion_gather_bwd runs on CUDA or CPU "
                         f"tensors, got {expert_idx.device}")
    dev = xs[0].device
    n = len(xs)
    p_s = [x.shape[1] for x in xs]
    d_s = [x.shape[2] for x in xs]

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    def bf16(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device=dev)

    d_xs = [torch.empty_like(x) for x in xs]
    d_wp = [f32(b, d, e) for d in d_s]
    d_bp = [f32(b, e) for _ in xs]
    d_w1, d_b1, d_w2 = f32(b, e, h), f32(b, h), f32(b, h)
    if b == 0:
        return tuple(d_xs), tuple(d_wp), tuple(d_bp), d_w1, d_b1, d_w2
    from medmoe_torch.ops import _build

    lib_fwd = _build.load("expert_fusion")
    lib = _build.load("expert_fusion_bwd")
    wp_k, bp_k, w1_k, b1_k, w2_k, idx_k = _kernel_params(
        wp, bp, w1, b1, w2, k, h, expert_idx)
    # scratch for one chunk of images (bwd_scratch_bytes; ≈52 MB a flagship
    # image, chunks of at most 1.7 GB, against the 9.87 GB of f32 d_u alone
    # that the single-pass design held at B=256): recomputed h_s, u_s and
    # bf16(d_u_s) (P_s < P only), a_s then bf16(dz_a_s), bf16(dz_h_s),
    # d_att, bf16(att32) and the per-tile partial sums
    nc, _ = bwd_image_chunk(b, p_s, e, h)
    lerped = [q != p for q in p_s]
    parts = _bwd_parts(p_s, h)
    hs = [bf16(nc, q, e) for q in p_s]
    us = [bf16(nc, p, e) if up else None for up in lerped]
    dus = [bf16(nc, p, e) if up else None for up in lerped]
    act = [bf16(nc, p, h) for _ in xs]
    dzh = [bf16(nc, q, e) for q in p_s]
    dbp_part = [f32(nc, parts[s], e) for s in range(n)]
    datt, att = f32(nc, n, p), f32(nc, n, p)
    lpart = f32(nc, n, parts[MAX_SCALES], p)
    row_part = f32(nc, parts[MAX_SCALES + 1], 2, h)
    plans = [_plan_on(q, p, dev) if up else (None,) * 3
             for q, up in zip(p_s, lerped)]
    ptrs = ctypes.c_void_p * MAX_SCALES
    ints = ctypes.c_int * MAX_SCALES

    def arr(ts, c0=0):            # pointers to image c0 of each tensor
        return ptrs(*[None if t is None else t[c0:].data_ptr() for t in ts])

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for c0 in range(0, b, nc):
            c1 = min(b, c0 + nc)
            rc = lib_fwd.medmoe_expert_fusion_proj(
                n, arr(xs, c0), arr(wp_k), arr(bp_k), arr(hs), ints(*p_s),
                ints(*d_s), idx_k[c0:].data_ptr(), c1 - c0, k, e, stream)
            if rc:
                break
            rc = lib.medmoe_expert_fusion_bwd(
                n, arr(xs, c0), arr(wp_k), arr(hs), arr(us), arr(dus),
                arr(act), arr(dzh), arr(d_xs, c0), arr(d_wp, c0),
                arr(d_bp, c0), arr(dbp_part), arr([t[0] for t in plans]),
                arr([t[1] for t in plans]), arr([t[2] for t in plans]),
                ints(*p_s), ints(*d_s), (ctypes.c_int * len(parts))(*parts),
                w1_k.data_ptr(), b1_k.data_ptr(), w2_k.data_ptr(),
                idx_k[c0:].data_ptr(), d_out[c0:].data_ptr(),
                d_w1[c0:].data_ptr(), d_b1[c0:].data_ptr(), d_w2[c0:].data_ptr(),
                datt.data_ptr(), lpart.data_ptr(), att.data_ptr(),
                row_part.data_ptr(), c1 - c0, k, e, h, p, stream)
            if rc:
                break
    if rc != 0:
        raise RuntimeError("expert_fusion backward launch failed: "
                           + lib.medmoe_cuda_error_string(rc).decode())
    BWD_LAUNCHES += 1
    return tuple(d_xs), tuple(d_wp), tuple(d_bp), d_w1, d_b1, d_w2


def _bwd_parts(p_list: Sequence[int], h: int) -> list:
    """The partial sums K2 writes an image, as its C entry takes them
    (MAX_SCALES + 2 counts): dbp's of each scale (one per 128-row tile of
    the d_u product at the identity scale, else one per 8 source rows of
    the transposed upsample; 0 past the last scale), then the a product's
    128-wide tiles of H (partial logits), then the row step's 64-row tiles
    of P (partial dw2 and db1)."""
    p = max(p_list)
    dbp = [-(-p // _TM) if q == p else -(-q // _BWD_T_ROWS)
           for q in p_list]
    return (dbp + [0] * (MAX_SCALES - len(dbp))
            + [-(-h // _TM), -(-p // _BWD_ROW_TM)])


def bwd_scratch_bytes(p_list: Sequence[int], e: int, h: int) -> int:
    """Device scratch of K2 for one image (``expert_fusion_gather_bwd``):
    bf16 h_s and bf16(dz_h_s) of every scale, bf16 u_s and bf16(d_u_s) of
    every scale with P_s < P, a_s / bf16(dz_a_s) of every scale, f32 d_att,
    bf16(att32) and partial logits, and the partial sums of dw2, db1 and
    dbp."""
    p, s = max(p_list), len(p_list)
    lerped = sum(q != p for q in p_list)
    parts = _bwd_parts(p_list, h)
    return (sum(p_list) * e * 2 * 2 + lerped * p * e * 2 * 2 + s * p * h * 2
            + s * p * (2 + parts[MAX_SCALES]) * 4
            + parts[MAX_SCALES + 1] * 2 * h * 4
            + sum(parts[:MAX_SCALES]) * e * 4)


def fwd_scratch_bytes(p_list: Sequence[int], e: int, h: int) -> int:
    """Device scratch of K1 for one image (``expert_fusion_gather``): bf16
    h_s of every scale, bf16 u_s of every scale with P_s < P and the f32
    partial logits of each scale's 128-wide tiles of H."""
    p, s = max(p_list), len(p_list)
    lerped = sum(q != p for q in p_list)
    return (sum(p_list) * e * 2 + lerped * p * e * 2
            + s * -(-h // _TM) * p * 4)


def fwd_image_chunk(b: int, p_list: Sequence[int], e: int,
                    h: int) -> Tuple[int, int]:
    """(images, bytes) of the chunk K1 runs its passes over: as many images
    as fit in 1.7 GB of scratch, at least one, at most the batch."""
    per_image = fwd_scratch_bytes(p_list, e, h)
    images = images_in_budget(b, per_image)
    return images, images * per_image


def bwd_image_chunk(b: int, p_list: Sequence[int], e: int,
                    h: int) -> Tuple[int, int]:
    """(images, bytes) of the chunk K2 runs its passes over: as many images
    as fit in 1.7 GB of scratch, at least one, at most the batch."""
    per_image = bwd_scratch_bytes(p_list, e, h)
    images = images_in_budget(b, per_image)
    return images, images * per_image


@functools.lru_cache(maxsize=None)
def transposed_lerp_plan(p_s: int, p: int):
    """K2's table of the transposed upsample Gᵀ (G [P, P_s]: u = G·h, the
    linear upsample P_s → P), by source row: ``(start, rows, weights)``,
    int32 [P_s + 1], int32 [nnz] and float32 [nnz]. Source row i sums the
    destination rows ``rows[start[i]:start[i + 1]]``, in increasing order,
    with weights G[p, i]: the nonzero entries of row i of
    ``linear_interp_matrix(p_s, p)``, bit for bit (1 − w at the lower
    source row, w at the upper, their f32 sum where the two coincide)."""
    from medmoe_torch.models.moe import _interp_coords

    lo, hi, w = _interp_coords(p_s, p)
    dst = np.arange(p)
    w_lo = (1.0 - w).astype(np.float32)
    same = lo == hi
    w_lo = np.where(same, w_lo + w, w_lo).astype(np.float32)
    src = np.concatenate([lo, hi[~same]])
    rows = np.concatenate([dst, dst[~same]])
    weights = np.concatenate([w_lo, w[~same]]).astype(np.float32)
    keep = weights != 0
    src, rows, weights = src[keep], rows[keep], weights[keep]
    order = np.lexsort((rows, src))
    start = np.searchsorted(src[order], np.arange(p_s + 1)).astype(np.int32)
    return start, rows[order].astype(np.int32), weights[order]


def transposed_lerp(plan, x: torch.Tensor) -> torch.Tensor:
    """Gᵀ·x for x [B, P, E] → [B, P_s, E] float32 from a
    ``transposed_lerp_plan`` table, each source row's terms added in
    increasing p: the plain version of K2's banded transposed upsample."""
    start, rows, weights = plan
    src = np.repeat(np.arange(len(start) - 1), np.diff(start))
    terms = x[:, torch.from_numpy(rows).long().to(x.device)].float() \
        * torch.from_numpy(weights).to(x.device)[None, :, None]
    out = torch.zeros((x.shape[0], len(start) - 1, x.shape[2]),
                      dtype=torch.float32, device=x.device)
    return out.index_add_(1, torch.from_numpy(src).to(x.device), terms)


@functools.lru_cache(maxsize=None)
def _plan_on(p_s: int, p: int, dev: torch.device):
    """The table on the card, its weights rounded through bf16 as the TPU
    kernel's bf16 interpolation matrix rounds them (exact for the
    pyramid's power-of-two ratios)."""
    start, rows, weights = transposed_lerp_plan(p_s, p)
    return (torch.from_numpy(start).to(dev), torch.from_numpy(rows).to(dev),
            torch.from_numpy(weights).to(torch.bfloat16).float().to(dev))


def expert_fusion_gather_bwd_reference(xs: Sequence[torch.Tensor],
                                       wp: Sequence[torch.Tensor],
                                       bp: Sequence[torch.Tensor],
                                       w1: torch.Tensor, b1: torch.Tensor,
                                       w2: torch.Tensor,
                                       expert_idx: torch.Tensor,
                                       d_out: torch.Tensor):
    """Plain PyTorch version of K2, step by step with the rounding points
    of the JAX package's ``_bwd_kernel``: bf16 products with float32 sums,
    the forward chain recomputed, the softmax backward through the float32
    weights, bf16(dz_a), bf16(d_u) into the transposed upsample (the f32
    d_u at the largest scale), the ReLU mask from the recomputed h_pre (the
    kernel reads it from bf16 h_s, equal in value: bf16 keeps f32's exponent
    range), and bf16(dz_h) into d_x and dWp. Returns what ``expert_fusion_gather_bwd``
    returns."""
    from medmoe_torch.models.moe import interp_patches, linear_interp_matrix

    bf = torch.bfloat16
    idx = expert_idx.long()
    p_max = max(x.shape[1] for x in xs)

    def sel(param):                       # [K, ...] → per-sample [B, ...]
        return param[idx].to(bf).float()

    w1s, b1s, w2s = sel(w1), sel(b1), sel(w2)[..., 0]       # w2s [B, H]
    g = d_out.float()
    saved, logits, datts = [], [], []
    for s, x in enumerate(xs):
        xf, wps = x.to(bf).float(), sel(wp[s])
        h_pre = torch.bmm(xf, wps) + sel(bp[s])[:, None, :]
        u = interp_patches(torch.relu(h_pre).to(bf), p_max, dim=1)
        a = torch.relu(torch.bmm(u.float(), w1s) + b1s[:, None, :]).to(bf)
        logits.append((a.float() * w2s[:, None, :]).sum(-1))
        datts.append((g * u.float()).sum(-1))
        saved.append((xf, wps, h_pre, u.float(), a.float()))
    att32 = torch.softmax(torch.stack(logits, -1), dim=-1)   # [B, P, S]
    att = att32.to(bf).float()
    datt = torch.stack(datts, -1)
    d_l = att32 * (datt - (att32 * datt).sum(-1, keepdim=True))

    d_xs, d_wp, d_bp = [], [], []
    d_w1 = d_b1 = d_w2 = 0.0
    for s, (xf, wps, h_pre, u, a) in enumerate(saved):
        dl_s = d_l[..., s:s + 1]                             # [B, P, 1]
        d_w2 = d_w2 + (a * dl_s).sum(1)
        dz_a = torch.where(a > 0, dl_s * w2s[:, None, :], 0.0)
        d_b1 = d_b1 + dz_a.sum(1)
        dz_bf = dz_a.to(bf).float()
        d_w1 = d_w1 + torch.bmm(u.transpose(1, 2), dz_bf)
        d_u = att[..., s:s + 1] * g + torch.bmm(dz_bf, w1s.transpose(1, 2))
        p_s = xf.shape[1]
        if p_s == p_max:
            d_h = d_u
        else:                              # Gᵀ·bf16(d_u): [P_s, P] × [B, P, E]
            gt = torch.from_numpy(linear_interp_matrix(p_s, p_max)) \
                .to(d_u.device).to(bf).float()
            d_h = torch.matmul(gt, d_u.to(bf).float())
        dz_h = torch.where(h_pre > 0, d_h, 0.0)
        dz_h_bf = dz_h.to(bf).float()
        d_xs.append(torch.bmm(dz_h_bf, wps.transpose(1, 2)).to(xs[s].dtype))
        d_wp.append(torch.bmm(xf.transpose(1, 2), dz_h_bf))
        d_bp.append(dz_h.sum(1))
    return tuple(d_xs), tuple(d_wp), tuple(d_bp), d_w1, d_b1, d_w2


def _bank_scatter(per_sample: torch.Tensor, param: torch.Tensor,
                  idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-sample gradients [B, ...] → the [K, ...] bank gradient, summed
    per expert (``_fe_bwd``'s one-hot contraction). Samples with an
    out-of-range id contribute nothing (their own outputs are NaN)."""
    per = per_sample.reshape((per_sample.shape[0],) + param.shape[1:])
    mask = valid.reshape((-1,) + (1,) * (per.ndim - 1))
    out = torch.zeros_like(param)
    out.index_add_(0, idx.clamp(0, param.shape[0] - 1).long(),
                   torch.where(mask, per, torch.zeros_like(per)))
    return out


class FusedExpertGather(torch.autograd.Function):
    """The fused expert branch with its gradient:
    ``FusedExpertGather.apply(expert_idx, w1, b1, w2, b2, *xs, *wp, *bp)``
    → [B, P, E] float32.

    CUDA: forward is K1 (through ``expert_fusion_gather_op``), backward is
    K2 then the bank scatter. CPU: forward is the plain version and
    backward is autograd through it — the math the JAX package's XLA path
    differentiates. Only the inputs are kept for the backward, which
    recomputes the rest."""

    @staticmethod
    def forward(ctx, expert_idx, w1, b1, w2, b2, *flat):
        n = len(flat) // 3
        xs, wp, bp = flat[:n], flat[n:2 * n], flat[2 * n:]
        ctx.n = n
        ctx.save_for_backward(expert_idx, w1, b1, w2, b2, *flat)
        return expert_fusion_gather_op(list(xs), list(wp), list(bp), w1, b1,
                                       w2, b2, expert_idx)

    @staticmethod
    def backward(ctx, g):
        expert_idx, w1, b1, w2, b2, *flat = ctx.saved_tensors
        n = ctx.n
        xs, wp, bp = flat[:n], flat[n:2 * n], flat[2 * n:]
        if expert_idx.device.type == "cpu":
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_()
                          for t in (w1, b1, w2, b2, *flat)]
                lw1, lb1, lw2, lb2 = leaves[:4]
                lf = leaves[4:]
                out = expert_fusion_gather_reference(
                    lf[:n], lf[n:2 * n], lf[2 * n:], lw1, lb1, lw2, lb2,
                    expert_idx)
                grads = torch.autograd.grad(out, leaves, g)
            return (None, *grads)
        d_xs, d_wp, d_bp, d_w1, d_b1, d_w2 = expert_fusion_gather_bwd(
            xs, wp, bp, w1, b1, w2, expert_idx, g.float().contiguous())
        k = w1.shape[0]
        valid = (expert_idx >= 0) & (expert_idx < k)

        def scatter(per, param):
            return _bank_scatter(per, param, expert_idx, valid)

        return (None, scatter(d_w1, w1), scatter(d_b1, b1), scatter(d_w2, w2),
                torch.zeros_like(b2), *d_xs,
                *[scatter(d, w) for d, w in zip(d_wp, wp)],
                *[scatter(d, bb) for d, bb in zip(d_bp, bp)])
