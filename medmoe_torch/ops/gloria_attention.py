"""GLoRIA word-region similarity: CUDA kernel wrappers (K3 forward, K4a
d_ctx, K4b d_words), their plain PyTorch versions, the autograd Function
and the launch counters (counterpart of
medmoe_tpu/ops/pallas/gloria_attention.py).

What it computes (reference losses.py:961-1015, the local loss's
similarity matrix), for image b and caption i, with ctx = the image's
[D, M] local map and w = the caption's [D, T] word embeddings, both
rounded to bf16:

    scores[m,t] = Σ_d ctx[d,m]·w[d,t]           bf16 products, f32 sums
    a1 = softmax_t(scores | t < cap_i)          masked words at -1e30
    a2 = softmax_m(temp1·a1)                    f32, not rounded
    wei[d,t] = Σ_m ctx[d,m]·a2[m,t]             f32
    cos[t] = ⟨w_t, wei_t⟩ / max(‖w_t‖·‖wei_t‖, 1e-8)
    sim[b,i] = temp3 · log Σ_{t<cap_i} exp(temp2·cos[t])

This is the function of the JAX kernel (``_cell_recompute``), not of the
einsum path (``ops/losses.py``), which rounds a2 to bf16 before its wei
product. Its backward is the JAX ``custom_vjp``'s explicit cotangents
(``_cell_cotangents``, ``_dctx_kernel``, ``_dwords_kernel``), with their
bf16 roundings of d_wei, a2 and d_scores before each cotangent product;
it is not autograd through the forward.

Kernels. ``csrc/gloria_attention.cu`` replaces ``_sim_kernel`` (K3) and
holds the backward's prologue, the forward chain again with the
cotangents down to bf16(d_wei) per pair: both run two products on the
wgmma core of ``csrc/wgmma_core.cuh`` (F1: scores and e; F2: wei; TMA
loads through tensor maps the C entries build per call) and a finishing
kernel (F3); for d_words the prologue also sums K4b's f32 terms Σ_b
dnum·wei and Σ_b c2 from F2's wei. ``csrc/gloria_attention_bwd.cu``
replaces ``_dctx_kernel`` (K4a) and ``_dwords_kernel`` (K4b): one C entry
runs, per chunk of images, the pass that writes Z = [bf16(a2) |
bf16(d_scores)] once, then K4a's product over Z and K4b's product ctxᵀ·Zds
(its K cut into ``K4B_SLICES`` slices, summed in order by a streaming
pass), all on the wgmma core. Their design notes are in the sources. F1/F2's
bf16 hi and lo of e and Z live in chunks of images (``image_chunk``: 16
images, 1.6 GB at flagship); between the prologue and K4a/K4b the
per-pair cotangents live in device memory (``backward_scratch_bytes``:
5.4 GB at B=256, D=768, T <= 32, the prologue's chunk included). Not
ported: the TPU kernel's lane packing, ``_segment_max``, the indicator
matmuls and the ``shard_map`` wrapper (Mosaic and SPMD devices), and its
environment switches.

Kept state. JAX's ``_fwd`` saves only the inputs, and its backward runs the
forward chain again: a trade made for TPU memory. Here, when a gradient
will be taken, K3 keeps F2's f32 wei, F1's Σ_m e and F2's partial sums of
the whole batch (``KeptState``, ``kept_bytes``: 6.73 GB at 256², D=768,
T <= 32; half that for a rank's 128 × 256 block), and the prologue runs
only F3 from them (at 256² and T=25 on an H100 80GB HBM3: 5.1 ms, against
68.2 ms running F1 and F2 again; storing wei takes K3's F2 2.4 ms of
device time, and K3 62.6 against 59.2 ms in medians of alternating
rounds). The rule reads the shape and the card, with no switch
(``keeps_state``): the state is kept when it takes at most a quarter of
the card's memory, else the prologue recomputes (T = 128 at 256²: wei
alone is 25.8 GB). Both ways give the same bits. The prologue frees the state once its launches are
queued, before K4a allocates Z. Calls without a gradient
(``torch.no_grad``, inputs that need none) keep nothing.

Limits. The plain versions take any T, D and temp1, as the JAX functions
do. The kernels take D % 16 == 0, D <= 768, T <= 128 (captions padded to
32·⌈T/32⌉ words, whole captions in a 256-wide tile) and |temp1| <= 80
(``check_kernel_limits``); a CUDA tensor outside them raises before any
launch, and the local loss and the trainer call the same check before
anything runs on the card.

Layouts. The kernels read ctx as [B_img, M, D] bf16, D contiguous. The
model's local map is a permuted view of the expert branch's [B, P, E]
output, so ``img_features`` [B, D, H, W] arrives with those strides and
the wrapper reads it without a copy; a tensor in the plain [B, D, H, W]
layout is copied once (1.2 GB at B=256 in bf16). d_img is returned in the
same [B, M, D] memory, as a [B, D, H, W] view, which is the layout the
expert branch's backward takes.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from medmoe_torch.ops._scratch import images_in_budget
from medmoe_torch.utils import trace


def __getattr__(name: str) -> int:
    """``LAUNCHES``, ``PROLOGUE_LAUNCHES``, ``DCTX_LAUNCHES`` and
    ``DWORDS_LAUNCHES``: the kernel launches on CUDA tensors of K3 (forward),
    the backward's prologue, K4a (d_ctx) and K4b (d_words) (the plain
    versions do not count), read from the counter registry
    (``utils/trace.py``)."""
    return trace.module_counter("gloria_attention", name)


NEG_INF = -1e30
WORD_TILE = 32      # csrc/gloria_common.cuh TP: captions pad to whole tiles
MAX_WORDS = 128     # csrc/gloria_common.cuh MAX_NT·TP (K4a's 256-wide tile)
MAX_DIM = 768       # csrc/gloria_common.cuh MAX_D
MAX_TEMP1 = 80.0    # exp(temp1·a1 - max(temp1, 0)) stays a normal f32
M_TILE = 128        # csrc/gloria_attention.cu MTILE: F1's rows of a tile
D_TILE = 256        # csrc/gloria_attention.cu DTILE: F2's columns of a tile
K4B_SLICES = 2      # K4b's slices of a chunk's K (csrc/gloria_attention_bwd.cu)
_PLAIN_BYTES = 512 << 20   # one [c, B_img, M, T] f32 block of the plain versions


def _check(img: torch.Tensor, words: torch.Tensor, cap_lens: torch.Tensor,
           temp1: float) -> Tuple[int, int, int, int, int]:
    """Raise on what the functions do not take; return (B_img, B_txt, D,
    M, T). B_img and B_txt may differ."""
    if not all(isinstance(t, torch.Tensor) for t in (img, words, cap_lens)):
        raise TypeError("gloria_similarity takes torch tensors")
    if len({img.device, words.device, cap_lens.device}) != 1:
        raise ValueError("gloria_similarity: all inputs must be on one device, "
                         f"got {img.device}, {words.device}, {cap_lens.device}")
    if img.ndim != 4 or words.ndim != 3:
        raise ValueError("gloria_similarity takes img_features [B_img, D, H, W] "
                         f"and words_emb [B_txt, D, T], got {tuple(img.shape)} "
                         f"and {tuple(words.shape)}")
    floats = (torch.float32, torch.bfloat16, torch.float16)
    if img.dtype not in floats or words.dtype not in floats:
        raise TypeError("gloria_similarity: features must be float32, bfloat16 "
                        f"or float16, got {img.dtype} and {words.dtype}")
    if cap_lens.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"cap_lens must be int32 or int64, got {cap_lens.dtype}")
    bi, d, h, w = img.shape
    bt, dw, t = words.shape
    if d != dw:
        raise ValueError(f"img_features has D={d}, words_emb D={dw}")
    if tuple(cap_lens.shape) != (bt,):
        raise ValueError(f"cap_lens must be [{bt}], got {tuple(cap_lens.shape)}")
    if min(bi, bt, h * w, t) < 1:
        raise ValueError("gloria_similarity: empty input "
                         f"{tuple(img.shape)}, {tuple(words.shape)}")
    return bi, bt, d, h * w, t


def check_kernel_limits(d: int, t: int, temp1: float) -> None:
    """Raise ValueError unless the GLoRIA kernels (K3, the prologue, K4a,
    K4b) take word embeddings of width D, captions of T words and temp1:
    D % 16 == 0 and D <= 768 (the accumulators and shared memory), T <= 128
    (K4a's widest tile) and |temp1| <= 80 (exp(temp1·a1 - max(temp1, 0))
    stays a normal f32). Shapes and scalars only, so it runs before
    anything reaches the card."""
    if d % 16 or d > MAX_DIM or t > MAX_WORDS \
            or not -MAX_TEMP1 <= float(temp1) <= MAX_TEMP1:
        raise ValueError(
            f"the GLoRIA kernels take D % 16 == 0, D <= {MAX_DIM}, "
            f"T <= {MAX_WORDS} and |temp1| <= {MAX_TEMP1}; got D={d}, "
            f"T={t}, temp1={temp1}")


def _tpad(t: int) -> int:
    """Words of a caption as the kernels lay it out: whole word tiles."""
    return -(-t // WORD_TILE) * WORD_TILE


def _device_kind(img: torch.Tensor) -> str:
    if img.device.type not in ("cpu", "cuda"):
        raise ValueError("gloria_similarity runs on CUDA or CPU tensors, got "
                         f"{img.device}")
    return img.device.type


def _kernel_inputs(img, words, cap_lens):
    """ctx [B_img, M, D] bf16 (a view when img has the local map's
    channels-last strides), words zero-padded to [B_txt, D, 32·⌈T/32⌉]
    bf16, cap_lens int32."""
    bi, d, h, w = img.shape
    ctx = img.permute(0, 2, 3, 1).reshape(bi, h * w, d).to(torch.bfloat16) \
        .contiguous()
    words_p = torch.zeros((words.shape[0], d, _tpad(words.shape[2])),
                          dtype=torch.bfloat16, device=words.device)
    words_p[..., :words.shape[2]] = words
    return ctx, words_p, cap_lens.to(torch.int32).contiguous()


def image_chunk(b_img: int, b_txt: int, m: int, t: int) -> Tuple[int, int]:
    """(images, bytes) of the per-image scratch that K3 and the prologue
    (E, the bf16 hi and lo of e) and K4a (Z = [bf16(a2) | bf16(d_scores)])
    run their passes over, M·B_txt·2·TPAD bf16 an image: as many images as
    fit in 1.7 GB, at least one."""
    per_image = m * b_txt * 2 * _tpad(t) * 2
    images = images_in_budget(b_img, per_image)
    return images, images * per_image


def _state(images: int, b_txt: int, m: int, d: int, t: int,
           wei: bool = True) -> list:
    """[(shape, dtype)] of F1's and F2's f32 outputs for ``images`` images
    (csrc/gloria_attention.cu), what F3 reads: Σ_m e of each 128-row M tile
    [images, ⌈M/128⌉, B_txt·TPAD], Σ_d w·wei, wei², w² of each 256-wide D
    tile [images, ⌈D/256⌉, 3, B_txt·TPAD] and, with ``wei``, wei [images,
    B_txt, D, TPAD]."""
    tp = _tpad(t)
    n = b_txt * tp
    shapes = [((images, -(-m // M_TILE), n), torch.float32),
              ((images, -(-d // D_TILE), 3, n), torch.float32)]
    if wei:
        shapes.append(((images, b_txt, d, tp), torch.float32))
    return shapes


def _pass_scratch(b_img: int, b_txt: int, m: int, d: int, t: int,
                  wei: bool) -> Tuple[int, list]:
    """(images, [(shape, dtype)]) of the scratch of K3's and the prologue's
    passes for one chunk of images: E [images, 2, M, B_txt·TPAD] bf16 (bf16
    hi, then lo, of e), then ``_state`` of the chunk (wei for the
    prologue)."""
    images, _ = image_chunk(b_img, b_txt, m, t)
    e = ((images, 2, m, b_txt * _tpad(t)), torch.bfloat16)
    return images, [e] + _state(images, b_txt, m, d, t, wei)


def _bytes(shapes: list) -> int:
    return sum(math.prod(s) * dt.itemsize for s, dt in shapes)


def kept_bytes(b_img: int, b_txt: int, m: int, d: int,
               t: int = WORD_TILE) -> int:
    """Device memory of K3's kept state (``KeptState``): ``_state`` of the
    whole batch, wei included. 6.73 GB at 256², D = 768, M = 3136, T <= 32;
    a rank's 128 × 256 block half that."""
    return _bytes(_state(b_img, b_txt, m, d, t))


def keeps_state(b_img: int, b_txt: int, m: int, d: int, t: int,
                total_memory: int) -> bool:
    """The rule for keeping K3's state, read from the shape and the card:
    its bytes are at most a quarter of the card's ``total_memory``. At 256²
    and T <= 32 it keeps (6.73 GB of an 80 GB card); at T = 128 wei alone is
    25.8 GB, and the backward recomputes F1 and F2. Either way the bits are
    the same."""
    return 4 * kept_bytes(b_img, b_txt, m, d, t) <= total_memory


def backward_scratch_bytes(b_img: int, b_txt: int, m: int, d: int,
                           t: int = WORD_TILE) -> int:
    """Device scratch of one kernel backward that recomputes: bf16(d_wei)
    and the per-word vectors per pair, K4b's f32 accumulators (Σ dnum·wei
    [B_txt, D, TPAD] and Σ c2 [B_txt, TPAD]) and its slices' partial
    products (``K4B_SLICES`` × [B_txt, D, TPAD]), when d_words is asked
    for, and the prologue's passes over one chunk of images (E, partial
    sums, wei; ``_pass_scratch``). A backward from K3's kept state has no
    passes' scratch, but holds ``kept_bytes`` until its prologue is
    queued. Z: ``image_chunk``."""
    pairs, tp = b_img * b_txt, _tpad(t)
    passes = _bytes(_pass_scratch(b_img, b_txt, m, d, t, wei=True)[1])
    return (pairs * d * tp * 2 + pairs * 4 * tp * 4
            + b_txt * (d + 1) * tp * 4 + K4B_SLICES * b_txt * d * tp * 4
            + passes)


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _raise(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.medmoe_cuda_error_string(rc).decode())


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

class KeptState:
    """K3's f32 state of a whole batch, kept for the backward's prologue
    (``kept_bytes``): ``tensors`` is [Σ_m e, partial sums, wei] as
    ``_state`` lays them out, or None. ``gloria_similarity_forward`` fills
    an empty one; ``pair_cotangents`` reads it and empties it as soon as its
    launches are queued, so the memory goes back before K4a allocates
    Z."""

    __slots__ = ("tensors",)

    def __init__(self):
        self.tensors: Optional[list] = None


def gloria_similarity_forward(img: torch.Tensor, words: torch.Tensor,
                              cap_lens: torch.Tensor, temp1: float = 4.0,
                              temp2: float = 5.0, temp3: float = 10.0,
                              kept: Optional[KeptState] = None
                              ) -> torch.Tensor:
    """[B_img, B_txt] float32 similarity matrix, without a gradient.

    CUDA tensors launch K3 (or raise); with ``kept``, an empty
    ``KeptState``, K3 also writes its state into it for the backward's
    prologue (the same sim). CPU tensors run the plain version and keep
    nothing."""
    bi, bt, d, m, t = _check(img, words, cap_lens, temp1)
    if _device_kind(img) == "cpu":
        return gloria_similarity_reference(img, words, cap_lens, temp1, temp2,
                                           temp3)
    check_kernel_limits(d, t, temp1)
    from medmoe_torch.ops import _build

    lib = _build.load("gloria_attention")
    ctx, words_p, caps = _kernel_inputs(img, words, cap_lens)
    words_t = words_p.transpose(1, 2).contiguous()
    out = torch.empty((bi, bt), dtype=torch.float32, device=img.device)
    chunk, shapes = _pass_scratch(bi, bt, m, d, t, wei=False)
    if kept is not None:      # E of a chunk, the state of the whole batch
        shapes = shapes[:1] + _state(bi, bt, m, d, t)
    scratch = [torch.empty(s, dtype=dt, device=img.device) for s, dt in shapes]
    if kept is None:
        scratch.append(None)  # no wei: K3 keeps nothing
    with torch.cuda.device(img.device):
        rc = lib.medmoe_gloria_sim(
            ctx.data_ptr(), words_p.data_ptr(), caps.data_ptr(), bi, bt, m, d, t,
            float(temp1), float(temp2), float(temp3), words_t.data_ptr(),
            *(_ptr(s) for s in scratch), chunk, out.data_ptr(), _stream())
    _raise(lib, rc, "gloria_attention (K3)")
    if kept is not None:
        kept.tensors = scratch[1:]
    del scratch
    trace.count("launches.K3")
    return out


def _text_chunk(b_img: int, m: int, t: int, b_txt: int) -> int:
    return max(1, min(b_txt, _PLAIN_BYTES // max(1, b_img * m * t * 4)))


def _plain_chain(ctx, wc, caps_c, temp1, temp2):
    """The forward chain of ``_cell_recompute`` for a chunk of captions:
    ctx [B, D, M] and wc [c, D, T] float32 holding bf16 values."""
    t = wc.shape[-1]
    valid = torch.arange(t, device=wc.device)[None, :] < caps_c[:, None]  # [c, T]
    scores = torch.einsum("bdm,cdt->cbmt", ctx, wc)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    a1 = torch.softmax(scores, dim=-1)
    a2 = torch.softmax(a1 * temp1, dim=2)                    # over regions
    wei = torch.einsum("bdm,cbmt->cbdt", ctx, a2)
    w32 = wc[:, None]                                        # [c, 1, D, T]
    num = torch.sum(w32 * wei, dim=2)                        # [c, B, T]
    nw = torch.sqrt(torch.sum(w32 * w32, dim=2))             # [c, 1, T]
    nwei = torch.sqrt(torch.sum(wei * wei, dim=2))
    den_raw = nw * nwei
    den = torch.clamp(den_raw, min=1e-8)
    cos = num / den
    row = torch.where(valid[:, None, :], torch.exp(cos * temp2), 0.0)
    return dict(a1=a1, a2=a2, wei=wei, w32=w32, num=num, nw=nw, nwei=nwei,
                den_raw=den_raw, den=den, row=row,
                rowsum=torch.sum(row, dim=-1, keepdim=True))


def _plain_inputs(img, words):
    bi, d, h, w = img.shape
    ctx = img.reshape(bi, d, h * w).to(torch.bfloat16).float()
    return ctx, words.to(torch.bfloat16).float()


def gloria_similarity_reference(img: torch.Tensor, words: torch.Tensor,
                                cap_lens: torch.Tensor, temp1: float = 4.0,
                                temp2: float = 5.0, temp3: float = 10.0
                                ) -> torch.Tensor:
    """Plain PyTorch version of K3, step for step ``_cell_recompute`` and
    ``_sim_kernel``: inputs rounded to bf16, every product and sum in
    float32 (products of bf16 values are exact in float32). Runs in chunks
    of captions so that the card holds it at B=256."""
    bi, bt, d, m, t = _check(img, words, cap_lens, temp1)
    ctx, w = _plain_inputs(img, words)
    caps = cap_lens.long()
    c = _text_chunk(bi, m, t, bt)
    sims = []
    for i0 in range(0, bt, c):
        cell = _plain_chain(ctx, w[i0:i0 + c], caps[i0:i0 + c], temp1, temp2)
        sims.append(torch.log(cell["rowsum"][..., 0]) * temp3)   # [c, B]
    return torch.cat(sims, dim=0).T.contiguous()


# --------------------------------------------------------------------------
# backward
# --------------------------------------------------------------------------

def gloria_similarity_backward(img: torch.Tensor, words: torch.Tensor,
                               cap_lens: torch.Tensor, g: torch.Tensor,
                               temp1: float = 4.0, temp2: float = 5.0,
                               temp3: float = 10.0, need_img: bool = True,
                               need_words: bool = True,
                               kept: Optional[KeptState] = None
                               ) -> Tuple[Optional[torch.Tensor],
                                          Optional[torch.Tensor]]:
    """Cotangents (d_img like img_features, d_words like words_emb) of the
    similarity matrix for its cotangent g [B_img, B_txt]; None for an input
    not asked for.

    CUDA tensors run the prologue (from K3's ``kept`` state when it holds
    one, which it empties), then K4a (d_img) and K4b (d_words) over one
    pass that writes Z per chunk of images, or raise; CPU tensors run the
    plain version. With ``need_words`` either way counts ``gloria.words``."""
    bi, bt, d, m, t = _check(img, words, cap_lens, temp1)
    if not isinstance(g, torch.Tensor) or tuple(g.shape) != (bi, bt) \
            or g.device != img.device:
        raise ValueError(f"g must be a [{bi}, {bt}] tensor on {img.device}")
    if need_words:
        trace.count(trace.GLORIA_WORDS)
    if _device_kind(img) == "cpu":
        return gloria_similarity_bwd_reference(img, words, cap_lens, g, temp1,
                                               temp2, temp3, need_img,
                                               need_words)
    check_kernel_limits(d, t, temp1)
    pairs = pair_cotangents(img, words, cap_lens, g, temp1, temp2, temp3,
                            need_words, kept)
    d_img = d_words = None
    if not (need_img or need_words):
        return d_img, d_words
    d_ctx, d_w = cotangents_of(pairs, need_img, need_words)
    if need_img:
        trace.count("launches.K4a")
        h, w = img.shape[2:]
        d_img = d_ctx.to(img.dtype).reshape(bi, h, w, d).permute(0, 3, 1, 2)
    if need_words:
        trace.count("launches.K4b")
        d_words = d_w.to(words.dtype)
    return d_img, d_words


class PairScratch(NamedTuple):
    """The backward's inputs as the kernels take them and the prologue's
    per-pair scratch, held together: the kernels get their pointers."""
    ctx: torch.Tensor          # [B_img, M, D] bf16
    words: torch.Tensor        # [B_txt, D, TPAD] bf16
    caps: torch.Tensor         # [B_txt] int32
    dims: Tuple[int, ...]      # B_img, B_txt, M, D, T
    temp1: float
    dwei: torch.Tensor         # [B_img·B_txt, D, TPAD] bf16(d_wei)
    vecs: torch.Tensor         # [B_img·B_txt, 4, TPAD] f32
    wsum: Optional[torch.Tensor]    # [B_txt, D, TPAD] f32 Σ_b dnum·wei (K4b)
    c2sum: Optional[torch.Tensor]   # [B_txt, TPAD] f32 Σ_b c2 (K4b)

    def args(self):
        return (self.ctx.data_ptr(), self.words.data_ptr(),
                self.caps.data_ptr(), *self.dims, self.temp1)


def pair_cotangents(img, words, cap_lens, g, temp1, temp2, temp3,
                    need_words: bool = False,
                    kept: Optional[KeptState] = None) -> PairScratch:
    """The backward's prologue on CUDA tensors that passed ``_check`` and
    ``check_kernel_limits``: bf16(d_wei) and the per-word vectors of every
    pair, and with ``need_words`` K4b's f32 terms Σ_b dnum·wei and Σ_b c2.
    From K3's ``kept`` state of these inputs, when it holds one, only F3
    runs (and K4b's terms), and the state is freed once they are queued;
    otherwise F1 and F2 run again first. Either way the same bits, counted
    as ``gloria.kept`` or ``gloria.recomputed``.
    ``gloria_similarity_backward`` runs it and counts the launches of what
    follows; ``cotangents_of`` reads it."""
    from medmoe_torch.ops import _build

    lib = _build.load("gloria_attention")
    bi, bt = img.shape[0], words.shape[0]
    m, d, t = img.shape[2] * img.shape[3], img.shape[1], words.shape[2]
    ctx, words_p, caps = _kernel_inputs(img, words, cap_lens)
    tp = words_p.shape[2]
    g = g.float().contiguous()
    f32 = dict(dtype=torch.float32, device=img.device)
    p = PairScratch(ctx, words_p, caps, (bi, bt, m, d, t), float(temp1),
                    torch.empty((bi * bt, d, tp), dtype=torch.bfloat16,
                                device=img.device),
                    torch.empty((bi * bt, 4, tp), **f32),
                    torch.empty((bt, d, tp), **f32) if need_words else None,
                    torch.empty((bt, tp), **f32) if need_words else None)
    state = kept.tensors if kept is not None else None
    from_kept = state is not None
    if from_kept:
        want = [s for s, _ in _state(bi, bt, m, d, t)]
        if [tuple(x.shape) for x in state] != want:
            raise ValueError("pair_cotangents: the kept state is of another "
                             f"shape, {[tuple(x.shape) for x in state]} "
                             f"against {want}")
        words_t, chunk, scratch = None, 1, [None] + state
    else:
        words_t = words_p.transpose(1, 2).contiguous()
        chunk, shapes = _pass_scratch(bi, bt, m, d, t, wei=True)
        scratch = [torch.empty(s, dtype=dt, device=img.device)
                   for s, dt in shapes]
    with torch.cuda.device(img.device):
        rc = lib.medmoe_gloria_pair_cotangents(
            *p.args(), float(temp2), float(temp3), g.data_ptr(),
            _ptr(words_t), *(_ptr(s) for s in scratch), chunk,
            p.dwei.data_ptr(),
            p.vecs.data_ptr(), _ptr(p.wsum), _ptr(p.c2sum), _stream())
    # the stream orders the launches before any later use of this memory
    del scratch, state
    if kept is not None:
        kept.tensors = None
    _raise(lib, rc, "gloria_attention backward prologue")
    trace.count("launches.prologue")
    trace.count(trace.GLORIA_KEPT if from_kept else trace.GLORIA_RECOMPUTED)
    return p


def cotangents_of(p: PairScratch, need_img: bool = True,
                  need_words: bool = False
                  ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """K4a and K4b from the prologue's scratch: (d_ctx [B_img, M, D]
    float32 or None, d_words [B_txt, D, T] float32 or None), over chunks of
    images (``image_chunk``), each chunk's Z written once for both. d_words
    needs a prologue run with ``need_words`` and sums into its accumulator:
    one d_words a prologue."""
    from medmoe_torch.ops import _build

    if need_words and p.wsum is None:
        raise ValueError("d_words needs the prologue's K4b terms: run "
                         "pair_cotangents with need_words=True")
    lib = _build.load("gloria_attention_bwd")
    bi, bt, m, d, t = p.dims
    dev = p.ctx.device
    d_ctx = torch.empty((bi, m, d), dtype=torch.float32, device=dev) \
        if need_img else None
    tp = p.words.shape[2]
    d_w = part = None
    if need_words:
        d_w = torch.empty((bt, d, t), dtype=torch.float32, device=dev)
        part = torch.empty((K4B_SLICES, bt, d, tp), dtype=torch.float32,
                           device=dev)
    chunk, _ = image_chunk(bi, bt, m, t)
    z = torch.empty((chunk, m, bt * 2 * tp), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        rc = lib.medmoe_gloria_cotangents(
            *p.args(), p.dwei.data_ptr(), p.vecs.data_ptr(), z.data_ptr(),
            chunk, _ptr(d_ctx), _ptr(part), K4B_SLICES,
            _ptr(p.wsum if need_words else None),
            _ptr(p.c2sum if need_words else None), _ptr(d_w), _stream())
    _raise(lib, rc, "gloria_attention_bwd (K4a/K4b)")
    return d_ctx, d_w


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's device address, or None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


def gloria_similarity_bwd_reference(img: torch.Tensor, words: torch.Tensor,
                                    cap_lens: torch.Tensor, g: torch.Tensor,
                                    temp1: float = 4.0, temp2: float = 5.0,
                                    temp3: float = 10.0, need_img: bool = True,
                                    need_words: bool = True
                                    ) -> Tuple[Optional[torch.Tensor],
                                               Optional[torch.Tensor]]:
    """Plain PyTorch version of the backward, step for step
    ``_cell_cotangents``, ``_dctx_kernel`` and ``_dwords_kernel``: the
    forward chain recomputed, ``den_mask = den_raw > 1e-8``, the
    ``max(·, 1e-20)`` clamps, bf16 d_wei, a2 and d_scores into the
    cotangent products (float32 sums), d_img and d_words cast back to the
    inputs' dtypes. Runs in chunks of captions."""
    bi, bt, d, m, t = _check(img, words, cap_lens, temp1)
    ctx, w = _plain_inputs(img, words)
    caps = cap_lens.long()
    g = g.float()
    bf = torch.bfloat16
    d_ctx = torch.zeros_like(ctx) if need_img else None
    d_w = []
    c = _text_chunk(bi, m, t, bt)
    for i0 in range(0, bt, c):
        wc = w[i0:i0 + c]
        cell = _plain_chain(ctx, wc, caps[i0:i0 + c], temp1, temp2)
        g_c = g[:, i0:i0 + c].T[..., None]                      # [c, B, 1]
        dcos = g_c * (temp2 * temp3) * cell["row"] / cell["rowsum"]
        den_mask = (cell["den_raw"] > 1e-8).float()
        den = cell["den"]
        dnum = dcos / den
        dden = -dcos * cell["num"] / (den * den) * den_mask
        dnwei = dden * cell["nw"]
        dnw = dden * cell["nwei"]
        d_wei = dnum[:, :, None] * cell["w32"] \
            + (dnwei / torch.clamp(cell["nwei"], min=1e-20))[:, :, None] \
            * cell["wei"]                                       # [c, B, D, T]
        dw_bf = d_wei.to(bf).float()
        d_a2 = torch.einsum("bdm,cbdt->cbmt", ctx, dw_bf)
        a2 = cell["a2"]
        d_z = a2 * (d_a2 - torch.sum(a2 * d_a2, dim=2, keepdim=True))
        d_a1 = temp1 * d_z
        a1 = cell["a1"]
        t_sum = torch.sum(a1 * d_a1, dim=-1, keepdim=True)
        ds_bf = (a1 * (d_a1 - t_sum)).to(bf).float()           # d_scores
        if need_img:
            d_ctx += torch.einsum("cbdt,cbmt->bdm", dw_bf, a2.to(bf).float())
            d_ctx += torch.einsum("cdt,cbmt->bdm", wc, ds_bf)
        if need_words:
            dwc = torch.sum(dnum[:, :, None] * cell["wei"], dim=1) \
                + torch.sum((dnw / torch.clamp(cell["nw"], min=1e-20))[:, :, None]
                            * cell["w32"], dim=1) \
                + torch.einsum("bdm,cbmt->cdt", ctx, ds_bf)
            d_w.append(dwc)
        del cell, d_a2, d_z, d_a1, ds_bf, dw_bf, d_wei
    d_img = d_ctx.reshape(img.shape).to(img.dtype) if need_img else None
    d_words = torch.cat(d_w).to(words.dtype) if need_words else None
    return d_img, d_words


class GloriaSimilarity(torch.autograd.Function):
    """``GloriaSimilarity.apply(img_features, words_emb, cap_lens, temp1,
    temp2, temp3, keep)`` → [B_img, B_txt] float32, with its gradient.

    CUDA: forward is K3; backward is the prologue and K4a, and K4b only
    when ``words_emb`` needs a gradient (with BERT frozen and no text
    projection it feeds nothing). CPU: the plain versions, which skip
    d_words under the same condition. The inputs are saved, and with
    ``keep`` (``gloria_similarity`` decides it) K3's f32 state on the
    ``ctx`` too: the prologue then runs F3 alone and frees the state, where
    without it, as JAX's ``_fwd``, it runs F1 and F2 again. A second
    backward through a retained graph recomputes."""

    @staticmethod
    def forward(ctx, img, words, cap_lens, temp1, temp2, temp3, keep):
        ctx.save_for_backward(img, words, cap_lens)
        ctx.temps = (temp1, temp2, temp3)
        ctx.kept = KeptState() if keep else None
        return gloria_similarity_forward(img, words, cap_lens, temp1, temp2,
                                         temp3, ctx.kept)

    @staticmethod
    def backward(ctx, g):
        img, words, cap_lens = ctx.saved_tensors
        kept, ctx.kept = ctx.kept, None
        d_img, d_words = gloria_similarity_backward(
            img, words, cap_lens, g, *ctx.temps,
            need_img=ctx.needs_input_grad[0],
            need_words=ctx.needs_input_grad[1], kept=kept)
        return d_img, d_words, None, None, None, None, None


def _card_memory(t: torch.Tensor) -> int:
    """Total memory of the card that holds ``t``; 0 off a card."""
    if not t.is_cuda:
        return 0
    return torch.cuda.get_device_properties(t.device).total_memory


def _keeps(img_features: torch.Tensor, words_emb: torch.Tensor,
           cap_lens: torch.Tensor) -> bool:
    """Whether K3 keeps its state for the backward: a gradient will be
    taken (grad mode on, and either input needs one) and ``keeps_state``
    holds on the card. Decided before ``apply``: inside ``forward`` grad
    mode is off, and ``ctx.needs_input_grad`` does not see ``no_grad``."""
    if not (torch.is_grad_enabled()
            and (img_features.requires_grad or words_emb.requires_grad)):
        return False
    total = _card_memory(img_features)
    if not total:
        return False
    bi, bt, d, m, t = _check(img_features, words_emb, cap_lens, 0.0)
    return keeps_state(bi, bt, m, d, t, total)


def gloria_similarity(img_features: torch.Tensor, words_emb: torch.Tensor,
                      cap_lens: torch.Tensor, temp1: float = 4.0,
                      temp2: float = 5.0, temp3: float = 10.0) -> torch.Tensor:
    """[B_img, B_txt] float32 GLoRIA similarity matrix of img_features
    [B_img, D, H, W] and words_emb [B_txt, D, T] (caption i's word t valid
    iff t < cap_lens[i]), differentiable in both; the JAX package's
    ``gloria_similarity_pallas``."""
    return GloriaSimilarity.apply(img_features, words_emb, cap_lens,
                                  float(temp1), float(temp2), float(temp3),
                                  _keeps(img_features, words_emb, cap_lens))
