"""Contrastive and router losses of MedMoE pretraining (counterpart of
medmoe_tpu/ops/losses.py, reference src/losses.py).

GLoRIA local is one batched einsum family over [B_text, B_img, M, T] with
caption-length masks, as in the JAX package: position t of caption i is
valid iff t < cap_lens[i]. Products take the loss dtype's values and sum
in float32 (inputs are upcast), as the JAX einsums' preferred_element_type
does.

``GLORIALocalContrastiveLoss`` also takes the fused GLoRIA similarity
(``ops/gloria_attention.py``: kernels K3, K4a and K4b on CUDA tensors,
their plain versions on CPU tensors), with the JAX package's dispatch:
``impl="auto"`` takes it for CUDA tensors, ``agg="sum"`` and a batch above
64, and the einsum path otherwise.

The soft-label losses (``SoftGLORIAGlobalContrastiveLoss``,
``SoftGLORIALocalContrastiveLoss``) score the same similarity matrices
with ``soft_partition_xent``: a tool BERT's text-similarity ``scores``
split each anchor's candidates into positives and negatives by
``thresholds``. The soft local loss's similarity is the hard loss's
dispatch with ``agg="sum"``, so it takes K3/K4 on the card above 64.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from medmoe_torch.models.layers import safe_norm
from medmoe_torch.ops.gloria_attention import (check_kernel_limits,
                                               gloria_similarity)
from medmoe_torch.ops.softmax import softmax_bf16_residual

NEG_INF = -1e30


class GloriaLocalOutput(NamedTuple):
    loss0: torch.Tensor
    loss1: torch.Tensor
    att_maps: Optional[torch.Tensor] = None    # [B, T, H, W] diagonal maps


def _cross_entropy_diag(logits: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy with labels = arange(B)."""
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    return -torch.diagonal(logprobs).sum() / logprobs.shape[0]


def attention_fn(words: torch.Tensor, context: torch.Tensor, temp1: float,
                 word_mask: Optional[torch.Tensor] = None):
    """GLoRIA word-region attention (reference losses.py:698-736), batched
    over (text, image) pairs.

    words [Bt, D, T], context [Bi, D, M], word_mask [Bt, T] bool (True =
    valid word) → (wei_context [Bt, Bi, D, T] f32, attn [Bt, Bi, T, M]).
    A softmax over the valid words, then one over regions scaled by temp1;
    both keep bf16 backward residuals."""
    scores = torch.einsum("bdm,idt->ibmt", context.float(), words.float())
    if word_mask is not None:
        scores = torch.where(word_mask[:, None, None, :], scores, NEG_INF)
    attn = softmax_bf16_residual(scores, -1)                 # over words T
    attn = softmax_bf16_residual(attn * temp1, -2)           # over regions M
    wei_context = torch.einsum("bdm,ibmt->ibdt", context.float(),
                               attn.to(context.dtype).float())
    return wei_context, attn.permute(0, 1, 3, 2)


def cosine_similarity(x1: torch.Tensor, x2: torch.Tensor, dim: int,
                      eps: float = 1e-8) -> torch.Tensor:
    """reference losses.py:690-695 (clamped-denominator cosine)."""
    x1 = x1.float()
    x2 = x2.float()
    w12 = torch.sum(x1 * x2, dim=dim)
    w1 = safe_norm(x1, dim=dim, keepdim=False)
    w2 = safe_norm(x2, dim=dim, keepdim=False)
    return w12 / torch.clamp(w1 * w2, min=eps)


def auto_text_chunk(b: int, m: int, t: int, budget_bytes: int = 2 << 30,
                    n_texts: Optional[int] = None) -> Optional[int]:
    """Largest caption-block size whose rematerialized backward stays under
    a peak-activation budget; None when all texts fit (B=32 at M=3136:
    ≈0.3 GB, so no chunk loop), 8 at B=256. ``b`` is the image count,
    ``n_texts`` the chunked axis' length when it differs."""
    n_texts = b if n_texts is None else n_texts
    per_text = b * m * t * 4 * 3     # scores + attn + cotangents
    chunk = max(1, int(budget_bytes // per_text))
    if chunk >= n_texts:
        return None
    for c in range(chunk, 0, -1):
        if n_texts % c == 0:
            return c
    return 1


def _sim_block(context, words_c, mask_c, lens_c, temp1, temp2, temp3, agg):
    """context [Bi, D, M], words_c [c, D, T], mask_c [c, T] → (sim [c, Bi],
    attn)."""
    wei_context, attn = attention_fn(words_c, context, temp1, mask_c)
    row_sim = cosine_similarity(words_c[:, None], wei_context, dim=2)
    row_sim = row_sim * temp2
    row_sim = torch.where(mask_c[:, None, :], torch.exp(row_sim), 0.0)
    if agg == "sum":
        s = torch.sum(row_sim, dim=-1)                       # [c, Bi]
    else:
        s = torch.sum(row_sim, dim=-1) / torch.clamp(lens_c[:, None], min=1)
    return torch.log(s) * temp3, attn


def gloria_local_similarities(img_features: torch.Tensor,
                              words_emb: torch.Tensor, cap_lens: torch.Tensor,
                              temp1: float = 4.0, temp2: float = 5.0,
                              temp3: float = 10.0, agg: str = "sum",
                              text_chunk: Any = "auto") -> torch.Tensor:
    """The einsum path's [B_img, B_txt] similarity matrix of img_features
    [B_img, D, H, W] against words_emb [B_txt, D, T]:
    similarities[b_img, i_text] = temp3 · log Σ_{t<cap_len_i} exp(temp2 ·
    cos(word, attended context)). B_img and B_txt may differ (a rank's
    images against every rank's captions).

    ``text_chunk`` bounds peak memory: the [Bt, Bi, M, T] tensors are built
    for ``text_chunk`` captions at a time, each block under
    ``torch.utils.checkpoint`` (recomputed in the backward) — the same
    numbers. None → one pass."""
    bi, d, h, w = img_features.shape
    bt, t = words_emb.shape[0], words_emb.shape[-1]
    if text_chunk == "auto":
        text_chunk = auto_text_chunk(bi, h * w, t, n_texts=bt)
    context = img_features.reshape(bi, d, h * w)
    word_mask = torch.arange(t, device=cap_lens.device)[None, :] \
        < cap_lens[:, None]                                  # [Bt, T]
    temps = (temp1, temp2, temp3, agg)
    if text_chunk and bt > text_chunk and bt % text_chunk == 0:
        blocks = [checkpoint(lambda *a: _sim_block(context, *a, *temps)[0],
                             words_emb[i:i + text_chunk],
                             word_mask[i:i + text_chunk],
                             cap_lens[i:i + text_chunk], use_reentrant=False)
                  for i in range(0, bt, text_chunk)]
        sim = torch.cat(blocks, dim=0)                       # [i, b]
    else:
        sim = _sim_block(context, words_emb, word_mask, cap_lens, *temps)[0]
    return sim.T                                             # [b_img, i_text]


def gloria_local_loss(img_features: torch.Tensor, words_emb: torch.Tensor,
                      cap_lens: torch.Tensor, temp1: float = 4.0,
                      temp2: float = 5.0, temp3: float = 10.0,
                      agg: str = "sum", return_att_maps: bool = False,
                      text_chunk: Any = "auto") -> GloriaLocalOutput:
    """Batched GLoRIA local (word-region) contrastive loss.

    img_features [B, D, H, W]; words_emb [B, D, T]; cap_lens [B] int.
    The symmetric cross entropy on the B×B matrix of
    ``gloria_local_similarities`` (whose ``text_chunk`` it takes);
    ``return_att_maps`` adds the diagonal attention maps (one pass)."""
    b, d, h, w = img_features.shape
    t = words_emb.shape[-1]
    att_maps = None
    if return_att_maps:
        context = img_features.reshape(b, d, h * w)
        word_mask = torch.arange(t, device=cap_lens.device)[None, :] \
            < cap_lens[:, None]
        sim, attn = _sim_block(context, words_emb, word_mask, cap_lens,
                               temp1, temp2, temp3, agg)
        similarities = sim.T
        diag = torch.diagonal(attn, dim1=0, dim2=1)          # [T, M, B]
        att_maps = diag.permute(2, 0, 1).reshape(b, t, h, w)
    else:
        similarities = gloria_local_similarities(
            img_features, words_emb, cap_lens, temp1, temp2, temp3, agg,
            text_chunk)
    loss0 = _cross_entropy_diag(similarities)
    loss1 = _cross_entropy_diag(similarities.T)
    return GloriaLocalOutput(loss0=loss0, loss1=loss1, att_maps=att_maps)


def global_similarities(cnn_code: torch.Tensor, rnn_code: torch.Tensor,
                        temp3: float = 10.0,
                        eps: float = 1e-8) -> torch.Tensor:
    """[B_img, B_txt] float32 cosines of the global codes, times temp3."""
    cnn = cnn_code.float()
    rnn = rnn_code.float()
    scores = cnn @ rnn.T
    norms = safe_norm(cnn) @ safe_norm(rnn).T
    return scores / torch.clamp(norms, min=eps) * temp3


def gloria_global_loss(cnn_code: torch.Tensor, rnn_code: torch.Tensor,
                       temp3: float = 10.0, eps: float = 1e-8) -> torch.Tensor:
    """Batch cosine-similarity InfoNCE (reference
    GLORIAGlobalContrastiveLoss.forward, losses.py:766-794)."""
    scores = global_similarities(cnn_code, rnn_code, temp3, eps)
    return _cross_entropy_diag(scores) + _cross_entropy_diag(scores.T)


def soft_xent(target: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """reference softXEnt (losses.py:796-803)."""
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    return -torch.sum(target * logprobs) / logits.shape[0]


def soft_xent_penalty(target: torch.Tensor, logits: torch.Tensor,
                      penalty: torch.Tensor) -> torch.Tensor:
    """reference softXEntPenalty (losses.py:805-812): a per-element
    penalty weight inside the soft cross entropy."""
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    return -torch.sum(target * logprobs * penalty) / logits.shape[0]


def _relu(x: torch.Tensor) -> torch.Tensor:
    # max(x, 0) with jnp.maximum's gradient: half to each side of a tie
    return torch.maximum(x, torch.zeros_like(x))


def hard_negative_loss(imgs: torch.Tensor, caps: torch.Tensor, nmax: int = 1,
                       margin: float = 0.2) -> torch.Tensor:
    """Margin loss over the ``nmax`` hardest negatives of each image and
    each caption (reference HardNegativeContrastiveLoss,
    losses.py:885-927); the diagonal is negated so that it is never
    picked. Each side is normalized in its own dtype and the product
    taken in the promoted one, as jnp's ``@`` promotes (the towers hand
    a float32 image code and a bf16 caption code)."""
    dt = torch.promote_types(imgs.dtype, caps.dtype)
    imgs = (imgs / safe_norm(imgs)).to(dt)
    caps = (caps / safe_norm(caps)).to(dt)
    scores = (imgs @ caps.T).float()
    eye = torch.eye(scores.shape[0], dtype=scores.dtype, device=scores.device)
    diag = torch.sum(scores * eye, dim=1)
    scores = scores - 2.0 * scores * eye
    top_c = torch.topk(scores.T, nmax, dim=1).values.T       # [nmax, B]
    top_i = torch.topk(scores, nmax, dim=1).values           # [B, nmax]
    neg_cap = torch.sum(_relu(top_c + (margin - diag)[None, :]))
    neg_img = torch.sum(_relu(top_i + (margin - diag)[:, None]))
    return neg_cap + neg_img


def soft_partition_xent(sim: torch.Tensor, scores: torch.Tensor,
                        thresholds) -> torch.Tensor:
    """The soft-label cross entropy of a similarity matrix ``sim`` [B, B]
    (rows the anchors), the JAX package's ``one_direction``
    (medmoe_tpu/ops/losses.py:371-416; reference losses.py:814-883).

    ``scores`` [B, B] (the tool BERT's text similarity) and ``thresholds``
    (thr_pos, thr_neg) mark anchor a's positives, scores > thr_pos, and
    its negatives, scores <= thr_neg. Each positive j is scored against
    the anchor's negatives N: log Σ exp over [sim[a, j]; sim[a, N]] minus
    sim[a, j], divided by 1 + |N| (softXEnt over the concatenation);
    averaged over the anchor's positives (at least 1), summed over the
    anchors / B. The log-sum-exp is one [B, B, B] tensor."""
    thr_pos, thr_neg = thresholds
    pos = scores > thr_pos
    neg = scores <= thr_neg
    negv = torch.where(neg, sim, NEG_INF)
    m = torch.maximum(sim, torch.amax(negv, dim=1)[:, None])
    terms = torch.where(neg[:, None, :],
                        torch.exp(negv[:, None, :] - m[..., None]), 0.0)
    lse = torch.log(torch.exp(sim - m) + torch.sum(terms, dim=-1)) + m
    cat_len = torch.clamp(1 + torch.sum(neg, dim=1), min=1)[:, None]
    per_pos = (lse - sim) / cat_len                  # [B(anchor), B(pos)]
    n_pos = torch.clamp(torch.sum(pos, dim=1), min=1)
    per_anchor = torch.sum(torch.where(pos, per_pos, 0.0), dim=1) / n_pos
    return torch.sum(per_anchor) / sim.shape[0]


def _require_scores(loss, scores, thresholds) -> None:
    if scores is None or thresholds is None:
        raise ValueError(
            f"{type(loss).__name__} scores against the tool BERT's text "
            f"similarity: it needs scores and thresholds (set "
            f"model.loss.soft_label: true)")


def router_classification_loss(router_probs: torch.Tensor,
                               labels: torch.Tensor) -> torch.Tensor:
    """Cross entropy on top of the ALREADY-SOFTMAXED router outputs — the
    reference's double softmax (swin.py:99, medmoe_module.py:305), kept.
    A label outside the expert range selects nothing, as jax's one_hot."""
    logprobs = torch.log_softmax(router_probs.float(), dim=-1)
    k = logprobs.shape[-1]
    onehot = (labels.long()[:, None]
              == torch.arange(k, device=labels.device)[None, :]).float()
    return -torch.mean(torch.sum(logprobs * onehot, dim=1))


def router_accuracy(router_probs: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(router_probs, dim=-1) == labels.long())
                      .float())


# --------------------------------------------------------------------------
# config-surface loss classes (the reference's _target_ registry)
# --------------------------------------------------------------------------

class GLORIAGlobalContrastiveLoss:
    def __call__(self, cnn_code, rnn_code, temp3=10.0, scores=None,
                 thresholds=None):
        return gloria_global_loss(cnn_code, rnn_code, temp3)


class ZEROGlobalContrastiveLoss:
    """Ablation stub returning 0 (reference losses.py:740-755)."""

    def __call__(self, cnn_code, rnn_code, temp3=10.0, scores=None,
                 thresholds=None):
        return torch.zeros((), device=cnn_code.device)


class GLORIALocalContrastiveLoss:
    """The local loss by one of two functions (the names are the JAX
    config's):

    - ``impl="xla"``: the batched einsum path, ``gloria_local_loss``;
    - ``impl="pallas"``: the fused similarity ``gloria_similarity`` — the
      kernels K3/K4 on CUDA tensors, their plain versions on CPU tensors —
      then the symmetric cross entropy. Like the JAX kernel it computes
      ``agg="sum"`` whatever ``agg`` says;
    - ``impl="auto"`` (default): the JAX package's ``_resolve_impl`` with
      "on the TPU" read as "the tensors are on CUDA": the fused path for
      CUDA tensors, ``agg="sum"`` and a batch above 64, the einsum path
      otherwise.

    ``pair_losses`` turns the similarity matrix into (loss0, loss1): here
    the cross entropy with the diagonal as the labels, both ways."""

    def __init__(self, text_chunk: Any = "auto", impl: str = "auto"):
        if impl not in ("auto", "xla", "pallas"):
            raise ValueError(f"impl must be auto, xla or pallas, got {impl!r}")
        self.text_chunk = text_chunk
        self.impl = impl

    def resolve_impl(self, agg: str, img_features: torch.Tensor) -> str:
        return self.impl_for(agg, img_features.shape[0], img_features.is_cuda)

    def impl_for(self, agg: str, batch: Optional[int], on_cuda: bool) -> str:
        """``resolve_impl`` from the batch size alone; an unknown batch
        (None) counts as one the fused path would take."""
        if self.impl != "auto":
            return self.impl
        fused = on_cuda and agg == "sum" and (batch is None or batch > 64)
        return "pallas" if fused else "xla"

    def similarities(self, img_features, words_emb, cap_lens, temp1=4.0,
                     temp2=5.0, temp3=10.0, agg="sum",
                     batch: Optional[int] = None) -> torch.Tensor:
        """The [B_img, B_txt] similarity matrix by the path ``impl_for``
        picks for a batch of ``batch`` pairs (None: B_img) — a rank's
        images against all ranks' captions under global negatives, where
        the batch the dispatch reads is the global one."""
        batch = img_features.shape[0] if batch is None else batch
        if self.impl_for(agg, batch, img_features.is_cuda) == "pallas":
            if img_features.is_cuda:       # before the kernels' first launch
                check_kernel_limits(img_features.shape[1], words_emb.shape[2],
                                    temp1)
            return gloria_similarity(img_features, words_emb, cap_lens,
                                     temp1, temp2, temp3)
        return gloria_local_similarities(img_features, words_emb, cap_lens,
                                         temp1, temp2, temp3, agg,
                                         text_chunk=self.text_chunk)

    def pair_losses(self, sim: torch.Tensor, scores=None, thresholds=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss0, loss1) of the [B_img, B_txt] similarity matrix ``sim``."""
        return _cross_entropy_diag(sim), _cross_entropy_diag(sim.T)

    def __call__(self, img_features, words_emb, cap_lens, temp1=4.0,
                 temp2=5.0, temp3=10.0, agg="sum", scores=None,
                 thresholds=None):
        sim = self.similarities(img_features, words_emb, cap_lens, temp1,
                                temp2, temp3, agg)
        loss0, loss1 = self.pair_losses(sim, scores, thresholds)
        return GloriaLocalOutput(loss0=loss0, loss1=loss1)


class ZEROLocalContrastiveLoss:
    def __call__(self, img_features, words_emb, cap_lens, temp1=4.0,
                 temp2=5.0, temp3=10.0, agg="sum", scores=None,
                 thresholds=None):
        zero = torch.zeros((), device=img_features.device)
        return GloriaLocalOutput(loss0=zero, loss1=zero)


class HardNegativeContrastiveLoss:
    """``hard_negative_loss`` on the global codes (reference
    losses.py:885-927)."""

    def __init__(self, nmax: int = 1, margin: float = 0.2):
        self.nmax = nmax
        self.margin = margin

    def __call__(self, imgs, caps, temp3=10.0, scores=None, thresholds=None):
        return hard_negative_loss(imgs, caps, self.nmax, self.margin)


class SoftGLORIAGlobalContrastiveLoss:
    """Soft-label global loss (reference losses.py:814-883): the global
    codes' cosines times temp3, scored by ``soft_partition_xent`` both
    ways."""

    reads_scores = True

    def __call__(self, cnn_code, rnn_code, temp3=10.0, scores=None,
                 thresholds=None):
        _require_scores(self, scores, thresholds)
        sim = global_similarities(cnn_code, rnn_code, temp3)
        return soft_partition_xent(sim, scores, thresholds) \
            + soft_partition_xent(sim.T, scores, thresholds)


class SoftGLORIALocalContrastiveLoss(GLORIALocalContrastiveLoss):
    """Soft-label local loss (reference losses.py:1111-1214): the hard
    loss's similarity matrix with ``agg="sum"`` whatever ``agg`` says (so
    the same dispatch: K3/K4 for CUDA tensors above 64), scored by
    ``soft_partition_xent`` both ways."""

    reads_scores = True

    def impl_for(self, agg: str, batch: Optional[int], on_cuda: bool) -> str:
        return super().impl_for("sum", batch, on_cuda)

    def similarities(self, img_features, words_emb, cap_lens, temp1=4.0,
                     temp2=5.0, temp3=10.0, agg="sum",
                     batch: Optional[int] = None) -> torch.Tensor:
        return super().similarities(img_features, words_emb, cap_lens, temp1,
                                    temp2, temp3, "sum", batch)

    def pair_losses(self, sim: torch.Tensor, scores=None, thresholds=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        _require_scores(self, scores, thresholds)
        return (soft_partition_xent(sim, scores, thresholds),
                soft_partition_xent(sim.T, scores, thresholds))
