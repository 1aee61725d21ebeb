"""The reference's zero-shot classification: class prompts tokenized
(BERT's basic split and greedy longest-match word pieces over the
vocabulary file, [CLS] … [SEP], padded), their sentence embeddings and the
images' global embeddings, both L2-normalized, cosine scores and the
class distribution softmax(temp3 · scores). An image whose router
probabilities tie within a tolerance gets the embedding of each tied
route."""

from __future__ import annotations

import unicodedata
from typing import Dict, List, Sequence

import torch

from .model import MedMoE


def _split(text: str) -> List[str]:
    out, cur = [], ""
    for ch in text:
        cp = ord(ch)
        punct = (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
                 or 123 <= cp <= 126
                 or unicodedata.category(ch).startswith("P"))
        if ch.isspace() or punct:
            if cur:
                out.append(cur)
            cur = ""
            if punct:
                out.append(ch)
        else:
            cur += ch
    return out + ([cur] if cur else [])


def _pieces(word: str, vocab: Dict[str, int]) -> List[str]:
    pieces, start = [], 0
    while start < len(word):
        for end in range(len(word), start, -1):
            sub = word[start:end] if start == 0 else "##" + word[start:end]
            if sub in vocab:
                pieces.append(sub)
                start = end
                break
        else:
            return ["[UNK]"]
    return pieces


def tokenize(texts: Sequence[str], vocab_list: List[str], t: int):
    """input_ids, attention_mask, token_type_ids, segment_ids [n, t]."""
    vocab = {w: i for i, w in enumerate(vocab_list)}
    n = len(texts)
    ids = torch.full((n, t), vocab["[PAD]"], dtype=torch.int64)
    mask = torch.zeros((n, t), dtype=torch.int64)
    segs = torch.full((n, t), -1, dtype=torch.int64)
    for i, text in enumerate(texts):
        toks = [p for w in _split(text) for p in _pieces(w, vocab)][:t - 2]
        toks = ["[CLS]"] + toks + ["[SEP]"]
        slot = 0
        for j, tok in enumerate(toks):
            ids[i, j] = vocab.get(tok, vocab["[UNK]"])
            mask[i, j] = 1
            if j > 0 and not tok.startswith("##"):
                slot += 1
            segs[i, j] = slot
    return {"input_ids": ids, "attention_mask": mask,
            "token_type_ids": torch.zeros_like(ids), "segment_ids": segs}


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


@torch.no_grad()
def class_embeddings(model: MedMoE, prompts: Sequence[str],
                     vocab_list: List[str], t: int, device) -> torch.Tensor:
    batch = {k: v.to(device) for k, v in tokenize(prompts, vocab_list,
                                                    t).items()}
    _, sent = model.text(batch)
    return _unit(sent)


@torch.no_grad()
def image_routes(model: MedMoE, images: torch.Tensor, tie: float,
                 block: int = 64) -> List[List[torch.Tensor]]:
    """Per image, its unit global embedding under the reference's own
    routing, then under each other expert whose router probability lies
    within ``tie`` of the top one (top-1 routing): a route that rounding
    may tip either way."""
    out: List[List[torch.Tensor]] = []
    for i in range(0, images.shape[0], block):
        x = images[i:i + block]
        g, _, probs, (idx, kept) = model.image(x)
        rows = [[e] for e in _unit(g)]
        if idx.shape[1] == 1:
            top = probs.max(dim=-1).values
            for e in range(probs.shape[1]):
                near = torch.nonzero((top - probs[:, e] <= tie)
                                     & (idx[:, 0] != e))[:, 0]
                if near.numel():
                    plan = (torch.full((near.numel(), 1), e,
                                       device=idx.device, dtype=idx.dtype),
                            torch.ones((near.numel(), 1), dtype=torch.bool,
                                       device=idx.device))
                    alt = _unit(model.image(x[near], plan=plan)[0])
                    for r, a in zip(near.tolist(), alt):
                        rows[r].append(a)
        out.extend(rows)
    return out
