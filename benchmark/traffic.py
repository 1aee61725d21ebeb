"""The general generator of the benchmark's inputs, driven by a traffic
mix's parameters (``benchmark/traffic/<name>.json``) and ``--seed``.

Training: a pool of ``pool_steps`` whole optimizer steps, each ``accum``
micro-batches (the configuration's accumulation) of ``micro_batch``
image-caption pairs. Caption token counts follow
``caption_tokens`` ({"min", "max"}: every step holds the same multiset,
spread evenly over the range, in an order drawn from the seed, so that
every seed asks for the same work); each caption is [CLS], word pieces,
[SEP], padding; ``continuation_share`` of the pieces after the first are
"##" continuations, which the text tower merges into their word. Images are
uniform uint8, labels uniform over ``label_classes``. Everything is made on
the device in a few calls.

Serving: ``pool_waves`` waves of ``wave`` uint8 images in host memory.
"""

from __future__ import annotations

import os
from typing import Dict, List

import torch

VOCAB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                     "bio_clinical_bert_vocab.txt")


def sub_seed(seed: int, stream: int) -> int:
    """A generator seed for one stream of draws (weights, data, noise)."""
    return (int(seed) * 1_000_003 + 7919 * stream) % 2 ** 63


def read_vocab(path: str = VOCAB) -> List[str]:
    with open(path, encoding="utf-8") as f:
        return [line.rstrip("\n") for line in f]


def piece_ids(vocab: List[str], device):
    """(word-start ids, continuation ids): vocabulary entries that open a
    word and "##" entries; special and unused entries are left out."""
    starts = [i for i, w in enumerate(vocab)
              if not w.startswith(("##", "[")) and w]
    conts = [i for i, w in enumerate(vocab) if w.startswith("##")]
    return (torch.tensor(starts, device=device),
            torch.tensor(conts, device=device))


def caption_batch(n: int, tokens: torch.Tensor, share: float, t: int,
                  vocab: List[str], gen: torch.Generator, device
                  ) -> Dict[str, torch.Tensor]:
    """``n`` captions of ``tokens`` [n] tokens each, padded to ``t``: the
    tokenizer's layout (input_ids, attention_mask, token_type_ids,
    segment_ids [n, T] and cap_lens [n], int32)."""
    cls, sep, pad = (vocab.index(w) for w in ("[CLS]", "[SEP]", "[PAD]"))
    starts, conts = piece_ids(vocab, device)
    pos = torch.arange(t, device=device)[None, :]
    pieces = tokens - 2                                         # [n]
    # continuations: a fixed count a caption, at positions 2..L-2 drawn
    # from the seed (the first piece always opens a word)
    n_cont = torch.floor(share * (pieces - 1).clamp(min=0)).long()
    keys = torch.rand((n, t), generator=gen, device=device)
    eligible = (pos >= 2) & (pos <= pieces[:, None])
    keys = torch.where(eligible, keys, 2.0)
    rank = torch.argsort(torch.argsort(keys, dim=1), dim=1)
    cont = eligible & (rank < n_cont[:, None])
    ids_s = starts[torch.randint(len(starts), (n, t), generator=gen,
                                 device=device)]
    ids_c = conts[torch.randint(len(conts), (n, t), generator=gen,
                                device=device)]
    body = (pos >= 1) & (pos <= pieces[:, None])
    ids = torch.where(cont, ids_c, ids_s)
    ids = torch.where(body, ids, pad)
    ids = torch.where(pos == 0, cls, ids)
    last = pos == (tokens - 1)[:, None]
    ids = torch.where(last, sep, ids)
    valid = pos < tokens[:, None]
    # slots: [CLS] 0, a word's pieces the word's slot, [SEP] its own slot
    opens = body & ~cont
    slot = torch.cumsum(opens.long(), dim=1)
    words = opens.sum(1)
    slot = torch.where(last, words[:, None] + 1, slot)
    slot = torch.where(valid, slot, -1)
    i32 = torch.int32
    return {"input_ids": ids.to(i32), "attention_mask": valid.to(i32),
            "token_type_ids": torch.zeros_like(ids, dtype=i32),
            "segment_ids": slot.to(i32), "cap_lens": (words + 1).to(i32)}


def train_pool(traffic: dict, accum: int, max_length: int, image_size: int,
               seed: int, device) -> List[List[Dict[str, torch.Tensor]]]:
    """``pool_steps`` optimizer steps of ``accum`` micro-batches each."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    vocab = read_vocab()
    b = int(traffic["micro_batch"])
    lo, hi = (int(traffic["caption_tokens"][k]) for k in ("min", "max"))
    n = b * accum
    spread = lo + (torch.arange(n, device=device) * (hi - lo + 1)) // n
    steps = []
    for _ in range(int(traffic["pool_steps"])):
        order = torch.randperm(n, generator=gen, device=device)
        caps = caption_batch(n, spread[order], float(
            traffic["continuation_share"]), max_length, vocab, gen, device)
        images = torch.randint(0, 256, (n, image_size, image_size, 3),
                               generator=gen, device=device,
                               dtype=torch.uint8)
        labels = torch.randint(int(traffic["label_classes"]), (n,),
                               generator=gen, device=device,
                               dtype=torch.int32)
        micro = []
        for i in range(accum):
            sl = slice(i * b, (i + 1) * b)
            mb = {k: v[sl] for k, v in caps.items()}
            mb["image"] = images[sl]
            mb["label"] = labels[sl]
            micro.append(mb)
        steps.append(micro)
    return steps


def serve_pool(traffic: dict, image_size: int, seed: int, device):
    """``pool_waves`` waves of ``wave`` uint8 images [n, S, S, 3], made on
    ``device`` and kept in host memory as numpy arrays."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    w = int(traffic["wave"])
    waves = []
    for _ in range(int(traffic["pool_waves"])):
        x = torch.randint(0, 256, (w, image_size, image_size, 3),
                          generator=gen, device=device, dtype=torch.uint8)
        waves.append(x.cpu().numpy())
    return waves
