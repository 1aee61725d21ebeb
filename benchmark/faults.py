"""Faults planted under the timed path, for the harness's own tests and for
the upper readings of ``calibrate.py``. No benchmark run plants one.

``planted(kind, fault)`` wraps the entry's ``build`` (and, for a wrong
route, the program's routing) for as long as it is open, so that the
entry's run drives a broken program:

- train ``unchanged``: a step that returns its state unchanged;
- train ``half``: half of each micro-batch left out, the mean taken over
  the rest;
- train and serve ``route``: every image sent past its best expert, to the
  next ``k`` (top-1: the second-best);
- serve ``half``: half of each wave's embeddings left out;
- serve ``answer``: the first image's embedding of each wave negated.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = {"train": ("unchanged", "half", "route"),
          "serve": ("half", "answer", "route")}


def _train(fault, built, cell):
    module, state, step, pool = built
    if fault == "route":
        return built
    if fault == "half":
        b = int(cell.traffic["micro_batch"])
        pool = [[{k: v[:b // 2] for k, v in mb.items()} for mb in s]
                for s in pool]
    else:
        def step(st, micro):
            with torch.no_grad():
                losses = [module.loss_fn(mb)[1]["loss"] for mb in micro]
            return st, {"loss": sum(losses) / len(losses)}
    return module, state, step, pool


def _serve(fault, built, cell):
    model, embed, class_emb = built
    if fault == "half":
        def broken(images):
            return embed(images)[:len(images) // 2]
    elif fault == "answer":
        def broken(images):
            emb = embed(images)
            return torch.cat([-emb[:1], emb[1:]])
    else:
        broken = embed
    return model, broken, class_emb


def _past_the_best(original):
    def routing(probs, k):
        idx = original(probs, k + 1)[0][..., 1:]
        vals = torch.gather(probs, -1, idx.long())
        return idx, (vals / vals.sum(-1, keepdim=True)).float()
    return routing


@contextlib.contextmanager
def planted(kind: str, fault: str):
    from benchmark.entries import serve, train

    if fault not in FAULTS[kind]:
        raise ValueError(f"no fault {fault!r} for {kind}")
    entry = train if kind == "train" else serve
    build = entry.build
    entry.build = lambda cell: (_train if kind == "train" else _serve)(
        fault, build(cell), cell)
    patched = []
    if fault == "route":
        from medmoe_torch.models import moe

        patched.append((moe, "topk_routing", moe.topk_routing))
        moe.topk_routing = _past_the_best(moe.topk_routing)
    try:
        yield
    finally:
        entry.build = build
        for mod, name, value in patched:
            setattr(mod, name, value)
