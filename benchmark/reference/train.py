"""The reference's optimizer steps: the first steps of the timed training
step, followed in float32 (or, as the control, float8 products).

A micro-batch's gradient is taken in blocks of rows, so that the whole
batch's losses (global negatives) fit: the forward once without gradients
(drawing the training-mode noise in the program's order), the losses'
gradient with respect to the towers' outputs, then each block's forward
again with the same noise and routing, and its backward from those
cotangents. The step then averages the micro-batches' gradients, clips them
by their global norm and takes an Adam step (L2 decay none), as the
configuration states.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from .model import MedMoE, Noise, total_loss


def _micro_grad(model: MedMoE, batch, loss_cfg, noise: Noise, block: int,
                train_text: bool, route=None) -> Tuple[float, object, int]:
    """(the loss, the routing taken, the rows routed otherwise than
    ``route`` beyond its tie)."""
    with torch.no_grad():
        txt_l, txt_g = model.text(batch, noise)
        img_g, img_l, probs, plan = model.image(batch["image"], noise)
    missed = 0
    if route is not None:
        other, tie = route
        own = plan
        plan, missed = model.image_encoder.swin_moe.moe.follow_ties(
            probs, own, other, tie)
        if not torch.equal(plan[0], own[0]):
            with torch.no_grad():       # the same noise, replayed
                img_g, img_l, probs, _ = model.image(
                    batch["image"], noise, slice(None), plan)
    leaves = [t.detach().requires_grad_(i < 3 or train_text)
              for i, t in enumerate((img_g, img_l, probs, txt_l, txt_g))]
    loss = total_loss(leaves, batch, loss_cfg, model.num)
    cots = torch.autograd.grad(loss, [t for t in leaves if t.requires_grad])
    b = img_g.shape[0]
    for r in range(0, b, block):
        rows = slice(r, min(b, r + block))
        plan_r = tuple(p[rows] for p in plan)
        g, l_, pr, _ = model.image(batch["image"][rows], noise, rows, plan_r)
        torch.autograd.backward([g, l_, pr],
                                [cots[0][rows], cots[1][rows], cots[2][rows]])
        if train_text:
            tl, tg = model.text(batch, noise, rows)
            torch.autograd.backward([tl, tg], [cots[3][rows], cots[4][rows]])
    return float(loss.detach()), plan[0], missed


def follow(model: MedMoE, steps: List[List[dict]], loss_cfg: dict, lr: float,
           clip: float, noise_gen: torch.Generator, block: int = 32,
           b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
           routes: Optional[List[torch.Tensor]] = None, tie: float = 0.0
           ) -> Dict[str, object]:
    """Run ``steps`` (each a list of micro-batches) from the model's present
    weights. Returns {"loss": [each step's mean loss], "micro_loss": [each
    micro-batch's loss], "grad1": {name: norm
    of the first step's clipped gradient} over the trainable parameters,
    "change": {name: norm of the change after the steps} over all,
    "frozen": the names of the parameters that do not train, "routes":
    each micro-batch's expert ids}. With ``routes`` (another side's expert
    ids, a micro-batch each) the reference takes that side's route where
    its own router ties within ``tie``, and counts in "route_miss" the
    rows routed otherwise beyond it."""
    params = dict(model.named_parameters())
    train_text = any(p.requires_grad for n, p in params.items()
                     if n.startswith("text_encoder."))
    trainable = {n: p for n, p in params.items() if p.requires_grad}
    start = {n: p.detach().clone() for n, p in trainable.items()}
    m = {n: torch.zeros_like(p) for n, p in trainable.items()}
    v = {n: torch.zeros_like(p) for n, p in trainable.items()}
    out = {"loss": [], "micro_loss": [], "grad1": {},
           "frozen": sorted(set(params) - set(trainable)), "routes": [],
           "route_miss": 0}
    n_micro = sum(len(micro) for micro in steps)
    if routes is not None and len(routes) != n_micro:
        raise ValueError(f"{len(routes)} routes for {n_micro} micro-batches")
    for t, micro in enumerate(steps, start=1):
        for p in trainable.values():
            p.grad = None
        losses = []
        for batch in micro:
            noise = Noise(noise_gen)
            route = None if routes is None else \
                (routes[len(out["routes"])], tie)
            loss, idx, missed = _micro_grad(model, batch, loss_cfg, noise,
                                            block, train_text, route)
            losses.append(loss)
            out["routes"].append(idx)
            out["route_miss"] += missed
        out["loss"].append(sum(losses) / len(losses))
        out["micro_loss"].extend(losses)
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 / len(micro) for n, p in trainable.items()}
        norm = math.sqrt(sum(float(torch.sum(g * g)) for g in grads.values()))
        if clip and norm >= clip:
            grads = {n: g * (clip / norm) for n, g in grads.items()}
        if t == 1:
            out["grad1"] = {n: float(torch.linalg.vector_norm(g))
                            for n, g in grads.items()}
        with torch.no_grad():
            for n, p in trainable.items():
                g = grads[n]
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[n].sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
                p.addcdiv_(m[n], denom, value=-lr / (1 - b1 ** t))
                p.grad = None
    out["change"] = {n: float(torch.linalg.vector_norm(p.detach() - start[n]))
                     if n in start else 0.0 for n, p in params.items()}
    return out
