"""The numbers that decide ``correct``: what the timed path produced against
the plain reference, each with its limit from the configuration's
``compare`` settings.

Training (the first optimizer steps, by leaf = parameter tensor):

- ``loss``: the largest gap of a step's mean loss, relative to the
  reference's; ``loss_micro`` the root mean square of the micro-batches'
  relative gaps, ``loss_micro_max`` their largest;
- ``grad``: the first step's gradient as the optimizer got it (clipped;
  the program's worked out from Adam's first moment after one step), the
  worst leaf's gap of norms against the larger of that leaf's reference
  norm and the median leaf's; ``grad_p90`` and ``grad_median`` the
  gap of the leaf at the 90th percentile and the median;
- ``change``: the same of the parameters' change after the steps, over
  the leaves whose reference gradient is at least a thousandth of the
  median leaf's (a key's bias under softmax moves by round-off alone);
  ``change_median`` the median leaf's;
- ``frozen``: the largest change of a parameter the configuration freezes;
- ``route_miss``, where the configuration sets ``route_tie``: the images
  the program routed otherwise than the reference beyond that tie (the
  reference takes the program's route where its own router ties within
  it).

Serving (the records of sampled waves; an image whose reference router
probabilities tie within ``route_tie`` is held to the nearer of the tied
routes):

- ``embedding``: the largest distance of a served unit embedding from the
  reference's;
- ``probs``: the largest gap of a served class probability;
- ``label``: the largest margin by which the reference's logit
  (temp3 · cosine) of the served label lies below its best;
- ``missing``: images of the sampled waves without a record.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Tuple

#: (name, value, limit); a limit of None reports the number uncompared
Numbers = List[Tuple[str, float, Optional[float]]]


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               names: List[str]) -> Dict[str, float]:
    """Per leaf, the gap of norms against the larger of the leaf's
    reference norm and the median leaf's."""
    med = statistics.median(ref[n] for n in names)
    return {n: abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], med, 1e-30)
            for n in names}


def _quantile(values, q: float) -> float:
    v = sorted(values)
    return v[min(len(v) - 1, int(q * len(v)))]


def train_numbers(prog: dict, ref: dict, limits: dict) -> Numbers:
    """The training numbers, each with its limit (None: reported, not
    compared)."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    if len(prog["loss"]) != len(ref["loss"]):
        loss = float("inf")
    micro = [abs(p - r) / abs(r) for p, r in zip(prog["micro_loss"],
                                                   ref["micro_loss"])]
    if len(prog["micro_loss"]) != len(ref["micro_loss"]):
        micro = [float("inf")]
    names = sorted(ref["grad1"])
    med = statistics.median(ref["grad1"][n] for n in names)
    moved = [n for n in names if ref["grad1"][n] >= 1e-3 * med]
    grad = _leaf_gaps(prog["grad1"], ref["grad1"], names)
    change = _leaf_gaps(prog["change"], ref["change"], moved)
    frozen = max((prog["change"].get(n, float("inf")) for n in ref["frozen"]),
                 default=0.0)
    values = {"loss": loss,
              "loss_micro": statistics.fmean(x * x for x in micro) ** 0.5,
              "loss_micro_max": max(micro),
              "grad": max(grad.values()),
              "grad_p90": _quantile(grad.values(), 0.9),
              "grad_median": statistics.median(grad.values()),
              "change": max(change.values()),
              "change_median": statistics.median(change.values()),
              "frozen": frozen}
    if routes_followed(limits):
        values["route_miss"] = float(ref["route_miss"])
    return [(n, v, limits.get(n)) for n, v in values.items()]


def routes_followed(limits: dict) -> bool:
    """Whether the reference follows the program's route where its router
    ties (the configuration's ``route_tie``)."""
    return limits.get("route_tie") is not None


def worst_leaves(prog: dict, ref: dict,
                 k: int = 3) -> List[Tuple[str, float, float, float]]:
    """The ``k`` leaves of the largest first-gradient gap: (name, gap,
    the program's norm, the reference's)."""
    names = sorted(ref["grad1"])
    gaps = _leaf_gaps(prog["grad1"], ref["grad1"], names)
    top = sorted(gaps, key=gaps.get, reverse=True)[:k]
    return [(n, gaps[n], prog["grad1"].get(n, 0.0), ref["grad1"][n])
            for n in top]


def serve_numbers(served: List[dict], ref: List[List[dict]], limits: dict,
                  temp3: float) -> Numbers:
    """``served``: per sampled image, {"embedding": [D] or None, "probs":
    {class: p} or None, "label": name or None}. ``ref``: per image, the
    reference's candidates {"embedding", "sims": {class: cosine}, "probs"},
    its own route first and then each route tied within ``route_tie``; a
    served image is held to the candidate nearest its embedding."""
    emb = probs = label = 0.0
    missing = abs(len(served) - len(ref))
    for s, cands in zip(served, ref):
        if s.get("probs") is None or s.get("label") not in cands[0]["sims"]:
            missing += 1
            continue
        r = cands[0]
        if s.get("embedding") is not None:
            dist = [_dist(s["embedding"], c["embedding"]) for c in cands]
            r = cands[dist.index(min(dist))]
            emb = max(emb, min(dist))
        probs = max(probs, max(abs(s["probs"].get(c, -1.0) - p)
                               for c, p in r["probs"].items()))
        best = max(r["sims"].values())
        label = max(label, temp3 * (best - r["sims"][s["label"]]))
    values = {"embedding": emb, "probs": probs, "label": label,
              "missing": float(missing)}
    return [(n, v, limits.get(n)) for n, v in values.items()]


def _dist(a, b) -> float:
    return sum((x - y) ** 2 for x, y in zip(a, b)) ** 0.5
