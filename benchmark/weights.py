"""Seeded weights for the program and the reference alike.

Every parameter is filled in place from one ``torch.Generator`` on the
model's device, by its name, with the init laws of the port's
``init_weights`` (flax's defaults): lecun-normal kernels (a normal truncated
at two standard deviations, variance 1/fan_in; an expert bank's fan-in is
K·D_in), zero biases, unit norm scales, normal(1/sqrt(width)) embeddings,
a truncated-normal(0.02) relative-position-bias table. The draws are made
in two large calls (one uniform for every truncated normal, one normal for
every embedding) over the parameters sorted by name, so the program and the
reference, whose parameters carry the same names, get the same numbers.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

_TRUNC = .87962566103423978       # std of a unit normal truncated at ±2


def law(name: str, shape: Tuple[int, ...]) -> Tuple[str, float]:
    """(kind, scale) of a parameter: kind is "trunc" (truncated normal of
    std ``scale``), "normal", "one" or "zero"."""
    leaf = name.rsplit(".", 1)[-1]
    owner = name.rsplit(".", 2)[-2] if name.count(".") else ""
    if leaf == "relative_position_bias_table":
        return "trunc", 0.02
    if ".experts." in name or name.startswith("experts."):
        if "_w" in leaf:
            return "trunc", math.sqrt(1.0 / (shape[0] * shape[1])) / _TRUNC
        return "zero", 0.0
    if owner.endswith("_embeddings") and leaf == "weight":
        return "normal", 1.0 / math.sqrt(shape[1])
    if leaf == "bias":
        return "zero", 0.0
    if len(shape) == 1:                 # a norm's scale
        return "one", 1.0
    fan_in = math.prod(shape[1:])
    return "trunc", math.sqrt(1.0 / fan_in) / _TRUNC


@torch.no_grad()
def fill(named: Iterable[Tuple[str, torch.Tensor]], seed: int) -> None:
    """Fill every named parameter in place from ``seed``."""
    params: Dict[str, torch.Tensor] = dict(named)
    names = sorted(params)
    dev = params[names[0]].device
    gen = torch.Generator(device=dev).manual_seed(int(seed) % 2 ** 63)
    groups = {"trunc": [], "normal": []}
    for n in names:
        p = params[n]
        kind, scale = law(n, tuple(p.shape))
        if kind == "zero":
            p.zero_()
        elif kind == "one":
            p.fill_(1.0)
        else:
            groups[kind].append((p, scale))
    lo = (1 + math.erf(-2 / math.sqrt(2))) / 2
    hi = (1 + math.erf(2 / math.sqrt(2))) / 2
    for kind, items in groups.items():
        total = sum(p.numel() for p, _ in items)
        if not total:
            continue
        if kind == "trunc":
            u = torch.rand(total, generator=gen, device=dev) * (hi - lo) + lo
            draw = torch.erfinv(u.mul_(2).sub_(1)).mul_(math.sqrt(2))
        else:
            draw = torch.randn(total, generator=gen, device=dev)
        at = 0
        for p, scale in items:
            n = p.numel()
            p.copy_(draw[at:at + n].view(p.shape).mul_(scale))
            at += n
        del draw
