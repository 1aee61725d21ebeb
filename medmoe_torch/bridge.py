"""JAX parameters → PyTorch ``state_dict``.

Input is the flat ``{'/'-joined flax path: array}`` mapping that
medmoe_tpu/eval/export.py ``_save_weights`` writes to ``weights.npz``. The
port's modules carry the flax names, so a key maps by rule:
  * ``.../LayerNorm_0/{scale,bias}`` → ``....{weight,bias}``
  * Dense ``kernel`` [in, out] → Linear ``weight`` [out, in]
  * Conv ``kernel`` HWIO → Conv2d ``weight`` OIHW
  * Embed ``embedding`` → Embedding ``weight``
  * everything else (biases, the stacked expert bank, the relative-position
    bias table) keeps its name and layout.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn


def torch_key(key: str, ndim: int) -> str:
    """The ``state_dict`` name of the flax parameter ``key`` (of rank
    ``ndim``); raises KeyError for a parameter no rule maps."""
    parts = key.split("/")
    leaf = parts[-1]
    if len(parts) >= 2 and parts[-2] == "LayerNorm_0":
        if leaf not in ("scale", "bias"):
            raise KeyError(f"unmapped LayerNorm parameter {key!r}")
        return ".".join(parts[:-2] + ["weight" if leaf == "scale" else "bias"])
    if leaf == "kernel":
        if ndim not in (2, 4):
            raise KeyError(f"unmapped {ndim}-d kernel {key!r}")
        return ".".join(parts[:-1] + ["weight"])
    if leaf == "embedding":
        return ".".join(parts[:-1] + ["weight"])
    return ".".join(parts)


def _convert(key: str, arr: np.ndarray):
    name = torch_key(key, arr.ndim)
    if key.split("/")[-1] == "kernel":
        # Dense [in, out] → [out, in]; Conv HWIO → OIHW
        arr = arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
    return name, np.array(arr, dtype=np.float32)


def from_jax_params(flat: Mapping[str, np.ndarray],
                    model: Optional[nn.Module] = None
                    ) -> Dict[str, torch.Tensor]:
    """Flat flax params → ``state_dict``. With ``model``, also raises on
    any key that names no parameter of it (unmapped), on any of its
    parameters that no key sets (unset), and on a shape mismatch."""
    sd = {}
    for key, arr in flat.items():
        name, value = _convert(key, np.asarray(arr))
        sd[name] = torch.from_numpy(value)
    if model is not None:
        expected = model.state_dict()
        unmapped = sorted(set(sd) - set(expected))
        unset = sorted(set(expected) - set(sd))
        if unmapped or unset:
            raise KeyError(f"JAX params do not match the model: unmapped "
                           f"{unmapped[:8]} ({len(unmapped)}), unset "
                           f"{unset[:8]} ({len(unset)})")
        bad = [(k, tuple(v.shape), tuple(expected[k].shape))
               for k, v in sd.items() if v.shape != expected[k].shape]
        if bad:
            raise ValueError(f"shape mismatch (key, jax, torch): {bad[:8]}")
    return sd


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """Read a ``weights.npz`` written by medmoe_tpu's exporter."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def load_jax_params(model: nn.Module,
                    flat: Mapping[str, np.ndarray]) -> nn.Module:
    """Copy flat JAX params into ``model`` (every parameter, strictly)."""
    model.load_state_dict(from_jax_params(flat, model), strict=True)
    return model
