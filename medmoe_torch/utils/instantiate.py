"""``_target_``-driven object instantiation (hydra.utils.instantiate analogue).

Mirrors the reference's use of hydra instantiation
(reference src/utils/instantiators.py:13-56, src/train.py:58-73) without hydra.
"""

from __future__ import annotations

import functools
import importlib
from typing import Any, Mapping

from medmoe_torch.config import DotDict


def _locate(target: str) -> Any:
    module_name, _, attr = target.rpartition(".")
    if not module_name:
        raise ValueError(f"_target_ must be a dotted path, got {target!r}")
    module = importlib.import_module(module_name)
    return getattr(module, attr)


def instantiate(cfg: Any, *args: Any, **overrides: Any) -> Any:
    """Instantiate an object from a config node containing ``_target_``.

    ``_partial_: true`` returns a functools.partial instead of calling.
    Nested dicts containing ``_target_`` are instantiated recursively.
    """
    if cfg is None:
        return None
    if not isinstance(cfg, Mapping):
        return cfg
    if "_target_" not in cfg:
        return cfg

    kwargs = {}
    partial = False
    target = None
    for key, value in cfg.items():
        if key == "_target_":
            target = value
        elif key == "_partial_":
            partial = bool(value)
        elif isinstance(value, Mapping) and "_target_" in value:
            kwargs[key] = instantiate(value)
        else:
            kwargs[key] = value
    kwargs.update(overrides)
    missing = [k for k, v in kwargs.items()
               if isinstance(v, str) and v == "???"]
    if missing:
        # hydra MISSING semantics: composing a group file that marks a field
        # '???' (e.g. callbacks/early_stopping.yaml monitor) requires the
        # experiment/CLI to fill it in before instantiation
        raise ValueError(
            f"missing mandatory value(s) {missing} for {target}: marked "
            f"'???' in config — set them via an experiment overlay or CLI "
            f"override")

    fn = _locate(target)
    if partial:
        return functools.partial(fn, *args, **kwargs)
    return fn(*args, **kwargs)
