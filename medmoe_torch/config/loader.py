"""Hydra-style YAML config composition, dependency-free.

Re-creates the config surface of the reference (hydra 1.3 config groups under
``configs/``: data / model / trainer / experiment / debug / paths / extras /
logger — see reference ``configs/train.yaml``) so that
``compose("train", ["experiment=pretraining_medmoe"])`` works identically,
without requiring hydra/omegaconf at runtime.

Supported subset (everything the reference configs actually use):
  * ``defaults:`` lists with ``group: option``, ``optional group: option``,
    ``/group: option`` (absolute), ``_self_``, and ``null`` options.
  * ``# @package _global_`` header → file merges at the root.
  * Nested defaults inside group files (e.g. a model config that inherits a
    base model config).
  * CLI-style overrides: ``group=option`` swaps a defaults-group selection,
    ``a.b.c=value`` sets a leaf, ``+a.b=v`` adds a new key, ``~a.b`` deletes.
  * ``${a.b.c}`` interpolation resolved after the final merge.
  * ``${now:%Y-%m-%d}`` timestamp resolver (hydra's run-dir templating,
    reference ``configs/hydra/default.yaml:10-13``). The stamp is captured
    once per compose() so every occurrence in one config agrees, and honors
    ``MEDMOE_RUN_STAMP`` (unix seconds) so multi-process SPMD runs — whose
    collective checkpoint saves require a byte-identical output_dir on every
    process — can pin a shared value. The DEFAULT paths config stays
    untimestamped for that same reason (documented divergence, PARITY.md);
    opt in via ``configs/local`` or a ``paths.output_dir=...`` override.
"""

from __future__ import annotations

import copy
import functools
import os
import re
from typing import Any, Iterable, List, Mapping, Optional

DEFAULT_CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs")

_INTERP_RE = re.compile(r"\$\{([^}]+)\}")
_MISSING = object()      # select() sentinel: distinguishes absent from None


class DotDict(dict):
    """dict with attribute access, recursively applied (mini-OmegaConf)."""

    def __init__(self, data: Optional[Mapping[str, Any]] = None, **kw: Any):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = v
        for k, v in kw.items():
            self[k] = v

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, DotDict):
            return value
        if isinstance(value, Mapping):
            return DotDict(value)
        if isinstance(value, (list, tuple)):
            return [DotDict._wrap(v) for v in value]
        return value

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, DotDict._wrap(value))

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __delattr__(self, key: str) -> None:
        try:
            del self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def select(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, Mapping) or part not in node:
                return default
            node = node[part]
        return node

    def set_dotted(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node: Any = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], Mapping):
                node[part] = {}
            node = node[part]
        node[parts[-1]] = value

    def delete_dotted(self, dotted: str) -> None:
        """Delete a dotted path. Tolerates literal keys that themselves
        contain dots (e.g. hparams_search params like
        'params.model.optimizer.lr' where 'model.optimizer.lr' is ONE key):
        at each level the longest matching literal key wins."""
        parts = dotted.split(".")
        node: Any = self
        i = 0
        while i < len(parts):
            # longest literal-key match from the remaining parts
            for j in range(len(parts), i, -1):
                candidate = ".".join(parts[i:j])
                if isinstance(node, Mapping) and candidate in node:
                    if j == len(parts):
                        del node[candidate]
                        return
                    node = node[candidate]
                    i = j
                    break
            else:
                raise KeyError(dotted)

    def copy(self) -> "DotDict":
        return copy.deepcopy(self)


def to_dict(cfg: Any) -> Any:
    """Recursively convert DotDict back to plain python containers."""
    if isinstance(cfg, Mapping):
        return {k: to_dict(v) for k, v in cfg.items()}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    return cfg


def merge(base: DotDict, overlay: Mapping[str, Any]) -> DotDict:
    """Deep-merge ``overlay`` into ``base`` (in place); overlay wins."""
    for key, value in overlay.items():
        if (
            key in base
            and isinstance(base[key], Mapping)
            and isinstance(value, Mapping)
        ):
            merge(base[key], value)
        else:
            base[key] = value
    return base


@functools.lru_cache(maxsize=1)
def _yaml_loader():
    """SafeLoader + YAML-1.2 floats: PyYAML's 1.1 resolver requires a dot
    in the mantissa AND a signed exponent, so ``1e-5`` / ``5e-5`` — the
    standard hydra/OmegaConf way to write learning rates — silently load
    as STRINGS. Plain ints still win: the int resolver registered first
    matches dot-less, exponent-less digits.

    Built on first use, so importing this module (``DotDict`` alone, as
    ``chip_smoke.py`` does) needs no PyYAML."""
    import yaml

    class _YamlLoader(yaml.SafeLoader):
        pass

    _YamlLoader.add_implicit_resolver(
        "tag:yaml.org,2002:float",
        re.compile(r"""^[-+]?(?:
              [0-9][0-9_]*\.[0-9_]*(?:[eE][-+]?[0-9]+)?
            | \.[0-9][0-9_]*(?:[eE][-+]?[0-9]+)?
            | [0-9][0-9_]*[eE][-+]?[0-9]+
        )$""", re.X),
        list("-+0123456789."))
    return _YamlLoader


def _yaml_load(text: str) -> Any:
    import yaml

    return yaml.load(text, Loader=_yaml_loader())


def load_yaml(path: str) -> tuple[DotDict, Optional[str]]:
    """Load one YAML file; returns (config, package_directive)."""
    with open(path) as f:
        text = f.read()
    package = None
    for line in text.splitlines():
        stripped = line.strip()
        if stripped.startswith("# @package"):
            package = stripped.split("# @package", 1)[1].strip()
            break
        if stripped and not stripped.startswith("#"):
            break
    data = _yaml_load(text)
    return DotDict(data or {}), package


def _parse_value(raw: str) -> Any:
    import yaml

    try:
        return _yaml_load(raw)
    except yaml.YAMLError:
        return raw


def _compose_file(
    config_dir: str,
    rel_path: str,
    group_overrides: Mapping[str, Optional[str]],
    group_prefix: str = "",
) -> DotDict:
    """Compose one config file: process its defaults list, then merge self."""
    path = os.path.join(config_dir, rel_path)
    if not path.endswith(".yaml"):
        path += ".yaml"
    cfg_self, package = load_yaml(path)
    defaults = cfg_self.pop("defaults", None)

    result = DotDict()
    self_merged = False

    def merge_self() -> None:
        nonlocal self_merged
        if self_merged:
            return
        self_merged = True
        target = cfg_self
        if package and package != "_global_" and package != "_group_":
            wrapper = DotDict()
            wrapper.set_dotted(package, cfg_self)
            target = wrapper
        merge(result, target)

    for entry in defaults or []:
        if entry == "_self_":
            merge_self()
            continue
        if isinstance(entry, str):
            # sibling file include, e.g. "med-moe.yaml"
            sibling = os.path.join(os.path.dirname(rel_path), entry)
            sub = _compose_file(config_dir, sibling, group_overrides, group_prefix)
            merge(result, sub)
            continue
        # mapping entry: {group: option} possibly "optional group" / "override /g"
        (key, option), = entry.items()
        optional = False
        if key.startswith("override "):
            key = key[len("override "):]
        if key.startswith("optional "):
            optional = True
            key = key[len("optional "):]
        absolute = key.startswith("/")
        group = key.lstrip("/")
        # CLI group override wins over the YAML default
        lookup = group if absolute or not group_prefix else f"{group_prefix}/{group}"
        if lookup in group_overrides:
            option = group_overrides[lookup]
        elif group in group_overrides:
            option = group_overrides[group]
        if option in (None, "null", "none"):
            continue
        group_rel = group if (absolute or not group_prefix) else f"{group_prefix}/{group}"
        sub_path = os.path.join(group_rel, str(option))
        full = os.path.join(config_dir, sub_path + ".yaml")
        if optional and not os.path.exists(full):
            continue
        sub = _compose_file(config_dir, sub_path, group_overrides, group_rel)
        _, sub_package = load_yaml(full)
        if sub_package == "_global_":
            merge(result, sub)
        else:
            wrapper = DotDict()
            dotted = (sub_package or group.replace("/", ".")).replace("/", ".")
            wrapper.set_dotted(dotted, sub)
            merge(result, wrapper)

    merge_self()
    return result


def _run_stamp() -> "datetime.datetime":
    """The timestamp ``${now:...}`` resolves against. ``MEDMOE_RUN_STAMP``
    (unix seconds) pins it — required for multi-process SPMD runs where the
    collective orbax save needs every process to agree on output_dir."""
    import datetime

    pinned = os.environ.get("MEDMOE_RUN_STAMP")
    if pinned:
        # UTC, not local time: the pin exists so every process in a
        # multi-host run renders the SAME output_dir — hosts with
        # different TZ config would otherwise format the same epoch value
        # into different strings, recreating exactly the divergence the
        # pin prevents
        return datetime.datetime.fromtimestamp(
            float(pinned), tz=datetime.timezone.utc).replace(tzinfo=None)
    return datetime.datetime.now()


def resolve_interpolations(cfg: DotDict, root: Optional[DotDict] = None) -> DotDict:
    """Resolve ``${a.b}`` references against the root config, in place."""
    root = root if root is not None else cfg
    stamp = _run_stamp()     # once per resolve: all ${now:} in one config agree

    def resolve_str(s: str, depth: int = 0) -> Any:
        if depth > 10:
            return s
        full_match = _INTERP_RE.fullmatch(s.strip())
        if full_match:
            ref = full_match.group(1)
            if ref.startswith("env:"):
                parts = ref[4:].split(",", 1)
                return os.environ.get(parts[0], parts[1] if len(parts) > 1 else None)
            if ref.startswith("now:"):
                return stamp.strftime(ref[4:])
            val = root.select(ref, _MISSING)
            if val is _MISSING:
                raise KeyError(
                    f"interpolation ${{{ref}}} refers to a key that does "
                    f"not exist in the composed config")
            if isinstance(val, str):
                return resolve_str(val, depth + 1)
            return val

        def sub(m: re.Match) -> str:
            ref = m.group(1)
            if ref.startswith("env:"):
                parts = ref[4:].split(",", 1)
                return str(os.environ.get(parts[0], parts[1] if len(parts) > 1 else ""))
            if ref.startswith("now:"):
                return stamp.strftime(ref[4:])
            val = root.select(ref, _MISSING)
            if val is _MISSING:
                # silently embedding the literal text 'None' (e.g. a
                # checkpoint dir named "None/runs" from a typo'd ref) hides
                # the failure completely — error like hydra does
                raise KeyError(
                    f"interpolation ${{{ref}}} refers to a key that does "
                    f"not exist in the composed config")
            if isinstance(val, str) and _INTERP_RE.search(val):
                val = resolve_str(val, depth + 1)
            return str(val)

        return _INTERP_RE.sub(sub, s)

    def walk(node: Any) -> Any:
        if isinstance(node, Mapping):
            for k in list(node.keys()):
                node[k] = walk(node[k])
            return node
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, str) and "${" in node:
            return resolve_str(node)
        return node

    walk(cfg)
    return cfg


def compose(
    config_name: str = "train",
    overrides: Optional[Iterable[str]] = None,
    config_dir: str = DEFAULT_CONFIG_DIR,
) -> DotDict:
    """Compose a config exactly like ``python train.py experiment=...``."""
    overrides = list(overrides or [])
    group_overrides: dict[str, Optional[str]] = {}
    value_overrides: List[tuple[str, Any]] = []
    deletions: List[str] = []

    for ov in overrides:
        if ov.startswith("~"):
            deletions.append(ov[1:])
            continue
        additive = ov.startswith("+")
        if additive:
            ov = ov[1:]
        key, sep, raw = ov.partition("=")
        if not sep:
            # hydra errors on unparseable overrides too; silently accepting
            # a bare token (e.g. '--help', or a typo'd 'experiment foo')
            # used to start a full default training run
            raise ValueError(
                f"malformed override {ov!r}: expected key=value, "
                f"group=option, +new.key=value, or ~key.path")
        value = _parse_value(raw)
        # A bare top-level name that names a config-group directory is a group
        # selection; anything dotted (or not a directory) is a value override.
        if not additive and "." not in key and (
            os.path.isdir(os.path.join(config_dir, key.lstrip("/")))
        ):
            group_overrides[key.lstrip("/")] = None if raw in ("null", "None") else raw
        else:
            value_overrides.append((key, value))

    cfg = _compose_file(config_dir, config_name, group_overrides)
    for key, value in value_overrides:
        # NOTE: unlike hydra, a bare override may create a new key — the
        # tower configs deliberately leave most knobs to module-side
        # .get() defaults (they are overridable without appearing in any
        # YAML), so hydra's key-must-exist typo protection cannot apply
        # without a schema layer. '+key=value' works and is equivalent.
        cfg.set_dotted(key, value)
    for key in deletions:
        cfg.delete_dotted(key)
    resolve_interpolations(cfg)
    return cfg
