"""``--help`` for the port's CLIs (counterpart of medmoe_tpu/cli/_help.py;
hydra's --help analogue): the config groups of the port's config tree and
the override grammar, so ``python -m medmoe_torch.cli.train --help``
informs instead of starting a full-size run."""

from __future__ import annotations

import os
from typing import Iterable, List

_GRAMMAR = """overrides (hydra-compatible):
  group=option          swap a config group (see groups below)
  key.path=value        set any config value (lists: key=[a,b], null clears)
  +new.key=value        add a key that is not in the config
  ~key.path             delete a key
"""


def render_help(entry: str, description: str, examples: List[str]) -> str:
    from medmoe_torch.config.loader import DEFAULT_CONFIG_DIR

    lines = [f"usage: {entry} [override ...]", "", description, "",
             _GRAMMAR, "config groups:"]
    try:
        for group in sorted(os.listdir(DEFAULT_CONFIG_DIR)):
            gdir = os.path.join(DEFAULT_CONFIG_DIR, group)
            if not os.path.isdir(gdir):
                continue
            options = sorted(os.path.splitext(f)[0]
                             for f in os.listdir(gdir) if f.endswith(".yaml"))
            lines.append(f"  {group}={', '.join(options)}")
    except OSError:
        lines.append("  (config tree not found)")
    lines += ["", "examples:"] + [f"  {e}" for e in examples]
    return "\n".join(lines)


def maybe_print_help(overrides: Iterable[str], entry: str, description: str,
                     examples: List[str]) -> bool:
    """True (after printing the usage) when -h/--help is among the args."""
    if not any(a in ("-h", "--help") for a in overrides):
        return False
    print(render_help(entry, description, examples))
    return True
