"""Run hygiene for the train CLI (counterpart of medmoe_tpu/utils/task.py;
reference src/utils/utils.py + rich_utils.py).

``task_wrapper`` — on an exception, append the traceback to
``${paths.output_dir}/exec_error.log`` and re-raise.
``extras`` — the warnings / tags / config-print toggles.
``get_metric_value`` — strict metric lookup for sweeps.
"""

from __future__ import annotations

import functools
import os
import traceback
import warnings
from typing import Any, Callable, Dict, Optional

from medmoe_torch.config import DotDict, to_dict
from medmoe_torch.utils.logging import _process_index, get_logger

log = get_logger(__name__)

_CONFIG_ORDER = ("data", "model", "callbacks", "logger", "trainer", "paths",
                 "extras")


def task_wrapper(task_func: Callable) -> Callable:
    """Log the traceback of a failed task to the run's output dir, then
    re-raise."""

    @functools.wraps(task_func)
    def wrap(cfg: DotDict, *args: Any, **kwargs: Any):
        output_dir = cfg.select("paths.output_dir", ".")
        try:
            return task_func(cfg, *args, **kwargs)
        except Exception:
            os.makedirs(output_dir, exist_ok=True)
            with open(os.path.join(output_dir, "exec_error.log"), "a") as f:
                f.write(traceback.format_exc())
            raise
        finally:
            log.info(f"Output dir: {output_dir}")

    return wrap


def extras(cfg: DotDict) -> None:
    """Apply the ``extras`` config toggles before the task starts."""
    ex = cfg.get("extras")
    if not ex:
        return
    if ex.get("ignore_warnings"):
        warnings.filterwarnings("ignore")
    if ex.get("enforce_tags"):
        enforce_tags(cfg)
    if ex.get("print_config") and _process_index() == 0:
        print_config_tree(cfg, save_dir=cfg.select("paths.output_dir"))


def _render(node: Any, indent: int = 0) -> str:
    pad = " " * indent
    lines = []
    if isinstance(node, dict):
        for k, v in node.items():
            if isinstance(v, dict):
                lines.append(f"{pad}{k}:")
                lines.append(_render(v, indent + 2))
            else:
                lines.append(f"{pad}{k}: {v}")
    else:
        lines.append(f"{pad}{node}")
    return "\n".join(lines)


def print_config_tree(cfg: DotDict, save_dir: Optional[str] = None) -> str:
    plain = to_dict(cfg)
    ordered = {k: plain.pop(k) for k in _CONFIG_ORDER if k in plain}
    ordered.update(plain)
    text = "CONFIG\n" + "\n".join(
        f"├── {k}\n{_render(v, 4) if isinstance(v, dict) else '    ' + str(v)}"
        for k, v in ordered.items())
    log.info("\n" + text)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, "config_tree.log"), "w") as f:
            f.write(text)
    return text


def enforce_tags(cfg: DotDict) -> None:
    if not cfg.get("tags"):
        raise ValueError(
            "Specify tags before launching (e.g. tags=[dev]) — untagged "
            "runs are refused (extras.enforce_tags=true)")


def get_metric_value(metric_dict: Dict[str, Any],
                     metric_name: Optional[str]) -> Optional[float]:
    """Strict metric retrieval for sweeps (reference utils.py:180-201)."""
    if not metric_name:
        log.info("metric name is None — skipping metric retrieval")
        return None
    if metric_name not in metric_dict:
        raise KeyError(
            f"metric {metric_name!r} not found in {sorted(metric_dict)}; "
            "check the `optimized_metric` name")
    value = float(metric_dict[metric_name])
    log.info(f"retrieved metric {metric_name!r} = {value}")
    return value
