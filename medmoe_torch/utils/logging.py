"""Process-aware logging (reference src/utils/pylogger.py analogue).

The rank is ``torch.distributed``'s when a process group is up, else 0.
"""

from __future__ import annotations

import logging
import sys
from typing import Optional

_FORMAT = "[%(asctime)s][%(name)s][%(levelname)s] - %(message)s"


def _process_index() -> int:
    """This process's ``torch.distributed`` rank, or 0 outside a process
    group (importing torch.distributed initializes no device)."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
    except Exception:
        pass
    return 0


class RankedLogger(logging.LoggerAdapter):
    """Prefixes messages with the process index; can restrict to process 0."""

    def __init__(self, name: str = __name__, rank_zero_only: bool = True):
        logger = logging.getLogger(name)
        super().__init__(logger, {})
        self.rank_zero_only = rank_zero_only

    def log(self, level: int, msg: str, *args, rank: Optional[int] = None, **kwargs):
        if not self.isEnabledFor(level):
            return
        current = _process_index()
        msg = f"[rank: {current}] {msg}"
        if self.rank_zero_only and current != 0:
            return
        if rank is not None and current != rank:
            return
        self.logger.log(level, msg, *args, **kwargs)


def get_logger(name: str = "medmoe_torch", rank_zero_only: bool = True) -> RankedLogger:
    root = logging.getLogger()
    if not root.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(handler)
        root.setLevel(logging.INFO)
    return RankedLogger(name, rank_zero_only=rank_zero_only)
