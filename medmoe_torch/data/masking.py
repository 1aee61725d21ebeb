"""BEiT-style block image masking (counterpart of
medmoe_tpu/data/masking.py, whose numpy sampler this copies so that the
port imports nothing of the JAX package; reference
src/data/components/unimed.py:22-99, itself vendored from BEiT). It feeds
MIM-style objectives such as ops/flava.py's MaskedPredictionLoss.

Rectangular blocks with log-uniform aspect ratio and uniform area are
proposed until the requested number of grid cells is masked, each block
committed as one numpy slice assignment. The draws come from
``np.random.default_rng(seed)`` in the JAX package's order, so one seed
gives the same masks bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class ImageMaskingGenerator:
    """Samples rectangular blocks on an ``input_size`` patch grid until
    ``num_masking_patches`` cells are masked.

    Protocol per block: draw target area ~ U[min_num_patches, budget] and
    aspect ~ exp(U[log min_aspect, log max_aspect]); round to an (h, w)
    rectangle; place it uniformly at random. A placement is committed iff it
    adds between 1 and ``budget`` newly-masked cells (10 proposals per
    block before giving up on the whole mask).
    """

    def __init__(self, input_size, num_masking_patches: int,
                 min_num_patches: int = 4,
                 max_num_patches: Optional[int] = None,
                 min_aspect: float = 0.3, max_aspect: Optional[float] = None,
                 seed: Optional[int] = None):
        if isinstance(input_size, tuple):
            self.height, self.width = input_size
        else:
            self.height = self.width = int(input_size)
        self.num_patches = self.height * self.width
        self.num_masking_patches = num_masking_patches
        self.min_num_patches = min_num_patches
        self.max_num_patches = (max_num_patches if max_num_patches is not None
                                else num_masking_patches)
        max_aspect = max_aspect or 1.0 / min_aspect
        self._log_aspect = (np.log(min_aspect), np.log(max_aspect))
        self._rng = np.random.default_rng(seed)

    def __repr__(self) -> str:
        return (f"MaskingGenerator({self.height}, {self.width} -> "
                f"[{self.min_num_patches} ~ {self.max_num_patches}], "
                f"max = {self.num_masking_patches})")

    def get_shape(self) -> Tuple[int, int]:
        return self.height, self.width

    def _propose(self, budget: int) -> Optional[Tuple[slice, slice]]:
        """One block proposal: (row_slice, col_slice) or None if the sampled
        rectangle doesn't fit strictly inside the grid."""
        lo = min(self.min_num_patches, budget)   # budget can dip below min
        area = self._rng.uniform(lo, budget)
        aspect = np.exp(self._rng.uniform(*self._log_aspect))
        h = int(round(np.sqrt(area * aspect)))
        w = int(round(np.sqrt(area / aspect)))
        if h >= self.height or w >= self.width:
            return None
        top = int(self._rng.integers(0, self.height - h, endpoint=True))
        left = int(self._rng.integers(0, self.width - w, endpoint=True))
        return slice(top, top + h), slice(left, left + w)

    def __call__(self) -> np.ndarray:
        mask = np.zeros((self.height, self.width), dtype=np.int64)
        masked = 0
        while masked < self.num_masking_patches:
            budget = min(self.num_masking_patches - masked,
                         self.max_num_patches)
            added = 0
            for _ in range(10):
                block = self._propose(budget)
                if block is None:
                    continue
                region = mask[block]
                fresh = region.size - int(region.sum())
                if 0 < fresh <= budget:
                    mask[block] = 1          # vectorized block commit
                    added = fresh
                    break
            if added == 0:
                break                        # grid saturated for this budget
            masked += added
        return mask
