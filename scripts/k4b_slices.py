"""K4b's product at several numbers of slices of a chunk's K, on one CUDA
card.

    python3 scripts/k4b_slices.py [SLICES ...]

For each shape (256 images and a rank's 128 against 256 captions of 25
words, flagship widths) and each slice count (default 1 2 3 4; the
wrapper's is ``gloria_attention.K4B_SLICES``): the device ms of
``dwords_gemm_kernel`` and ``dwords_sum_kernel`` over one backward of the
words' cotangent (torch.profiler), the product's TFLOP/s on padded
captions (2·B_img·M·D·B_txt·TPAD), and d_words held against the first
slice count's within the backward's tolerance (every element within
1e-2·max|ref|, at most 1% beyond 2e-3·max|ref|). Prints the card's name and
power limit first; exits non-zero when a count disagrees.
"""

from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    import chip_smoke as c
    from medmoe_torch.ops import _build
    from medmoe_torch.ops import gloria_attention as ga

    if not torch.cuda.is_available():
        c.fail("torch.cuda.is_available() is false: this script needs a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip()
    print(card, flush=True)
    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    counts = [int(a) for a in sys.argv[1:]] or [1, 2, 3, 4]
    temps = (4.0, 5.0, 10.0)
    for b_img in (256, 128):
        img, words, cap, cot = c.gloria_inputs(torch, b_img, 256, 768, 56, 56,
                                               25, seed=26)
        padded = 2 * b_img * 3136 * 768 * 256 * ga._tpad(25)
        first = None
        for slices in counts:
            ga.K4B_SLICES = slices

            def bwd():
                pairs = ga.pair_cotangents(img, words, cap, cot, *temps, True)
                return ga.cotangents_of(pairs, False, True)[1]

            got = bwd()
            torch.cuda.synchronize()
            if first is None:
                first = got
            else:
                c.gloria_err(torch, got, first,
                             f"K4b {b_img}x256 slices={slices} against "
                             f"slices={counts[0]}", "bwd")
            ms = c.profile_passes(torch, bwd, f"K4b {b_img}x256 slices={slices}",
                                  ("dwords_gemm_kernel", "dwords_sum_kernel"))
            rate = padded / max(ms["dwords_gemm_kernel"], 1e-9) / 1e9
            print(f"slices {b_img}x256 {slices}: dwords_gemm_kernel "
                  f"{ms['dwords_gemm_kernel']:.3f} ms ({rate:.1f} TFLOP/s), "
                  f"dwords_sum_kernel {ms['dwords_sum_kernel']:.3f} ms on "
                  f"{card}", flush=True)
        del img, words, cap, cot, first
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
