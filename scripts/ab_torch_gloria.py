"""A/B of the port's GLoRIA kernels between checkouts, on one CUDA card.

    python3 scripts/ab_torch_gloria.py DIR [DIR ...]

In each checkout, in the order given (parent, change, change, parent, to
cancel drift), and in a process of its own that builds that checkout's
kernels: ``chip_smoke.phase_gloria`` at B=256 flagship shapes with
captions of 25 words (every GLoRIA kernel against its plain version, and
the times of both), then K3 and the backward's prologue alone timed at
B=256 flagship with captions of 40 words. Prints the card's name and
power limit first; exits non-zero when a checkout's run fails.
"""

from __future__ import annotations

import subprocess
import sys

CHILD = r'''
import sys
sys.path.insert(0, ".")
import torch
import chip_smoke as c
from medmoe_torch.ops import _build, gloria_attention as ga

_build.build()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
card = torch.cuda.get_device_name(0)
c.phase_gloria(torch, ga, card)
temps = (4.0, 5.0, 10.0)
img, words, cap, cot = c.gloria_inputs(torch, 256, 256, 768, 56, 56, 40,
                                       seed=23)
k3 = c.cuda_ms(lambda: ga.gloria_similarity_forward(img, words, cap, *temps),
               iters=3, warmup=1)
pro = c.cuda_ms(lambda: ga.pair_cotangents(img, words, cap, cot, *temps),
                iters=2, warmup=1)
print(f"ab T=40: K3 {k3:.4f} ms, the backward's prologue alone {pro:.4f} ms "
      f"on {card}", flush=True)
'''


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    for tree in sys.argv[1:]:
        print(f"== {tree}", flush=True)
        rc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree).returncode
        if rc:
            print(f"ab: {tree} failed with exit code {rc}", flush=True)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
