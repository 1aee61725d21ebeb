"""A/B of the port's kernels between checkouts, on one CUDA card.

    python3 scripts/ab_torch_gloria.py [--k1 | --k2 | --step | --serve] \
        DIR [DIR ...]

In each checkout, in the order given (parent, change, change, parent, to
cancel drift), and in a process of its own that builds that checkout's
kernels:

- by default, the GLoRIA leg: ``chip_smoke.phase_gloria`` at B=256
  flagship shapes with captions of 25 words (every GLoRIA kernel against
  its plain version, and the times of both), then K3 and the backward's
  prologue alone timed at B=256 flagship with captions of 40 words, then
  the backward of the image's cotangent alone (the prologue + K4a) and of
  both cotangents (the prologue + K4a + K4b; the difference is K4b alone)
  timed at captions of 25 and 40 words, then a digest of the bits of K3,
  the prologue and K4a on fixed inputs (made with numpy), which must be
  the same in every checkout: the check that a change to the shared GEMM
  core left those kernels' results alone;
- with ``--k1``, the expert-branch forward leg: ``chip_smoke.phase_k1``
  (K1 against its plain version at B=32 flagship and on odd shapes), then
  K1 timed at B=32 and B=256 flagship with the peak device memory of each
  call;
- with ``--k2``, the expert-branch backward leg: ``chip_smoke.phase_k2``
  (K2 against its plain version at B=32 flagship and on odd shapes, and
  the times of both), then K2 timed at B=256 flagship (a gloria256 step's
  shape) with the peak device memory of that call;
- with ``--step``, the end-to-end leg: ``chip_smoke.phase_gloria_train``,
  two gloria256 optimizer steps of 256 pairs at full width through the
  train CLI, then one warm step timed, with the peak device memory; then
  ``chip_smoke.phase_text_train``, the same with BERT training (the path
  that runs K4b), one step and one warm step timed;
- with ``--serve``, the small-batch leg, where the host's dispatch sets
  the rate: ``chip_smoke.phase_serve`` (8 full-width serving waves of 32,
  img/s) and ``chip_smoke.phase_train`` (two pretraining_medmoe_ddp
  steps of 4 micro-batches of 32 through the train CLI, then the warm
  trainer path, pairs/s).

Prints the card's name and power limit first; exits non-zero when a
checkout's run fails or the GLoRIA digests differ.
"""

from __future__ import annotations

import subprocess
import sys

PRELUDE = r'''
import sys
sys.path.insert(0, ".")
import torch
import chip_smoke as c
from medmoe_torch.ops import _build

_build.build()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
card = torch.cuda.get_device_name(0)
'''

GLORIA = PRELUDE + r'''
import hashlib
import numpy as np
from medmoe_torch.ops import gloria_attention as ga

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
del img, words, cap, cot
for t in (25, 40):
    img, words, cap, cot = c.gloria_inputs(torch, 256, 256, 768, 56, 56, t,
                                           seed=24)
    ms = [c.cuda_ms(lambda: ga.gloria_similarity_backward(
              img, words, cap, cot, *temps, need_words=need_words),
              iters=2, warmup=1)
          for need_words in (False, True)]
    print(f"ab T={t}: prologue + K4a {ms[0]:.4f} ms, prologue + K4a + K4b "
          f"{ms[1]:.4f} ms, K4b alone {ms[1] - ms[0]:.4f} ms on {card}",
          flush=True)
    del img, words, cap, cot
    torch.cuda.empty_cache()
# K4a alone: cotangents_of, or dctx_of in checkouts that predate it
k4a = getattr(ga, "cotangents_of", None) or (lambda p: (ga.dctx_of(p),))
for shape in ((3, 5, 48, 12, 11, 40), (2, 3, 768, 56, 56, 25)):
    b_img, b_txt, d, h, w, t = shape
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.randn(b_img, d, h, w).astype(np.float32))
    words = torch.from_numpy(rng.randn(b_txt, d, t).astype(np.float32))
    cap = torch.from_numpy(rng.randint(3, t + 1, b_txt).astype(np.int32))
    cot = torch.from_numpy(rng.randn(b_img, b_txt).astype(np.float32))
    img, words = (x.to(torch.bfloat16).cuda() for x in (img, words))
    cap, cot = cap.cuda(), cot.cuda()
    sim = ga.gloria_similarity_forward(img, words, cap, *temps)
    pairs = ga.pair_cotangents(img, words, cap, cot, *temps)
    dctx = k4a(pairs)[0]
    digest = hashlib.sha256()
    for out in (sim, pairs.dwei, pairs.vecs, dctx):
        digest.update(out.float().cpu().numpy().tobytes())
    print(f"ab digest {shape}: {digest.hexdigest()}", flush=True)
'''

K2 = PRELUDE + r'''
from medmoe_torch.ops import expert_fusion as ef

c.phase_k2(torch, ef)
args = c.k1_inputs(torch, b=256, p_list=(3136, 784, 196, 49),
                   d_list=(96, 192, 384, 768), e=768, h=384, k=6, seed=15)
xs, wp, bp, w1, b1, w2, b2, idx = args
d_out = torch.randn((256, 3136, 768), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(16))
torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats()
ms = c.cuda_ms(lambda: ef.expert_fusion_gather_bwd(xs, wp, bp, w1, b1, w2,
                                                   idx, d_out),
               iters=3, warmup=1)
peak = torch.cuda.max_memory_allocated() / 1e9
flops, nbytes = c.k2_work(args, d_out)
bound = max(flops / c.PEAK_BF16_FLOPS, nbytes / c.PEAK_BYTES) * 1e3
print(f"ab B=256: K2 {ms:.4f} ms (bound {bound:.4f} ms), peak memory of "
      f"the call {peak:.2f} GB on {card}", flush=True)
'''


K1 = PRELUDE + r'''
from medmoe_torch.ops import expert_fusion as ef

c.phase_k1(torch, ef)
for b in (32, 256):
    args = c.k1_inputs(torch, b=b, p_list=(3136, 784, 196, 49),
                       d_list=(96, 192, 384, 768), e=768, h=384, k=6,
                       seed=17)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = c.cuda_ms(lambda: ef.expert_fusion_gather(*args),
                   iters=20 if b == 32 else 5, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    flops, nbytes = c.k1_work(args)
    bound = max(flops / c.PEAK_BF16_FLOPS, nbytes / c.PEAK_BYTES) * 1e3
    print(f"ab B={b}: K1 {ms:.4f} ms (bound {bound:.4f} ms), peak memory of "
          f"the call {peak:.2f} GB on {card}", flush=True)
    del args
    torch.cuda.empty_cache()
'''

STEP = PRELUDE + r'''
c.phase_gloria_train(torch, card)
c.phase_text_train(torch, card)
'''

SERVE = PRELUDE + r'''
from medmoe_torch.ops import expert_fusion as ef

c.phase_serve(torch, ef, card, *c.full_width_config())
c.phase_train(torch, ef, card)
'''

LEGS = {"--k1": K1, "--k2": K2, "--step": STEP, "--serve": SERVE}


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    trees = sys.argv[1:]
    child = GLORIA
    if trees[:1] and trees[0] in LEGS:
        trees, child = trees[1:], LEGS[trees[0]]
    digests = {}
    for tree in trees:
        print(f"== {tree}", flush=True)
        proc = subprocess.run([sys.executable, "-c", child], cwd=tree,
                              stdout=subprocess.PIPE, text=True)
        print(proc.stdout, end="", flush=True)
        if proc.returncode:
            print(f"ab: {tree} failed with exit code {proc.returncode}",
                  flush=True)
            return proc.returncode
        for line in proc.stdout.splitlines():
            if line.startswith("ab digest"):
                digests.setdefault(line.split(":")[0], set()).add(line)
    if any(len(v) > 1 for v in digests.values()):
        print("ab: the GLoRIA kernels' bits differ between checkouts",
              flush=True)
        return 1
    if digests:
        print("ab: the GLoRIA kernels' bits are the same in every checkout",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
