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
  timed at captions of 25 and 40 words, then K3, the prologue alone and
  K4a alone (both passes from one prologue's scratch) at 256² and at
  128 × 256 with captions of 25 and 40 words, where the checkout keeps
  K3's state also K3 keeping it and the prologue from it, the device time
  of each F pass of K3 + the prologue (both ways), with each K4a pass's
  device time and TFLOP/s on padded captions, and K4b alone there (the
  backward of both cotangents less that of the image's) with each K4b
  pass's device time,
  then, on fixed inputs (made with numpy), a digest of the bits of K3 and
  the prologue and ones of K4a's and K4b's bits ("ab K4a bits", "ab K4b
  bits"), with K4a held against its plain version there.
  ``phase_gloria`` holds each checkout's K3 and prologue
  (through K4a and K4b) against the plain versions, so the digests are a
  record, not the check of correctness: each checkout's runs must give the
  same digest (two runs of one tree, the same bits), and the script says
  whether the checkouts' digests agree, which they do when a change leaves
  K3 and the prologue alone (a change to K4a or to a core they do not use)
  and need not when it changes them;
- with ``--k1``, the expert-branch forward leg: ``chip_smoke.phase_k1``
  (K1 against its plain version at B=32 flagship and on odd shapes, its
  passes' device times at B=32 and B=256, each checkout's own passes by
  their names in its ``chip_smoke.K1_KERNELS``, and, where the checkout
  has it, the projection's cuBLAS yardstick), then K1 timed at B=32 and B=256
  flagship with the peak device memory of each call, then the bits of K1
  on the card tests' digest inputs ("ab K1 bits", where the checkout's
  tests define them);
- with ``--k2``, the expert-branch backward leg: ``chip_smoke.phase_k2``
  (K2 against its plain version at B=32 flagship and on odd shapes, the
  times of both, its passes' device times at B=32 and B=256), then K2
  timed at B=256 flagship (a gloria256 step's shape) with the peak device
  memory of that call, then the bits of K2 ("ab K2 bits", as for K1);
- with ``--step``, the end-to-end leg: ``chip_smoke.phase_gloria_train``,
  two gloria256 optimizer steps of 256 pairs at full width through the
  train CLI, then one warm step timed, with the peak device memory; then
  ``chip_smoke.phase_text_train``, the same with BERT training (the path
  that runs K4b), one step and one warm step timed; then the device time
  of each of K1's and K2's passes at the step's B=256 flagship shape (the
  checkout's own ``K1_KERNELS`` and ``K2_KERNELS``, one profiled call
  each);
- with ``--serve``, the small-batch leg, where the host's dispatch sets
  the rate: ``chip_smoke.phase_serve`` (8 full-width serving waves of 32,
  img/s) and ``chip_smoke.phase_train`` (two pretraining_medmoe_ddp
  steps of 4 micro-batches of 32 through the train CLI, then the warm
  trainer path, pairs/s).

Prints the card's name and power limit first; exits non-zero when a
checkout's run fails or two runs of one checkout give different digests.
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


K4A_PASSES = ("dctx_z_kernel", "dctx_gemm_kernel")
# K4b's passes: the prologue's f32 terms, the product, and (since K4b's
# product moved to the wgmma core) the slices' sum
K4B_PASSES = ("dwords_wei_kernel", "dwords_gemm_kernel", "dwords_sum_kernel")


def pass_ms(fn, kernels=K4A_PASSES):
    """Device ms of each of ``kernels`` over one call (torch.profiler);
    its own, since a parent's chip_smoke.profile_passes may return
    nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ms = dict.fromkeys(kernels, 0.0)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for k in ms:
                if e.key.startswith((f"void {k}", k)):
                    ms[k] += c.dev_us(e) / 1e3
    return ms


F_PASSES = ("sim_e_kernel", "sim_wei_kernel<false>", "sim_wei_kernel<true>",
            "sim_finish_kernel<false>", "sim_finish_kernel<true>")


def kept_ms(img, words, cap, cot, iters=3):
    """K3 keeping its state and the prologue from that state, in checkouts
    that keep it: each timed with CUDA events over ``iters`` pairs of calls
    after a warm one (the prologue frees its state, so each takes a K3 of
    its own)."""
    k3 = pro = 0.0
    for k in range(iters + 1):
        state = ga.KeptState()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        ga.gloria_similarity_forward(img, words, cap, *temps, kept=state)
        ev[1].record()
        ga.pair_cotangents(img, words, cap, cot, *temps, kept=state)
        ev[2].record()
        torch.cuda.synchronize()
        if k:
            k3 += ev[0].elapsed_time(ev[1])
            pro += ev[1].elapsed_time(ev[2])
    return k3 / iters, pro / iters


def k3_and_prologue(img, words, cap, cot, kept):
    state = {"kept": ga.KeptState()} if kept else {}
    ga.gloria_similarity_forward(img, words, cap, *temps, **state)
    ga.pair_cotangents(img, words, cap, cot, *temps, **state)


# K3, the prologue alone and K4a alone (both passes, from one prologue's
# scratch) at 256² and at a rank's 128 × 256, captions of 25 and 40 words;
# where the checkout keeps K3's state, K3 keeping it and the prologue from
# it, and the device time of each F pass of K3 + the prologue both ways;
# each K4a pass's TFLOP/s on padded captions (2·B_img·M·D·B_txt·2·TPAD
# operations a pass)
for b_img, t in ((256, 25), (256, 40), (128, 25), (128, 40)):
    img, words, cap, cot = c.gloria_inputs(torch, b_img, 256, 768, 56, 56, t,
                                           seed=25)
    k3 = c.cuda_ms(lambda: ga.gloria_similarity_forward(img, words, cap,
                                                        *temps),
                   iters=3, warmup=1)
    pro = c.cuda_ms(lambda: ga.pair_cotangents(img, words, cap, cot, *temps),
                    iters=3, warmup=1)
    print(f"ab {b_img}x256 T={t}: K3 {k3:.4f} ms, the backward's prologue "
          f"alone {pro:.4f} ms on {card}", flush=True)
    ways = (False, True) if hasattr(ga, "KeptState") else (False,)
    if len(ways) == 2:
        k3k, prok = kept_ms(img, words, cap, cot)
        nbytes = ga.kept_bytes(b_img, 256, 3136, 768, t)
        print(f"ab {b_img}x256 T={t}: K3 keeping its state {k3k:.4f} ms, "
              f"the prologue from it {prok:.4f} ms, state "
              f"{nbytes / 1e9:.3f} GB on {card}", flush=True)
    for kept in ways:
        passes = pass_ms(lambda: k3_and_prologue(img, words, cap, cot, kept),
                         F_PASSES)
        print(f"ab {b_img}x256 T={t}: K3 + prologue "
              + ("kept" if kept else "recomputed") + ": "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in passes.items())
              + f" on {card}", flush=True)
    pairs = ga.pair_cotangents(img, words, cap, cot, *temps)
    ms = c.cuda_ms(lambda: k4a(pairs), iters=3, warmup=1)
    padded = 2 * b_img * 3136 * 768 * 256 * 2 * (-(-t // 32) * 32)
    passes = pass_ms(lambda: k4a(pairs))
    print(f"ab {b_img}x256 T={t}: K4a alone {ms:.4f} ms; " + ", ".join(
        f"{k} {v:.3f} ms ({padded / max(v, 1e-9) / 1e9:.1f} TFLOP/s)"
        for k, v in passes.items()) + f" on {card}", flush=True)
    del pairs
    # K4b alone: the backward of both cotangents less that of the image's
    # (K4b sums into its prologue's accumulator, so each d_words needs a
    # prologue of its own); its passes over a backward of the words'
    # cotangent alone, the product's TFLOP/s on padded captions
    # (2·B_img·M·D·B_txt·TPAD)
    both = [c.cuda_ms(lambda: ga.gloria_similarity_backward(
                img, words, cap, cot, *temps, need_words=need_words),
                iters=2, warmup=1)
            for need_words in (False, True)]
    passes = pass_ms(lambda: ga.gloria_similarity_backward(
        img, words, cap, cot, *temps, need_img=False), K4B_PASSES)
    rate = padded / 2 / max(passes["dwords_gemm_kernel"], 1e-9) / 1e9
    print(f"ab {b_img}x256 T={t}: K4b alone {both[1] - both[0]:.4f} ms; "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in passes.items())
          + f" (dwords_gemm_kernel {rate:.1f} TFLOP/s) on {card}", flush=True)
    del img, words, cap, cot
    torch.cuda.empty_cache()
# the bits of K3 and the prologue on numpy inputs (must agree across the
# checkouts), and of K4a (printed: a change to K4a changes them on purpose),
# with K4a's d_img held against its plain version
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
    for out in (sim, pairs.dwei, pairs.vecs):
        digest.update(out.float().cpu().numpy().tobytes())
    print(f"ab digest K3 + prologue {shape}: {digest.hexdigest()}", flush=True)
    print(f"ab K4a bits {shape}: "
          f"{hashlib.sha256(dctx.float().cpu().numpy().tobytes()).hexdigest()}",
          flush=True)
    dwords = ga.cotangents_of(ga.pair_cotangents(img, words, cap, cot, *temps,
                                                 True), True, True)[1]
    print(f"ab K4b bits {shape}: "
          f"{hashlib.sha256(dwords.float().cpu().numpy().tobytes()).hexdigest()}",
          flush=True)
    d_img = ga.gloria_similarity_backward(img, words, cap, cot, *temps,
                                          need_words=False)[0]
    ref = ga.gloria_similarity_bwd_reference(img, words, cap, cot, *temps,
                                             need_words=False)[0]
    c.gloria_err(torch, d_img, ref, f"ab K4a {shape} d_img", "bwd")
'''

# the card tests' digest inputs, where this checkout's tests define them
EXPERT_BITS = r'''
sys.path.insert(0, "tests")
import hashlib
import test_torch_kernels_cuda as kt


def expert_bits(label, outputs):
    if not hasattr(kt, "DIGEST_SHAPES"):
        return
    for case in range(len(kt.DIGEST_SHAPES)):
        digest = hashlib.sha256()
        for t in outputs(case):
            digest.update(t.float().cpu().numpy().tobytes())
        print(f"ab {label} bits {case}: {digest.hexdigest()}", flush=True)
'''

K2 = PRELUDE + EXPERT_BITS + r'''
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
del args, xs, wp, bp, w1, b1, w2, b2, idx, d_out
torch.cuda.empty_cache()


def k2_outputs(case):
    xs, wp, bp, w1, b1, w2, _, idx = kt._digest_inputs("cuda", case)
    d_out = kt._digest_cotangent("cuda", case, xs, w1)
    return kt._bwd_outs(ef.expert_fusion_gather_bwd(xs, wp, bp, w1, b1, w2,
                                                    idx, d_out))


expert_bits("K2", k2_outputs)
'''


K1 = PRELUDE + EXPERT_BITS + r'''
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
expert_bits("K1", lambda case: [ef.expert_fusion_gather(
    *kt._digest_inputs("cuda", case))])
'''

STEP = PRELUDE + r'''
from medmoe_torch.ops import expert_fusion as ef

c.phase_gloria_train(torch, card)
c.phase_text_train(torch, card)
args = c.k1_inputs(torch, b=256, p_list=(3136, 784, 196, 49),
                   d_list=(96, 192, 384, 768), e=768, h=384, k=6, seed=17)
xs, wp, bp, w1, b1, w2, b2, idx = args
d_out = torch.randn((256, 3136, 768), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(16))
c.profile_passes(torch, lambda: ef.expert_fusion_gather(*args),
                 f"ab step shape K1 B=256 on {card}", c.K1_KERNELS)
# the parent's list leaves out its projection recompute, which ran K1's
# proj_kernel
k2 = tuple(c.K2_KERNELS) + (() if "bwd_proj_kernel" in c.K2_KERNELS
                            else ("proj_kernel",))
c.profile_passes(torch, lambda: ef.expert_fusion_gather_bwd(
    xs, wp, bp, w1, b1, w2, idx, d_out), f"ab step shape K2 B=256 on {card}",
    k2)
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
    digests = {}      # {tree: {digest line}}
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
            if line.startswith(("ab digest", "ab K4a bits", "ab K4b bits",
                                "ab K1 bits", "ab K2 bits")):
                digests.setdefault(tree, set()).add(line)
    kinds = sorted({line.split(":")[0] for v in digests.values() for line in v})
    for kind in kinds:
        seen = {line for v in digests.values() for line in v
                if line.split(":")[0] == kind}
        print(f"ab: {kind[3:]}: "
              + ("the same in every checkout" if len(seen) == 1
                 else "differs between checkouts"), flush=True)
    for tree, lines in digests.items():
        if len(lines) != len({line.split(":")[0] for line in lines}):
            print(f"ab: two runs of {tree} gave different bits", flush=True)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
