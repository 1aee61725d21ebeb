#!/usr/bin/env python3
"""Drive the PyTorch port (medmoe_torch) on one NVIDIA card, end to end.

    python3 chip_smoke.py            # from the root of a checkout

  1. prints the card's name and power limit (nvidia-smi) and whether
     PyYAML and PIL are installed (this script needs neither);
  2. builds every CUDA kernel from medmoe_torch/csrc, one nvcc each, all
     started together, and prints the build time and ptxas resources;
  3. K1, the fused expert branch: holds the kernel against its plain
     PyTorch version on the card at B=32 flagship shapes (bf16, every
     expert used) and on small odd shapes, times both with CUDA events,
     prints each of its passes' device time at B=32 from one
     torch.profiler call, and times it at B=256 flagship (the gloria256
     step's shape), held against its plain version on two slices of 32
     samples, one across a chunk boundary;
  4. serving: the full-width MedMoE (Swin-T + 6-expert gather MoE +
     BERT-base, bf16, seeded random weights) encodes the CheXpert class
     prompts and serves waves of 32 synthetic uint8 images through the
     serve CLI's wave loop; checks the records, that the kernel ran once
     per wave, and that the embeddings match the plain expert path;
  5. K2, the fused expert branch's backward: holds the kernel against its
     plain version at B=32 flagship shapes and on small odd shapes, times
     both, prints each of its passes' device time at B=32 from one
     torch.profiler call, times it at B=256 flagship (the gloria256 step's
     shape), and holds FusedExpertGather's gradients against autograd
     through the plain forward;
  6. training: the train CLI's ``train`` on experiment=pretraining_medmoe_ddp
     with synthetic data at full width, 8 micro-batches of 32 in 2
     optimizer steps (accumulation cut from 80 to 4 to fit the run's time);
     checks the loss and grad norm, that K2 ran once per micro-batch and K1
     at least once per micro-batch, that the routed experts' rows and the
     Swin tower moved, and that the frozen BERT did not, and that the B=32
     losses took the einsum path (no GLoRIA kernel);
  7. K3, K4a and K4b, the GLoRIA similarity and its backward: hold the
     kernels against their plain versions at B=256 flagship shapes (bf16
     ctx in the local map's own layout, caption lengths from a seed in
     [3, 25], a seeded cotangent; both cotangents from one call, the text
     training's path) and on small odd shapes (captions of 40 words; M =
     132 with 5 captions of 9 words, ragged tiles), time both (the
     backward's prologue alone, K4a alone, the prologue + K4a, and the
     prologue + K4a + K4b, whose difference from the prologue + K4a is K4b
     alone), print the bounds, the backward's scratch and the image chunk,
     and time the fused local loss against the einsum path at B=32; then
     hold K3 against its plain version at B=256 flagship with captions of
     40 words and time K3, its plain version, the prologue and the
     backward of both cotangents there;
  8. training at one batch of 256 a step: experiment=gloria256 with
     synthetic data at full width, 2 optimizer steps and one validation
     batch; checks the loss and grad norm, that K3 ran once per forward,
     K4a once per backward and K4b never (BERT frozen), K1/K2 as in 6,
     and what moved; then one warm step, timed;
  9. text training: one step of the same run with
     model.model.text.freeze_bert=false, where K4b runs once and BERT moves;
 10. training from disk: writes 6 train shards and 1 val shard of 64
     JPEG pairs (256 x 320, so resize and pad run) with the port's
     ShardWriter, then trains experiment=pretraining_medmoe_ddp
     data=unimed callbacks=default from them at full width (accumulation
     cut from 80 to 2, 4 micro-batches an epoch, 1 val batch): 1 epoch
     (epoch_000 and last written), a resume for 3 epochs that sends itself
     SIGTERM after the first step of epoch 1 (a preemption checkpoint
     whose sidecar names epoch 0), a second resume that finishes epochs
     1-2 with uint8 images; checks the step count across each resume, the
     restored parameters and Adam state against the file bit for bit,
     save_top_k files plus last; serves the best checkpoint through the
     serve CLI (embed mode, the val shard's 64 images as files) and holds
     the embeddings against the trained module's own (cosine > 0.999);
     prints the trainer's pairs/s and loader wait share, the checkpoint's
     size, the save and resume times, the served img/s and the warm
     disk-backed path with f32 and uint8 images;
 11. eval and deployment on that best checkpoint and those shards:
     python -m medmoe_torch.cli.eval_zs zero-shot over a CheXpert tree it
     writes (256 frontal JPEGs of 320 x 390, 5 tasks with both classes;
     per-task AUROC in [0, 1], their macro mean, accuracy; K1 once per
     batch of 64; the embeddings against the plain expert path, cosine >
     0.999; the warm encode img/s), retrieval over the val shard (R@1/5/10
     and median rank in range) and the linear probe over the 6 train
     shards (three accuracies in [0, 1]; a head step's time), cli.eval
     (the trainer's test loop, finite metrics), two steps of
     model=classification model.freeze_encoder=false (a finite loss, K1
     and K2 once per micro-batch, the routed experts' rows and Swin
     moved; a warm step's time) and cli.export for cuda with a symbolic
     batch (its round trip; the image program at b = 1 and 32 launches K1
     once each, unit norm, cosine > 0.999 against the live embedder; the
     export's seconds and the programs' sizes);
 12. prints {"kernels": [...]}, with each kernel's launches counted over
     every phase that drives the model (serving, both trainings, text
     training, training from disk and its serving, eval and export),
     and, last, the device line.

Any failed check exits non-zero. Needs one CUDA card; fails without one.
``--profile`` adds torch.profiler breakdowns of one serving wave, one
B=32 training step and one gloria256 step.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 bandwidth
N_WAVES = 8
WAVE = 32


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k1_inputs(torch, b, p_list, d_list, e, h, k, seed, idx=None,
              dev="cuda"):
    """Pyramid ~N(0,1) in bf16; expert parameters at the model's lecun
    scale, with nonzero biases so every bias path is exercised."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std

    xs = tuple(randn(b, p, d).to(torch.bfloat16)
               for p, d in zip(p_list, d_list))
    wp = tuple(randn(k, d, e, std=1 / math.sqrt(d)) for d in d_list)
    bp = tuple(randn(k, e, std=0.1) for _ in d_list)
    w1 = randn(k, e, h, std=1 / math.sqrt(e))
    b1 = randn(k, h, std=0.1)
    w2 = randn(k, h, 1, std=1 / math.sqrt(h))
    b2 = randn(k, 1, std=0.1)
    if idx is None:
        # every expert at least once, in a seeded order
        perm = torch.randperm(b, generator=g, device=dev)
        idx = (perm % k).to(torch.int32)
    else:
        idx = torch.tensor(idx, dtype=torch.int32, device=dev)
    return xs, wp, bp, w1, b1, w2, b2, idx


def k1_work(args):
    """(matmul operations, bytes) the function needs for these inputs:
    projections + attention MLP + logit dot products; each input read
    once, the f32 output written once."""
    xs, wp, bp, w1, b1, w2, b2, idx = args
    b = idx.shape[0]
    k, e, h = w1.shape
    p = max(x.shape[1] for x in xs)
    flops = sum(2 * b * x.shape[1] * x.shape[2] * e for x in xs)
    flops += len(xs) * (2 * b * p * e * h + 2 * b * p * h)
    tensors = list(xs) + list(wp) + list(bp) + [w1, b1, w2, b2, idx]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    nbytes += b * p * e * 4
    return flops, nbytes


# rtol/atol of K1 against its plain version: the JAX package's own
# fused-vs-XLA test's (tests/test_pallas_expert.py): both sides round at
# the same bf16 points, and a different f32 summation order can flip one
# bf16 ulp (2^-8 relative) in h, u or a
K1_RTOL, K1_ATOL = 2e-2, 2e-3


def hold_k1(torch, name, out, ref) -> float:
    """Hold K1's output against its plain version's (K1_RTOL, K1_ATOL);
    fails the run on a mismatch; returns the largest absolute error."""
    check(out.shape == ref.shape, f"K1 {name}: shape {tuple(out.shape)} "
          f"vs {tuple(ref.shape)}")
    check(bool(torch.isfinite(out).all()), f"K1 {name}: non-finite output")
    err = (out - ref).abs().max().item()
    ok = torch.allclose(out, ref, rtol=K1_RTOL, atol=K1_ATOL)
    print(f"K1 {name}: max_abs_err {err:.3e} (rtol {K1_RTOL}, atol "
          f"{K1_ATOL}) {'ok' if ok else 'MISMATCH'}", flush=True)
    check(ok, f"K1 {name}: kernel disagrees with its plain version")
    return err


def phase_k1(torch, ef):
    cases = [
        ("flagship B=32", dict(b=32, p_list=(3136, 784, 196, 49),
                               d_list=(96, 192, 384, 768), e=768, h=384,
                               k=6, seed=1)),
        ("flagship B=3", dict(b=3, p_list=(3136, 784, 196, 49),
                              d_list=(96, 192, 384, 768), e=768, h=384,
                              k=6, seed=2, idx=[5, 0, 3])),
        ("odd P=100 E=64 H=32", dict(b=2, p_list=(100, 25),
                                     d_list=(32, 24), e=64, h=32, k=2,
                                     seed=3, idx=[1, 0])),
    ]
    result = None
    for name, kw in cases:
        args = k1_inputs(torch, **kw)
        out = ef.expert_fusion_gather(*args)
        torch.cuda.synchronize()
        ref = ef.expert_fusion_gather_reference(*args)
        torch.cuda.synchronize()
        err = hold_k1(torch, name, out, ref)
        if result is None:
            ms = cuda_ms(lambda: ef.expert_fusion_gather(*args), iters=20)
            plain_ms = cuda_ms(
                lambda: ef.expert_fusion_gather_reference(*args), iters=3,
                warmup=1)
            flops, nbytes = k1_work(args)
            t_ops = flops / PEAK_BF16_FLOPS * 1e3
            t_bytes = nbytes / PEAK_BYTES * 1e3
            result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=max(t_ops, t_bytes),
                          bound_by="operations" if t_ops >= t_bytes
                          else "bytes")
            print(f"K1 {name}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
                  f"bound_ms {result['bound_ms']:.4f} ({result['bound_by']}: "
                  f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)",
                  flush=True)
            profile_passes(torch, lambda: ef.expert_fusion_gather(*args),
                           f"K1 {name}", K1_KERNELS)
        del args, out, ref
        torch.cuda.empty_cache()
    result.update(time_k1(torch, ef, GLORIA_BATCH))
    return result


def time_k1(torch, ef, b: int):
    """K1 at flagship shapes and batch ``b``, timed with CUDA events beside
    its bound (the shape of a gloria256 step's expert branch), and held
    against its plain version on two slices of 32 samples: one across the
    first chunk boundary and the last 32 (each sample's output depends on
    that sample alone)."""
    args = k1_inputs(torch, b=b, p_list=(3136, 784, 196, 49),
                     d_list=(96, 192, 384, 768), e=768, h=384, k=6, seed=17)
    ms = cuda_ms(lambda: ef.expert_fusion_gather(*args), iters=5, warmup=1)
    flops, nbytes = k1_work(args)
    bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
    nc = ef.fwd_image_chunk(b, (3136, 784, 196, 49), 768, 384)[0]
    print(f"K1 flagship B={b}: kernel_ms {ms:.4f} bound_ms {bound:.4f} "
          f"({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB); image chunk "
          f"{nc}", flush=True)
    out = ef.expert_fusion_gather(*args)
    xs, wp, bp, w1, b1, w2, b2, idx = args
    for i in sorted({max(0, min(nc, b) - 6), max(0, b - 32)}):
        j = min(b, i + 32)
        ref = ef.expert_fusion_gather_reference(
            tuple(x[i:j] for x in xs), wp, bp, w1, b1, w2, b2, idx[i:j])
        hold_k1(torch, f"flagship B={b} samples {i}-{j - 1} (chunks of {nc})",
                out[i:j], ref)
        del ref
    del args, out
    torch.cuda.empty_cache()
    return {f"ms_b{b}": ms, f"bound_ms_b{b}": bound}


@contextlib.contextmanager
def plain_expert_path(ef):
    """Route the model's expert branch through the plain version, for the
    comparison run only."""
    kernel = ef.expert_fusion_gather
    ef.expert_fusion_gather = ef.expert_fusion_gather_reference
    try:
        yield
    finally:
        ef.expert_fusion_gather = kernel


def full_width_config():
    """configs/model/med-moe.yaml at full width, written out here so that
    the script needs no PyYAML."""
    from medmoe_torch.config import DotDict

    vision = DotDict(model_name="swin", embed_dim=768, use_moe=True,
                     image_size=224, num_experts=6, moe_mode="gather",
                     router_top_k=1, dtype="bfloat16", swin_embed_dim=96,
                     swin_depths=[2, 2, 6, 2], swin_num_heads=[3, 6, 12, 24],
                     swin_window_size=7, drop_path_rate=0.1)
    text = DotDict(last_n_layers=4, aggregate_method="sum", norm=False,
                   agg_tokens=True, max_length=25, embed_dim=768,
                   projection=False, dtype="bfloat16", vocab_size=28996,
                   hidden_size=768, num_layers=12, num_heads=12,
                   intermediate_size=3072, max_position_embeddings=512)
    return vision, text


def phase_serve(torch, ef, card: str, vision, text, dev="cuda"):
    import numpy as np

    from medmoe_torch.cli.serve import serve_waves
    from medmoe_torch.data.datamodules import CheXpertDataModule
    from medmoe_torch.data.tokenizer import load_or_build_tokenizer
    from medmoe_torch.eval.zero_shot import (encode_class_prompts,
                                             make_image_embedder)
    from medmoe_torch.models.medmoe import MedMoE, init_weights

    tok = load_or_build_tokenizer("fixture:bio_clinical_bert")
    check(tok.vocab_size == 28996, f"vocab fixture has {tok.vocab_size} rows")
    t0 = time.perf_counter()
    model = init_weights(MedMoE(vision, text), seed=12345).to(dev).eval()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"serve: MedMoE {n_params / 1e6:.1f} M params, init + upload "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    names = CheXpertDataModule.COMPETITION_TASKS
    class_emb = encode_class_prompts(model, tok, names,
                                     "this is a photo of {}", 25)
    check(class_emb.shape == (5, int(vision.embed_dim)),
          f"class_emb {tuple(class_emb.shape)}")
    check(bool(torch.isfinite(class_emb).all()), "class_emb not finite")
    class_emb = class_emb.cpu().numpy()

    rng = np.random.RandomState(0)
    size = int(vision.image_size)
    images = rng.randint(0, 256, (N_WAVES * WAVE, size, size, 3), np.uint8)
    waves = [([f"synthetic/{i * WAVE + j}.png" for j in range(WAVE)],
              images[i * WAVE:(i + 1) * WAVE], []) for i in range(N_WAVES)]
    embed = make_image_embedder(model)
    embed(images[:WAVE])                              # warm-up wave
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    buf = io.StringIO()
    ef.LAUNCHES = 0
    t0 = time.perf_counter()
    n_ok, n_err = serve_waves(embed, waves, "classify", names, class_emb,
                              10.0, buf)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ef.LAUNCHES
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    check(launches == N_WAVES, f"K1 launched {launches} times in "
          f"{N_WAVES} waves (expected one per wave)")
    check((n_ok, n_err) == (N_WAVES * WAVE, 0), f"served {n_ok}, {n_err} errors")
    recs = [json.loads(line) for line in buf.getvalue().splitlines()]
    check(len(recs) == N_WAVES * WAVE, f"{len(recs)} records")
    for r in recs:
        check(r["label"] in names, f"label {r['label']!r}")
        check(math.isfinite(r["score"]), "non-finite score")
        check(abs(sum(r["probs"].values()) - 1.0) < 1e-3,
              f"probs sum {sum(r['probs'].values())}")
    img_s = N_WAVES * WAVE / seconds
    print(f"serve: {N_WAVES} waves x {WAVE} images classify in "
          f"{seconds:.3f} s = {img_s:.1f} img/s on {card}; K1 launches "
          f"{launches}; peak memory {peak_gb:.2f} GB; labels "
          f"{sorted({r['label'] for r in recs})}", flush=True)

    emb = embed(images[:WAVE])
    with plain_expert_path(ef):
        emb_plain = embed(images[:WAVE])
    check(bool(torch.isfinite(emb).all()), "non-finite embeddings")
    norm_err = (emb.norm(dim=-1) - 1).abs().max().item()
    check(norm_err < 1e-3, f"embedding norms off by {norm_err}")
    cos = (emb * emb_plain).sum(-1).min().item()
    print(f"serve: embeddings kernel vs plain expert path: min cosine "
          f"{cos:.6f}, max |norm-1| {norm_err:.2e}", flush=True)
    check(cos > 0.999, f"kernel vs plain path cosine {cos}")

    # the same waves with the expert branch on its plain version: what the
    # kernel is worth end to end
    with plain_expert_path(ef):
        t0 = time.perf_counter()
        serve_waves(embed, waves, "classify", names, class_emb, 10.0,
                    io.StringIO())
        torch.cuda.synchronize()
        plain_img_s = N_WAVES * WAVE / (time.perf_counter() - t0)
    print(f"serve: plain expert path {plain_img_s:.1f} img/s on {card}",
          flush=True)
    if "--profile" in sys.argv:
        profile_wave(torch, embed, images[:WAVE], seconds / N_WAVES * 1e3)
    return launches, img_s


def profile_wave(torch, embed, images, wave_ms: float):
    """torch.profiler over one serving wave: device time by kernel, the
    expert-fusion kernels' share of it, and the device's idle share of an
    unprofiled wave's wall time (``wave_ms``)."""
    profile_device(torch, lambda: embed(images).cpu(), wave_ms, "one wave")


K1_KERNELS = ("proj_kernel", "fwd_u_kernel", "fwd_logit_kernel",
              "fwd_combine_kernel")
K2_KERNELS = ("bwd_u_kernel", "bwd_act_kernel", "bwd_row_kernel",
              "bwd_du_kernel", "bwd_tlerp_kernel", "bwd_dx_kernel",
              "bwd_wgrad_kernel", "bwd_reduce_kernel")
K3_KERNELS = ("void sim_e_kernel", "void sim_wei_kernel",
              "void sim_finish_kernel")
GLORIA_KERNELS = K3_KERNELS + ("void dctx_z_kernel", "dctx_gemm_kernel",
                               "dwords_gemm_kernel", "dwords_wei_kernel")


def dev_us(e) -> float:
    """A profiler event's own device time, in microseconds."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def profile_device(torch, fn, wall_ms: float, label: str):
    """torch.profiler over one call of ``fn``: device time by kernel, the
    expert-fusion kernels' share of it (K1: the forward's four passes; K2:
    the backward's eight, beside the projection recompute it runs through
    K1's proj_kernel), and the device's idle share of an unprofiled call's
    wall time (``wall_ms``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    # device-side events only (kernels, copies), so no time counts twice;
    # annotations such as "Optimizer.step#Adam.step" span kernels and are
    # left out
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0
                   and "#" not in e.key),
                  key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    k1_ms = sum(dev_us(e) for e in rows if e.key.startswith(K1_KERNELS)) / 1e3
    k2_ms = sum(dev_us(e) for e in rows if e.key.startswith(K2_KERNELS)) / 1e3
    gl_ms = sum(dev_us(e) for e in rows
                if e.key.startswith(GLORIA_KERNELS)) / 1e3
    print(f"profile: {label}: device busy {busy_ms:.3f} ms of a "
          f"{wall_ms:.3f} ms unprofiled call (idle "
          f"{max(0.0, 1 - busy_ms / wall_ms):.1%}); K1 kernels "
          f"{k1_ms:.3f} ms ({k1_ms / max(busy_ms, 1e-9):.1%} of device "
          f"time), K2 kernels {k2_ms:.3f} ms "
          f"({k2_ms / max(busy_ms, 1e-9):.1%}), GLoRIA kernels {gl_ms:.3f} "
          f"ms ({gl_ms / max(busy_ms, 1e-9):.1%})", flush=True)
    for e in rows[:25]:
        print(f"profile: {dev_us(e) / 1e3:9.3f} ms {e.count:5d}x "
              f"{e.key[:100]}", flush=True)


def k2_work(args, d_out):
    """(matmul operations, bytes) of the backward for these inputs: the
    attention-MLP recompute, d_u and dW1 per scale, and the projection
    recompute (h_s), d_x and dWp per scale; each input read once, each
    per-sample output written once."""
    xs, wp, bp, w1, b1, w2, b2, idx = args
    b = idx.shape[0]
    k, e, h = w1.shape
    p = max(x.shape[1] for x in xs)
    flops = len(xs) * 3 * 2 * b * p * e * h
    flops += sum(3 * 2 * b * x.shape[1] * x.shape[2] * e for x in xs)
    tensors = list(xs) + list(wp) + list(bp) + [w1, b1, w2, idx, d_out]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    nbytes += sum(x.numel() * x.element_size() for x in xs)       # d_x
    nbytes += 4 * b * (sum(x.shape[2] * e + e for x in xs) + e * h + 2 * h)
    return flops, nbytes


def bwd_outputs(outs):
    d_xs, d_wp, d_bp, d_w1, d_b1, d_w2 = outs
    names = ([f"d_x{s}" for s in range(len(d_xs))]
             + [f"d_wp{s}" for s in range(len(d_wp))]
             + [f"d_bp{s}" for s in range(len(d_bp))]
             + ["d_w1", "d_b1", "d_w2"])
    return list(zip(names, list(d_xs) + list(d_wp) + list(d_bp)
                    + [d_w1, d_b1, d_w2]))


def relu_ties(torch, args):
    """How many pre-activations of the ReLU masks (h_pre = x·Wp + bp and
    a_pre = u·W1 + b1) lie within the worst-case f32 summation error of
    zero, n·2^-24·Σ|terms| for a sum of n products: the elements whose mask
    two summation orders may set differently. Returns
    ((h ties, h elements), (a ties, a elements))."""
    from medmoe_torch.models.moe import interp_patches

    xs, wp, bp, w1, b1, w2, b2, idx = args
    bf, ix = torch.bfloat16, idx.long()
    p_max = max(x.shape[1] for x in xs)

    def sel(param):
        return param[ix].to(bf).float()

    def ties(lhs, rhs, bias):
        pre = torch.bmm(lhs, rhs) + bias
        mag = torch.bmm(lhs.abs(), rhs.abs()) + bias.abs()
        return pre, int((pre.abs() <= lhs.shape[-1] * 2.0 ** -24 * mag).sum())

    w1s, b1s = sel(w1), sel(b1)[:, None, :]
    n_h = n_a = tot_h = tot_a = 0
    for s, x in enumerate(xs):
        pre, n = ties(x.float(), sel(wp[s]), sel(bp[s])[:, None, :])
        n_h, tot_h = n_h + n, tot_h + pre.numel()
        u = interp_patches(torch.relu(pre).to(bf), p_max, dim=1).float()
        pre, n = ties(u, w1s, b1s)
        n_a, tot_a = n_a + n, tot_a + pre.numel()
        del pre, u
    return (n_h, tot_h), (n_a, tot_a)


K2_ATOL_REL, K2_FAR, K2_FAR_SHARE = 5e-2, 2e-3, 0.01


def hold_k2(torch, name, out, ref) -> float:
    """Hold K2's outputs against its plain version's with the tolerance of
    tests/test_torch_kernels_cuda.py, per output: every element within
    5e-2·max|ref| (the JAX package's own fused-vs-XLA gradient bound) and
    at most 1% of the elements beyond 2e-3·max|ref|. Fails the run on a
    mismatch; returns the largest absolute error."""
    worst = 0.0
    for (oname, o), (_, r) in zip(bwd_outputs(out), bwd_outputs(ref)):
        o, r = o.float(), r.float()
        check(o.shape == r.shape, f"K2 {name} {oname}: shape")
        check(bool(torch.isfinite(o).all()), f"K2 {name} {oname}: "
              f"non-finite output")
        scale = r.abs().max().item()
        diff = (o - r).abs()
        err = diff.max().item()
        beyond = (diff > K2_FAR * scale).float().mean().item()
        ok = torch.allclose(o, r, rtol=0.0, atol=K2_ATOL_REL * scale) \
            and beyond <= K2_FAR_SHARE
        print(f"K2 {name} {oname}: max_abs_err {err:.3e} max|ref| "
              f"{scale:.3e} (atol {K2_ATOL_REL}*max|ref|); share beyond "
              f"{K2_FAR}*max|ref| {beyond:.2e} (at most {K2_FAR_SHARE}) "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        check(ok, f"K2 {name} {oname}: kernel disagrees with its plain "
              f"version")
        worst = max(worst, err)
    return worst


def phase_k2(torch, ef):
    # tolerance: hold_k2's. The ReLU masks (a > 0, h > 0) of the few elements whose pre-activation
    # lies within f32 summation error of zero can differ between two
    # summation orders, and each such flip moves a whole gradient term; the
    # flagship case counts those elements, and holds a second plain version
    # (the same function on the CPU, whose products sum in another order)
    # against the first as the kernel is held, for two of its samples
    far = K2_FAR
    cases = [
        ("flagship B=32", dict(b=32, p_list=(3136, 784, 196, 49),
                               d_list=(96, 192, 384, 768), e=768, h=384,
                               k=6, seed=11)),
        ("odd P=100 E=64 H=32", dict(b=2, p_list=(100, 25), d_list=(32, 24),
                                     e=64, h=32, k=2, seed=12, idx=[1, 0])),
    ]
    result = None
    for name, kw in cases:
        args = k1_inputs(torch, **kw)
        xs, wp, bp, w1, b1, w2, b2, idx = args
        g = torch.Generator(device="cuda").manual_seed(kw["seed"] + 100)
        d_out = torch.randn((kw["b"], max(kw["p_list"]), kw["e"]),
                            generator=g, device="cuda")
        out = ef.expert_fusion_gather_bwd(xs, wp, bp, w1, b1, w2, idx, d_out)
        torch.cuda.synchronize()
        ref = ef.expert_fusion_gather_bwd_reference(xs, wp, bp, w1, b1, w2,
                                                    idx, d_out)
        torch.cuda.synchronize()
        worst = hold_k2(torch, name, out, ref)
        if result is None:
            (n_h, tot_h), (n_a, tot_a) = relu_ties(torch, args)
            print(f"K2 {name}: ReLU pre-activations within f32 summation "
                  f"error of zero: h {n_h} of {tot_h}, a {n_a} of {tot_a}",
                  flush=True)
            two = [t.cpu() for t in (*xs, *wp, *bp, w1, b1, w2)]
            n = len(xs)
            cpu = ef.expert_fusion_gather_bwd_reference(
                tuple(x[:2] for x in two[:n]), two[n:2 * n], two[2 * n:3 * n],
                *two[3 * n:], idx[:2].cpu(), d_out[:2].cpu())
            for (oname, c), (_, o), (_, r) in zip(
                    bwd_outputs(cpu), bwd_outputs(out), bwd_outputs(ref)):
                c, o, r = c.float(), o[:2].float().cpu(), r[:2].float().cpu()
                scale = r.abs().max().item()
                print(f"K2 {name} samples 0-1 {oname}: plain CPU vs plain "
                      f"card max_abs_err {(c - r).abs().max().item():.3e}, "
                      f"share beyond {far}*max|ref| "
                      f"{((c - r).abs() > far * scale).float().mean().item():.2e}"
                      f"; kernel vs plain card {(o - r).abs().max().item():.3e}"
                      f", {((o - r).abs() > far * scale).float().mean().item():.2e}"
                      f" (max|ref| {scale:.3e})", flush=True)
            del cpu, two
            ms = cuda_ms(lambda: ef.expert_fusion_gather_bwd(
                xs, wp, bp, w1, b1, w2, idx, d_out), iters=10)
            plain_ms = cuda_ms(lambda: ef.expert_fusion_gather_bwd_reference(
                xs, wp, bp, w1, b1, w2, idx, d_out), iters=2, warmup=1)
            flops, nbytes = k2_work(args, d_out)
            t_ops = flops / PEAK_BF16_FLOPS * 1e3
            t_bytes = nbytes / PEAK_BYTES * 1e3
            result = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                          bound_ms=max(t_ops, t_bytes),
                          bound_by="operations" if t_ops >= t_bytes
                          else "bytes")
            print(f"K2 {name}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
                  f"bound_ms {result['bound_ms']:.4f} ({result['bound_by']}: "
                  f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB; the kernel "
                  f"time includes K1's projection recompute)", flush=True)
            profile_passes(torch, lambda: ef.expert_fusion_gather_bwd(
                xs, wp, bp, w1, b1, w2, idx, d_out), f"K2 {name}",
                ("proj_kernel",) + K2_KERNELS)
        del args, out, ref
        torch.cuda.empty_cache()
    result.update(time_k2(torch, ef, GLORIA_BATCH))

    # the autograd Function: bank and pyramid gradients against autograd
    # through the plain forward, at the JAX package's fused-vs-XLA bound
    args = k1_inputs(torch, b=6, p_list=(3136, 784, 196, 49),
                     d_list=(96, 192, 384, 768), e=768, h=384, k=6, seed=13,
                     idx=[0, 1, 2, 3, 4, 5])
    xs, wp, bp, w1, b1, w2, b2, idx = args
    cot = torch.randn((6, 3136, 768), device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(14))

    def grads(fn):
        leaves = [t.detach().clone().requires_grad_()
                  for t in (w1, b1, w2, b2, *xs, *wp, *bp)]
        n = len(xs)
        out = fn(leaves[4:4 + n], leaves[4 + n:4 + 2 * n], leaves[4 + 2 * n:],
                 *leaves[:4])
        return torch.autograd.grad(out, leaves, cot)

    got = grads(lambda x, w, b, w1_, b1_, w2_, b2_: ef.FusedExpertGather.apply(
        idx, w1_, b1_, w2_, b2_, *x, *w, *b))
    want = grads(lambda x, w, b, w1_, b1_, w2_, b2_:
                 ef.expert_fusion_gather_reference(x, w, b, w1_, b1_, w2_,
                                                   b2_, idx))
    names = ["attn_w1", "attn_b1", "attn_w2", "attn_b2"] \
        + [f"pyramid{s}" for s in range(4)] + [f"proj_w{s}" for s in range(4)] \
        + [f"proj_b{s}" for s in range(4)]
    worst = 0.0
    for nm, a, w in zip(names, got, want):
        if nm == "attn_b2":
            check(torch.count_nonzero(a).item() == 0, "attn_b2 grad not zero")
            continue
        rel = ((a.float() - w.float()).abs().max()
               / w.float().abs().max().clamp(min=1e-12)).item()
        worst = max(worst, rel)
        check(rel < 5e-2, f"FusedExpertGather {nm}: rel err {rel:.3e}")
    print(f"K2 FusedExpertGather B=6 flagship: bank + pyramid gradients vs "
          f"autograd through the plain forward: max rel err {worst:.3e} "
          f"(bound 5e-2), attn_b2 grad exactly 0", flush=True)
    del got, want, args, cot
    torch.cuda.empty_cache()
    return result


def profile_passes(torch, fn, label: str, kernels) -> None:
    """Device time of each of ``kernels`` (name prefixes) over one call of
    ``fn`` (torch.profiler): K1's passes, or K2's and K1's projection pass
    that K2 reruns."""
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
                if e.key.startswith(k):
                    ms[k] += dev_us(e) / 1e3
    print(f"{label} passes (device ms of one call): "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + f"; total {sum(ms.values()):.3f}", flush=True)


def time_k2(torch, ef, b: int):
    """K2 (with K1's projection recompute) at flagship shapes and batch
    ``b``, timed with CUDA events, beside its bound; the shape of a
    gloria256 step's expert-branch backward."""
    args = k1_inputs(torch, b=b, p_list=(3136, 784, 196, 49),
                     d_list=(96, 192, 384, 768), e=768, h=384, k=6, seed=15)
    xs, wp, bp, w1, b1, w2, b2, idx = args
    d_out = torch.randn((b, 3136, 768), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(16))
    ms = cuda_ms(lambda: ef.expert_fusion_gather_bwd(
        xs, wp, bp, w1, b1, w2, idx, d_out), iters=3, warmup=1)
    flops, nbytes = k2_work(args, d_out)
    bound = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3
    nc = ef.bwd_image_chunk(b, (3136, 784, 196, 49), 768, 384)[0]
    print(f"K2 flagship B={b}: kernel_ms {ms:.4f} bound_ms {bound:.4f} "
          f"({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB); image chunk "
          f"{nc}", flush=True)
    # the run over chunks of images against the plain version: each
    # sample's outputs depend on that sample alone, so the plain version
    # on a slice of the batch is enough; the slices straddle the first
    # chunk boundary and hold the last chunk (ragged where the chunk does
    # not divide b)
    out = ef.expert_fusion_gather_bwd(xs, wp, bp, w1, b1, w2, idx, d_out)
    for i in sorted({max(0, min(nc, b) - 6), max(0, b - 32)}):
        j = min(b, i + 32)
        ref = ef.expert_fusion_gather_bwd_reference(
            tuple(x[i:j] for x in xs), wp, bp, w1, b1, w2, idx[i:j],
            d_out[i:j])
        hold_k2(torch, f"flagship B={b} samples {i}-{j - 1} (chunks of {nc})",
                [[t[i:j] for t in o] if isinstance(o, tuple) else o[i:j]
                 for o in out], ref)
        del ref
    del args, d_out, out
    torch.cuda.empty_cache()
    return {f"ms_b{b}": ms, f"bound_ms_b{b}": bound}


TRAIN_OVERRIDES = [
    "experiment=pretraining_medmoe_ddp", "data=synthetic",
    "trainer.max_epochs=1", "trainer.limit_train_batches=8",
    "trainer.accumulate_grad_batches=4", "trainer.limit_val_batches=1",
    "trainer.num_sanity_val_steps=0", "callbacks=none", "logger=csv",
    "extras.print_config=false", "trainer.log_every_n_steps=1"]


def launch_counts():
    """Every kernel's launch counter, by kernel."""
    from medmoe_torch.ops import expert_fusion as ef, gloria_attention as ga

    return {"K1": ef.LAUNCHES, "K2": ef.BWD_LAUNCHES, "K3": ga.LAUNCHES,
            "prologue": ga.PROLOGUE_LAUNCHES, "K4a": ga.DCTX_LAUNCHES,
            "K4b": ga.DWORDS_LAUNCHES}


def reset_launch_counts():
    from medmoe_torch.ops import expert_fusion as ef, gloria_attention as ga

    ef.LAUNCHES = ef.BWD_LAUNCHES = 0
    ga.LAUNCHES = ga.PROLOGUE_LAUNCHES = 0
    ga.DCTX_LAUNCHES = ga.DWORDS_LAUNCHES = 0


def drive_train(torch, overrides, root=None):
    """The train CLI's ``train`` on ``overrides`` (under ``paths.root_dir``
    ``root``, a temporary directory when None), with every launch count
    set to 0 just before and read just after, and the experts that
    training routed to recorded. Returns (cfg, metrics, objs, counts,
    routed, seconds, peak GB)."""
    import tempfile

    from medmoe_torch.cli.train import train
    from medmoe_torch.config import compose
    from medmoe_torch.models import moe as tmoe
    from medmoe_torch.utils.task import extras

    routed = []
    real_routing = tmoe.topk_routing

    def recording_routing(probs, k):       # the experts training routes to
        idx, w = real_routing(probs, k)
        if torch.is_grad_enabled():
            routed.append(idx.detach())
        return idx, w

    with contextlib.ExitStack() as stack:
        if root is None:
            root = stack.enter_context(tempfile.TemporaryDirectory())
        cfg = compose("train", overrides + [f"paths.root_dir={root}"])
        extras(cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tmoe.topk_routing = recording_routing
        reset_launch_counts()
        t0 = time.perf_counter()
        try:
            metrics, objs = train(cfg)
            torch.cuda.synchronize()
        finally:
            tmoe.topk_routing = real_routing
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(os.path.isfile(os.path.join(cfg.paths.output_dir, "csv",
                                           "metrics.csv")), "no metrics.csv")
    return cfg, metrics, objs, counts, routed, seconds, peak_gb


def phase_train(torch, ef, card: str):
    """Two optimizer steps of experiment=pretraining_medmoe_ddp at full
    width through the train CLI's ``train``; returns (K1 launches, K2
    launches, pairs/s)."""
    print("train: accumulate_grad_batches cut from 80 to 4 (2 optimizer "
          "steps of 4 x 32 pairs) to fit the run's time", flush=True)
    cfg, metrics, objs, counts, routed, seconds, peak_gb = drive_train(
        torch, TRAIN_OVERRIDES)
    k1, k2 = counts["K1"], counts["K2"]
    trainer, module = objs["trainer"], objs["module"]
    print(f"train: {trainer.state.step} optimizer steps in {seconds:.1f} s "
          f"(init and validation included); metrics "
          + json.dumps({k: round(v, 6) for k, v in sorted(metrics.items())}),
          flush=True)
    check(trainer.state.step == 2, f"{trainer.state.step} optimizer steps")
    for key in ("train/loss", "train/grad_norm", "val/loss"):
        check(key in metrics and math.isfinite(metrics[key]),
              f"{key} missing or not finite")
    check(metrics["train/grad_norm"] > 0, "grad_norm is 0")
    check(k2 == 8, f"K2 launched {k2} times for 8 micro-batches")
    check(k1 >= 8, f"K1 launched {k1} times for 8 micro-batches")
    check(counts["K3"] == counts["prologue"] == counts["K4a"]
          == counts["K4b"] == 0,
          f"the B=32 losses launched GLoRIA kernels: {counts}")

    experts, moved_rows = check_moved(torch, module, cfg.seed, routed,
                                      "train")
    pairs_s = metrics["pairs_per_sec"]
    print(f"train: routed experts {experts}; {moved_rows} expert-bank rows "
          f"moved, unrouted rows and attn_b2 unchanged; Swin moved; frozen "
          f"BERT unchanged; K1 launches {k1}, K2 launches {k2}; "
          f"{pairs_s:.1f} pairs/s over the epoch (first step included); "
          f"peak memory {peak_gb:.2f} GB on {card}", flush=True)
    dm = objs["datamodule"]
    warm, share, alone = time_trainer_windows(torch, trainer, module, dm, 4,
                                              8)
    print(f"train: warm trainer path, 2 windows of 4 x {dm.batch_size}: "
          f"{warm:.1f} pairs/s, loader wait {100 * share:.1f}% of the time; "
          f"the synthetic data alone on the host: {alone:.1f} pairs/s",
          flush=True)
    if "--profile" in sys.argv:
        profile_train_step(torch, trainer, module, objs["datamodule"])
    return k1, k2, pairs_s


def check_moved(torch, module, seed: int, routed, label: str,
                bert_trains: bool = False):
    """Parameters against the same seeded initialization on the CPU: the
    routed experts' bank rows and the Swin tower moved, the unrouted rows
    and attn_b2 did not, and BERT moved only when it trains. Returns (the
    routed experts, the number of bank rows that moved)."""
    from medmoe_torch.models.medmoe import MedMoE, init_weights

    model = module.model
    init = init_weights(MedMoE(model.vision, model.text),
                        seed=seed).state_dict()
    now = {k: v.detach().float().cpu() for k, v in model.state_dict().items()}
    experts = sorted(set(torch.cat(routed).flatten().tolist()))
    bank = "image_encoder.swin_moe.moe.experts."
    moved_rows = bert_moved = 0
    for k, v in now.items():
        if k.startswith(bank) and not k.endswith("attn_b2"):
            for e in range(v.shape[0]):
                moved = not torch.equal(v[e], init[k][e])
                check(moved == (e in experts), f"{label}: {k}[{e}] moved="
                      f"{moved}, routed experts {experts}")
                moved_rows += moved
        elif k.startswith("image_encoder.swin_moe.swin.") \
                and not k.endswith("key.bias"):
            check(not torch.equal(v, init[k]), f"{label}: Swin parameter {k} "
                  f"did not change")
        elif k.startswith("text_encoder.bert."):
            moved = not torch.equal(v, init[k])
            if not bert_trains:
                check(not moved, f"{label}: frozen BERT parameter {k} changed")
            bert_moved += moved
    if bert_trains:
        check(bert_moved > 0, f"{label}: no BERT parameter moved")
    return experts, moved_rows


def time_trainer_windows(torch, trainer, module, datamodule, accum: int,
                         n=None, epoch: int = 1):
    """The trainer's data path and step, warm: ``n`` micro-batches of
    ``epoch`` (the whole epoch when None) in windows of ``accum``, each
    drawn and copied on the prefetch thread as ``Trainer.fit`` does, on
    the host clock; first the same batches drawn alone on the host, which
    bounds what the trainer can reach. Returns (pairs/s, the share of the
    time blocked in ``next`` on the prefetch queue, the loader alone's
    pairs/s)."""
    import itertools

    from medmoe_torch.data.prefetch import prefetch
    from medmoe_torch.train.loop import _timed
    from medmoe_torch.train.step import build_train_step

    def batches():
        return itertools.islice(datamodule.train_dataloader(epoch), n)

    t0 = time.perf_counter()
    n_alone = sum(len(b["cap_lens"]) for b in batches())
    alone_s = time.perf_counter() - t0
    step = build_train_step(module, accum)
    waits, window, pairs = [0.0], [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in _timed(prefetch(batches(), trainer.prefetch_batches,
                                 trainer.to_device), waits):
        window.append(batch)
        pairs += len(batch["cap_lens"])
        if len(window) == accum:
            trainer.state, _ = step(trainer.state, window)
            window = []
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(pairs == n_alone, f"the trainer drew {pairs} pairs, the loader "
          f"alone {n_alone}")
    if n is None:
        check(pairs == datamodule.steps_per_epoch * datamodule.batch_size,
              f"an epoch of {pairs} pairs, expected "
              f"{datamodule.steps_per_epoch} batches of "
              f"{datamodule.batch_size}")
    return pairs / seconds, waits[0] / seconds, n_alone / alone_s


def profile_train_step(torch, trainer, module, datamodule):
    """One optimizer step of one micro-batch of 32, timed warm and then
    profiled."""
    from medmoe_torch.train.step import build_train_step

    batch = trainer.to_device(next(iter(datamodule.train_dataloader(0))))
    step = build_train_step(module, 1)
    for _ in range(2):
        step(trainer.state, [batch])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        step(trainer.state, [batch])
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 3 * 1e3
    print(f"profile: train step of 32 pairs, unprofiled {wall_ms:.3f} ms = "
          f"{32 / wall_ms * 1e3:.1f} pairs/s", flush=True)
    profile_device(torch, lambda: step(trainer.state, [batch]), wall_ms,
                   "one train step (B=32)")

GLORIA_BATCH = 256
GLORIA_OVERRIDES = [
    "experiment=gloria256", "data=synthetic",
    f"data.batch_size={GLORIA_BATCH}", f"data.num_samples={2 * GLORIA_BATCH}",
    "trainer.max_epochs=1", "trainer.limit_train_batches=2",
    "trainer.limit_val_batches=1", "trainer.num_sanity_val_steps=0",
    "callbacks=none", "logger=csv", "extras.print_config=false",
    "trainer.log_every_n_steps=1"]


def gloria_inputs(torch, b_img, b_txt, d, h, w, t, seed):
    """ctx in the local map's own layout (a [B, D, H, W] view of a
    [B, H·W, D] bf16 tensor, as models/moe.py hands it to the loss),
    words [B_txt, D, T] bf16 ~N(0,1), caption lengths in [3, T], and a
    seeded cotangent [B_img, B_txt]."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = torch.randn((b_img, h * w, d), generator=g, device="cuda")
    img = rows.to(torch.bfloat16).permute(0, 2, 1).reshape(b_img, d, h, w)
    words = torch.randn((b_txt, d, t), generator=g, device="cuda")
    cap = torch.randint(3, t + 1, (b_txt,), generator=g, device="cuda")
    cot = torch.randn((b_img, b_txt), generator=g, device="cuda")
    return img, words.to(torch.bfloat16), cap.to(torch.int32), cot


def gloria_bound(img, words, out_bytes, products):
    """(bound ms, bound_by, GFLOP, MB): ``products`` products of
    2·M·T·D per pair at the bf16 rate, against the inputs read once (ctx,
    words, caption lengths, the cotangent for a backward) and the output
    written once."""
    b_img, d, h, w = img.shape
    b_txt, _, t = words.shape
    flops = products * 2 * b_img * b_txt * h * w * t * d
    nbytes = img.numel() * img.element_size() + words.numel() * 2 \
        + b_txt * 4 + out_bytes
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            flops / 1e9, nbytes / 1e6)


def gloria_err(torch, got, want, name, gate):
    """Max abs error of ``got`` against ``want``; ``gate`` "fwd": every
    element within 1e-3·max|ref| (only f32 summation order and the softmax
    offset differ; worst measured on the H100 2.4e-7·max|ref|); "bwd":
    every element within 1e-2·max|ref| and at most 1% of the elements
    beyond 2e-3·max|ref| (a value on the other side of a bf16 rounding
    boundary of a2, d_wei or d_scores moves its term by one bf16 step;
    worst measured 3.6e-3·max|ref|, and 4.6e-4 of the elements beyond)."""
    got, want = got.float(), want.float()
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} vs "
          f"{tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    scale = want.abs().max().item()
    diff = (got - want).abs()
    err = diff.max().item()
    if gate == "fwd":
        ok = err <= 1e-3 * scale
        limit = "limit 1e-3*max|ref|"
    else:
        beyond = (diff > 2e-3 * scale).float().mean().item()
        ok = err <= 1e-2 * scale and beyond <= 0.01
        limit = (f"limit 1e-2*max|ref|; share beyond 2e-3*max|ref| "
                 f"{beyond:.2e}, at most 0.01")
    print(f"{name}: max_abs_err {err:.3e} max|ref| {scale:.3e} ({limit}) "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    check(ok, f"{name}: kernel disagrees with its plain version")
    return err


def phase_gloria(torch, ga, card: str, words: int = 25):
    """K3, K4a and K4b against their plain versions at B=256 flagship
    shapes (captions of ``words`` words) and on small odd shapes; times of
    each and of the plain versions; K3+K4a against the einsum path at
    B=32."""
    temps = (4.0, 5.0, 10.0)
    results = {}
    cases = [
        (f"flagship B=256 T={words}",
         (GLORIA_BATCH, GLORIA_BATCH, 768, 56, 56, words)),
        ("odd 3x5 D=48 7x5 T=9", (3, 5, 48, 7, 5, 9)),
        ("odd 4x3 D=80 9x9 T=32", (4, 3, 80, 9, 9, 32)),
        ("odd 3x5 D=48 7x5 T=40", (3, 5, 48, 7, 5, 40)),
        ("odd 3x5 D=48 12x11 T=9", (3, 5, 48, 12, 11, 9)),
    ]
    for name, shape in cases:
        img, words, cap, cot = gloria_inputs(torch, *shape, seed=21)
        b_img, b_txt, d = shape[0], shape[1], shape[2]
        out = ga.gloria_similarity_forward(img, words, cap, *temps)
        torch.cuda.synchronize()
        ref = ga.gloria_similarity_reference(img, words, cap, *temps)
        err3 = gloria_err(torch, out, ref, f"K3 {name}", "fwd")
        del out, ref
        d_img, d_words = ga.gloria_similarity_backward(img, words, cap, cot,
                                                       *temps)
        torch.cuda.synchronize()
        r_img, r_words = ga.gloria_similarity_bwd_reference(img, words, cap,
                                                            cot, *temps)
        err4a = gloria_err(torch, d_img, r_img, f"K4a {name} d_img", "bwd")
        err4b = gloria_err(torch, d_words, r_words, f"K4b {name} d_words",
                           "bwd")
        del d_img, d_words, r_img, r_words
        torch.cuda.empty_cache()
        if results:
            continue
        h, w, t = shape[3:]
        scratch = ga.backward_scratch_bytes(b_img, b_txt, h * w, d, t)
        chunk, z_bytes = ga.image_chunk(b_img, b_txt, h * w, t)
        print(f"K4 {name}: backward scratch {scratch / 1e9:.3f} GB (bf16 "
              f"d_wei and per-word vectors per pair, K4b's f32 accumulators, "
              f"the prologue's passes over a chunk); E [hi | lo of e] and "
              f"Z [a2 | d_scores] {z_bytes / 1e9:.3f} GB for a chunk of "
              f"{chunk} images", flush=True)

        def fwd():
            ga.gloria_similarity_forward(img, words, cap, *temps)

        def bwd(need_img, need_words, plain=False):
            fn = ga.gloria_similarity_bwd_reference if plain \
                else ga.gloria_similarity_backward
            return lambda: fn(img, words, cap, cot, *temps,
                              need_img=need_img, need_words=need_words)

        ms3 = cuda_ms(fwd, iters=3, warmup=1)
        plain3 = cuda_ms(lambda: ga.gloria_similarity_reference(
            img, words, cap, *temps), iters=1, warmup=0)
        # the prologue alone, K4a alone (both passes, from one prologue's
        # scratch), the two together (K4a's kernel_ms, which has always
        # included the prologue), and both cotangents (the prologue with
        # K4b's f32 terms, pass 1, K4a's pass 2 and K4b a chunk): K4b alone
        # is the last less the prologue + K4a
        ms_pro = cuda_ms(bwd(False, False), iters=2, warmup=1)
        pairs = ga.pair_cotangents(img, words, cap, cot, *temps)
        ms_k4a = cuda_ms(lambda: ga.cotangents_of(pairs), iters=3, warmup=1)
        del pairs
        ms4a = cuda_ms(bwd(True, False), iters=2, warmup=1)
        plain4a = cuda_ms(bwd(True, False, True), iters=1, warmup=0)
        ms_both = cuda_ms(bwd(True, True), iters=2, warmup=1)
        plain4b = cuda_ms(bwd(False, True, True), iters=1, warmup=0)
        out_img = img.numel() * img.element_size()
        for key, ms, plain, err, products, out_bytes in (
                ("K3", ms3, plain3, err3, 2, b_img * b_txt * 4),
                ("K4a", ms4a, plain4a, err4a, 3, out_img + b_img * b_txt * 4),
                ("K4b", ms_both - ms4a, plain4b, err4b, 1,
                 words.numel() * 2 + b_img * b_txt * 4)):
            bound, by, gflop, mb = gloria_bound(img, words, out_bytes, products)
            results[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                bound_ms=bound, bound_by=by)
            print(f"{key} {name}: kernel_ms {ms:.4f} plain_ms {plain:.4f} "
                  f"bound_ms {bound:.4f} ({by}: {products} products, "
                  f"{gflop:.1f} GFLOP, {mb:.1f} MB) on {card}", flush=True)
        pro_bound, _, _, _ = gloria_bound(img, words,
                                          prologue_out_bytes(ga, shape), 2)
        results["K4a"].update(k4a_only_ms=ms_k4a)
        results["K4b"].update(both_ms=ms_both)
        for key in ("K4a", "K4b"):
            results[key].update(prologue_ms=ms_pro, prologue_bound_ms=pro_bound)
        print(f"K4a {name}: the backward's prologue alone {ms_pro:.4f} ms "
              f"(bound {pro_bound:.4f} ms), K4a alone (both passes) "
              f"{ms_k4a:.4f} ms, prologue + K4a {ms4a:.4f} ms; bound "
              f"{results['K4a']['bound_ms']:.4f} ms on {card}", flush=True)
        print(f"K4b {name}: prologue + K4a + K4b (both cotangents) "
              f"{ms_both:.4f} ms, K4b alone {ms_both - ms4a:.4f} ms "
              f"(bound {results['K4b']['bound_ms']:.4f} ms: its own product) "
              f"on {card}", flush=True)
        print("K4a's kernel_ms includes the backward's prologue; K4b's is the "
              "both-cotangent time less the prologue + K4a", flush=True)
        del img, words, cap, cot
        torch.cuda.empty_cache()

    # the local loss at B=32 flagship: fused (K3 + K4a) against the einsum
    # path, forward and backward of the image side; printed only, the
    # auto dispatch keeps the JAX package's threshold (B > 64)
    from medmoe_torch.ops import losses as L

    img, words, cap, _ = gloria_inputs(torch, 32, 32, 768, 56, 56, 25, seed=22)
    leaf = img.detach().clone().requires_grad_()
    times = {}
    for impl in ("pallas", "xla", "xla", "pallas"):
        loss_fn = L.GLORIALocalContrastiveLoss(impl=impl)

        def step():
            out = loss_fn(leaf, words, cap, *temps)
            torch.autograd.grad(out.loss0 + out.loss1, leaf)

        times.setdefault(impl, []).append(cuda_ms(step, iters=5, warmup=2))
    print(f"local loss B=32 flagship, forward + image backward: fused "
          f"(K3 + K4a) {min(times['pallas']):.4f} ms, einsum path "
          f"{min(times['xla']):.4f} ms (best of two runs each) on {card}",
          flush=True)
    del img, words, cap, leaf
    torch.cuda.empty_cache()
    return results


def prologue_out_bytes(ga, shape) -> int:
    """Bytes the backward's prologue writes: bf16(d_wei) and the four
    per-word vectors per pair, and the cotangent it reads."""
    b_img, b_txt, d, _, _, t = shape
    tp = ga._tpad(t)
    return b_img * b_txt * (d * tp * 2 + 4 * tp * 4 + 4)


def phase_gloria_wide(torch, ga, card: str, words: int = 40):
    """K3 against its plain version at B=256 flagship shapes with captions
    of ``words`` words, and the times of K3, its plain version, the
    backward's prologue, the prologue + K4a and the backward of both
    cotangents there."""
    temps = (4.0, 5.0, 10.0)
    shape = (GLORIA_BATCH, GLORIA_BATCH, 768, 56, 56, words)
    name = f"flagship B=256 T={words}"
    img, words_, cap, cot = gloria_inputs(torch, *shape, seed=23)
    out = ga.gloria_similarity_forward(img, words_, cap, *temps)
    torch.cuda.synchronize()
    ref = ga.gloria_similarity_reference(img, words_, cap, *temps)
    gloria_err(torch, out, ref, f"K3 {name}", "fwd")
    del out, ref
    ms3 = cuda_ms(lambda: ga.gloria_similarity_forward(img, words_, cap, *temps),
                  iters=3, warmup=1)
    plain3 = cuda_ms(lambda: ga.gloria_similarity_reference(
        img, words_, cap, *temps), iters=1, warmup=0)
    ms_pro = cuda_ms(lambda: ga.pair_cotangents(img, words_, cap, cot, *temps),
                     iters=2, warmup=1)

    def bwd(need_words):
        return lambda: ga.gloria_similarity_backward(
            img, words_, cap, cot, *temps, need_words=need_words)

    ms4a = cuda_ms(bwd(False), iters=2, warmup=1)
    ms_both = cuda_ms(bwd(True), iters=2, warmup=1)
    bound3, by, gflop, _ = gloria_bound(img, words_, GLORIA_BATCH ** 2 * 4, 2)
    pro_bound, _, _, _ = gloria_bound(img, words_, prologue_out_bytes(ga, shape),
                                      2)
    print(f"K3 {name}: kernel_ms {ms3:.4f} plain_ms {plain3:.4f} bound_ms "
          f"{bound3:.4f} ({by}: 2 products, {gflop:.1f} GFLOP); the "
          f"backward's prologue alone {ms_pro:.4f} ms (bound {pro_bound:.4f} "
          f"ms), prologue + K4a {ms4a:.4f} ms, prologue + K4a + K4b "
          f"{ms_both:.4f} ms (K4b alone {ms_both - ms4a:.4f} ms) on {card}",
          flush=True)
    del img, words_, cap, cot
    torch.cuda.empty_cache()


def phase_gloria_train(torch, card: str):
    """Two optimizer steps of experiment=gloria256 (one batch of 256 a
    step, global negatives) at full width through the train CLI's
    ``train``, then one warm step; returns the launch counts."""
    from medmoe_torch.train.step import build_train_step

    cfg, metrics, objs, counts, routed, seconds, peak_gb = drive_train(
        torch, GLORIA_OVERRIDES)
    trainer, module = objs["trainer"], objs["module"]
    print(f"gloria256: {trainer.state.step} optimizer steps of "
          f"{GLORIA_BATCH} pairs in {seconds:.1f} s (init and validation "
          f"included); launches {counts}; metrics "
          + json.dumps({k: round(v, 6) for k, v in sorted(metrics.items())}),
          flush=True)
    check(trainer.state.step == 2, f"{trainer.state.step} optimizer steps")
    for key in ("train/loss", "train/grad_norm", "train/l_loss", "val/loss"):
        check(key in metrics and math.isfinite(metrics[key]),
              f"gloria256: {key} missing or not finite")
    check(metrics["train/loss"] > 0 and metrics["train/grad_norm"] > 0,
          "gloria256: loss or grad_norm not positive")
    # two training forwards and one validation forward; K4b never (BERT
    # is frozen, so words_emb needs no gradient)
    check(counts["K3"] == 3, f"K3 launched {counts['K3']} times for 3 "
          f"forwards")
    check(counts["prologue"] == 2, f"the backward's prologue launched "
          f"{counts['prologue']} times for 2 backwards")
    check(counts["K4a"] == 2, f"K4a launched {counts['K4a']} times for 2 "
          f"backwards")
    check(counts["K4b"] == 0, f"K4b launched {counts['K4b']} times with "
          f"BERT frozen")
    check(counts["K2"] == 2, f"K2 launched {counts['K2']} times for 2 "
          f"backwards")
    check(counts["K1"] >= 3, f"K1 launched {counts['K1']} times for 3 "
          f"forwards")
    experts, moved_rows = check_moved(torch, module, cfg.seed, routed,
                                      "gloria256")
    batch = trainer.to_device(next(iter(objs["datamodule"].train_dataloader(1))))
    step_ms = warm_step_ms(torch, trainer, module, batch)
    peak_warm = torch.cuda.max_memory_allocated() / 1e9
    print(f"gloria256: routed experts {experts}; {moved_rows} expert-bank "
          f"rows moved; Swin moved; frozen BERT unchanged; "
          f"{metrics['pairs_per_sec']:.1f} pairs/s over the epoch (first "
          f"step included); warm step {step_ms:.3f} ms = "
          f"{GLORIA_BATCH / step_ms * 1e3:.1f} pairs/s; peak memory "
          f"{max(peak_gb, peak_warm):.2f} GB on {card}", flush=True)
    if "--profile" in sys.argv:
        step = build_train_step(module, 1)
        profile_device(torch, lambda: step(trainer.state, [batch]), step_ms,
                       f"one gloria256 step (B={GLORIA_BATCH})")
    del objs, trainer, module, batch
    torch.cuda.empty_cache()
    return counts


def warm_step_ms(torch, trainer, module, batch) -> float:
    """One optimizer step of one batch, after one untimed step, on the host
    clock around work that ends in a device sync."""
    from medmoe_torch.train.step import build_train_step

    step = build_train_step(module, 1)
    step(trainer.state, [batch])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(trainer.state, [batch])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_text_train(torch, card: str):
    """One optimizer step of the gloria256 run with the text tower
    training (model.model.text.freeze_bert=false), the path on which
    words_emb needs a gradient and K4b runs; returns the launch counts."""
    overrides = [o for o in GLORIA_OVERRIDES
                 if not o.startswith(("trainer.limit_train_batches",
                                      "trainer.limit_val_batches"))]
    overrides += ["model.model.text.freeze_bert=false",
                  "trainer.limit_train_batches=1",
                  "trainer.limit_val_batches=0"]
    cfg, metrics, objs, counts, routed, seconds, peak_gb = drive_train(
        torch, overrides)
    trainer, module = objs["trainer"], objs["module"]
    print(f"text training: {trainer.state.step} optimizer step of "
          f"{GLORIA_BATCH} pairs in {seconds:.1f} s; launches {counts}; "
          f"train/loss {metrics.get('train/loss')}", flush=True)
    check(trainer.state.step == 1, f"{trainer.state.step} optimizer steps")
    check(math.isfinite(metrics.get("train/loss", float("nan"))),
          "text training: loss not finite")
    check(counts["K3"] == counts["prologue"] == counts["K4a"]
          == counts["K4b"] == 1, f"text training: launches {counts}, "
          f"expected K3, the prologue, K4a and K4b once")
    check_moved(torch, module, cfg.seed, routed, "text training",
                bert_trains=True)
    batch = trainer.to_device(next(iter(objs["datamodule"].train_dataloader(1))))
    step_ms = warm_step_ms(torch, trainer, module, batch)
    peak_warm = torch.cuda.max_memory_allocated() / 1e9
    print(f"text training: BERT moved; warm step {step_ms:.3f} ms = "
          f"{GLORIA_BATCH / step_ms * 1e3:.1f} pairs/s; peak memory "
          f"{max(peak_gb, peak_warm):.2f} GB on {card}", flush=True)
    del objs, trainer, module, batch
    torch.cuda.empty_cache()
    return counts


DISK_SHARD = 64                   # pairs a shard
DISK_MODALITIES = ("chest x-ray of the lungs", "ct scan of the abdomen",
                   "mri of the brain", "ultrasound of the thyroid",
                   "histopathology slide of tissue",
                   "fundus photograph of the retina")


def write_disk_data(root: str, seed: int = 7):
    """Tar shards written by the port's ShardWriter from numpy seeds: one
    train shard of DISK_SHARD pairs per modality label 0-5
    (train/dataset-{000001..000006}.tar) and one val shard
    (val/dataset-000007.tar), each pair a non-square (256 x 320) JPEG at
    quality 90, a multi-template caption and a ``cls`` label; the val
    shard's images also as files under serve/. Returns (train URLs in the
    ``::`` multi-source syntax, val URL, serve dir)."""
    import numpy as np
    from PIL import Image

    from medmoe_torch.data.shard_writer import ShardWriter

    rng = np.random.RandomState(seed)

    def jpeg() -> bytes:
        # a smooth field plus noise: JPEG sizes of a real scan, not of noise
        base = Image.fromarray((rng.rand(16, 20, 3) * 255).astype(np.uint8))
        arr = np.asarray(base.resize((320, 256), Image.BILINEAR),
                         dtype=np.int16)
        arr = arr + rng.randint(-12, 13, arr.shape)
        buf = io.BytesIO()
        Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(
            buf, format="JPEG", quality=90)
        return buf.getvalue()

    def caption(label: int, i: int) -> str:
        name = DISK_MODALITIES[label]
        return (f"{name}, case {i}_radimagenet_{name} with findings "
                f"{i % 7}_radimagenet_an image of {name}")

    urls = []
    for label in range(6):
        path = os.path.join(root, "train", f"dataset-{label + 1:06d}.tar")
        with ShardWriter(path) as w:
            for i in range(DISK_SHARD):
                w.write({"__key__": f"m{label}_{i:04d}", "jpg": jpeg(),
                         "txt": caption(label, i), "cls": label})
        urls.append(path)
    val = os.path.join(root, "val", "dataset-000007.tar")
    serve_dir = os.path.join(root, "serve")
    os.makedirs(serve_dir)
    with ShardWriter(val) as w:
        for i in range(DISK_SHARD):
            data = jpeg()
            w.write({"__key__": f"v_{i:04d}", "jpg": data,
                     "txt": caption(i % 6, i), "cls": i % 6})
            with open(os.path.join(serve_dir, f"v_{i:04d}.jpg"), "wb") as f:
                f.write(data)
    return "::".join(urls), val, serve_dir


def disk_overrides(train_urls: str, val_url: str, epochs: int):
    return [
        "experiment=pretraining_medmoe_ddp", "data=unimed",
        "callbacks=default", "trainer.checkpoint_on_signal=true",
        f"data.train_data_paths={train_urls}",
        f"data.val_data_paths={val_url}",
        f"data.num_workers={min(8, os.cpu_count() or 1)}",
        "trainer.accumulate_grad_batches=2", "trainer.limit_train_batches=4",
        "trainer.limit_val_batches=1", "trainer.num_sanity_val_steps=0",
        f"trainer.max_epochs={epochs}", "logger=csv",
        "extras.print_config=false", "trainer.log_every_n_steps=1"]


@contextlib.contextmanager
def step_hooks(before=None, after=None):
    """Call ``before(state)`` ahead of the first optimizer step the trainer
    takes, and ``after(state)`` after every one."""
    from medmoe_torch.train import loop

    real_build = loop.build_train_step
    first = [before]

    def build(module, accum_steps=1):
        step = real_build(module, accum_steps)

        def hooked(state, window):
            if first[0] is not None:
                first[0](state)
                first[0] = None
            out = step(state, window)
            if after is not None:
                after(state)
            return out
        return hooked

    loop.build_train_step = build
    try:
        yield
    finally:
        loop.build_train_step = real_build


@contextlib.contextmanager
def timed_calls(owner, name: str, seconds: list):
    """Append the wall seconds of every call of ``owner.<name>`` to
    ``seconds``."""
    real = getattr(owner, name)

    def timed(*a, **k):
        t = time.perf_counter()
        try:
            return real(*a, **k)
        finally:
            seconds.append(time.perf_counter() - t)

    setattr(owner, name, timed)
    try:
        yield
    finally:
        setattr(owner, name, real)


def check_restored(torch, path: str, label: str):
    """A ``before`` hook: the trainer's parameters and Adam state equal
    the checkpoint file's, bit for bit, before the first resumed step."""
    from medmoe_torch.utils.checkpoint import load_checkpoint

    def hook(state):
        saved = load_checkpoint(path)
        live = state.state_dict()
        for k, v in live["model"].items():
            check(torch.equal(v.cpu(), saved["model"][k]),
                  f"{label}: restored {k} differs from the checkpoint")
        for i, s in live["optimizer"]["state"].items():
            for k, v in s.items():
                check(torch.equal(v.cpu(), saved["optimizer"]["state"][i][k]),
                      f"{label}: restored Adam {k} of parameter {i} differs")
        check(state.step == saved["step"], f"{label}: step {state.step} vs "
              f"the checkpoint's {saved['step']}")
        print(f"{label}: {len(live['model'])} parameters and "
              f"{len(live['optimizer']['state'])} Adam states equal the "
              f"checkpoint's, bit for bit, before the first resumed step "
              f"(step {state.step})", flush=True)
    return hook


def epoch_line(trainer) -> str:
    return "; ".join(
        f"epoch {i}: {h['pairs_per_sec']:.1f} pairs/s, loader wait "
        f"{100 * h['loader_wait_share']:.1f}% of the train phase"
        for i, h in enumerate(trainer.metrics_history))


def phase_disk_train(torch, card: str, work: str):
    """experiment=pretraining_medmoe_ddp from tar shards on disk at full
    width, under ``work``: train 1 epoch (epoch_000 and last written),
    resume for 3 and preempt it with SIGTERM after the first step of epoch
    1, resume again and finish epochs 1-2 (images as uint8), then serve the
    best checkpoint through the serve CLI. Returns the launch counts summed
    over the four runs, and (train URLs, val URL, the best checkpoint) for
    phase_eval."""
    import signal

    import numpy as np

    from medmoe_torch.cli import serve
    from medmoe_torch.data.transforms import ImageTransform, decode_image
    from medmoe_torch.eval.zero_shot import make_image_embedder
    from medmoe_torch.train import loop
    from medmoe_torch.train.callbacks import ModelCheckpoint
    from medmoe_torch.utils.checkpoint import (finalize_saves,
                                               load_checkpoint, read_meta,
                                               save_checkpoint)
    from medmoe_torch.utils.instantiate import instantiate

    print("disk train: accumulate_grad_batches cut from 80 to 2, 4 "
          "micro-batches of 32 an epoch, 1 val batch", flush=True)
    total = {}
    t0 = time.perf_counter()
    train_urls, val_url, serve_dir = write_disk_data(work)
    print(f"disk train: wrote 6 train shards and 1 val shard of "
          f"{DISK_SHARD} JPEG pairs in {time.perf_counter() - t0:.1f} s",
          flush=True)
    root = os.path.join(work, "run")
    ckdir = os.path.join(root, "logs", "train", "runs", "checkpoints")
    last = os.path.join(ckdir, "last")

    resume_s = []

    def run(label, epochs, *extra, before=None, after=None):
        # what the checkpoints stall the loop: ModelCheckpoint at each
        # epoch end (the best, then last, async as shipped) and at
        # train end (the commit), and a preemption's blocking save
        ends, commits, preempts = [], [], []
        with step_hooks(before, after), \
                timed_calls(ModelCheckpoint, "on_epoch_end", ends), \
                timed_calls(ModelCheckpoint, "on_train_end", commits), \
                timed_calls(loop.Trainer, "_preempt_checkpoint",
                            preempts), \
                timed_calls(loop.Trainer, "_resume", resume_s):
            cfg, metrics, objs, counts, _, seconds, peak = drive_train(
                torch, disk_overrides(train_urls, val_url, epochs)
                + list(extra), root)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        trainer = objs["trainer"]
        stalls = ", ".join(f"{t:.3f}" for t in ends)
        print(f"{label}: {seconds:.1f} s, step {trainer.state.step}, "
              f"launches {counts}; {epoch_line(trainer)}; checkpoint "
              f"stall at each epoch end [{stalls}] s, at train end "
              f"{commits[0]:.3f} s"
              + "".join(f", preemption save {t:.3f} s" for t in preempts)
              + f"; peak memory {peak:.2f} GB on {card}", flush=True)
        return cfg, objs, counts

    # 1. one epoch: epoch_000 and last, each with its sidecar
    _, objs, counts = run("disk train 1", 1)
    trainer = objs["trainer"]
    check(trainer.state.step == 2, f"run 1: {trainer.state.step} steps")
    check(counts["K2"] == 4 and counts["K1"] >= 4,
          f"run 1: launches {counts} for 4 micro-batches")
    for name in ("epoch_000", "last"):
        check(os.path.isfile(os.path.join(ckdir, name)) and
              read_meta(os.path.join(ckdir, name)) is not None,
              f"run 1 wrote no {name} with a sidecar")
    h = trainer.metrics_history[-1]
    check(math.isfinite(h["train/loss"]) and math.isfinite(h["val/loss"]),
          f"run 1: losses {h}")
    del objs, trainer
    ckpt_gb = os.path.getsize(last) / 1e9

    # 2. resume for 3 epochs; SIGTERM after the first step of epoch 1
    def preempt(state):
        if state.step == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    handler = signal.getsignal(signal.SIGTERM)
    _, objs, _ = run("disk train 2 (preempted)", 3, f"ckpt_path={last}",
                     before=check_restored(torch, last, "resume 1"),
                     after=preempt)
    trainer = objs["trainer"]
    meta = read_meta(last)
    check(trainer.interrupted and trainer.state.step == 3,
          f"run 2: interrupted {trainer.interrupted} at step "
          f"{trainer.state.step}")
    check(meta["epoch"] == 0 and meta.get("preempted") is True,
          f"run 2: last's sidecar {meta}")
    check(signal.getsignal(signal.SIGTERM) is handler,
          "run 2 left its SIGTERM handler installed")
    del objs, trainer

    # 3. resume again and finish epochs 1-2, shipping uint8 images
    cfg, objs, _ = run("disk train 3 (uint8)", 3, f"ckpt_path={last}",
                       "data.emit_uint8=true",
                       before=check_restored(torch, last, "resume 2"))
    trainer, module = objs["trainer"], objs["module"]
    check(trainer.state.step == 7 and not trainer.interrupted,
          f"run 3 ended at step {trainer.state.step}")
    check(len(trainer.metrics_history) == 2 and all(
        math.isfinite(h["train/loss"]) and h["train/grad_norm"] > 0
        for h in trainer.metrics_history), "run 3: losses not finite")
    kept = sorted(n for n in os.listdir(ckdir)
                  if not n.endswith((".meta.json", ".tmp")))
    top_k = int(cfg.callbacks.model_checkpoint.save_top_k)
    check(len(kept) == top_k + 1 and "last" in kept,
          f"checkpoints {kept} for save_top_k={top_k} plus last")
    best = trainer.best_model_path
    check(bool(best) and os.path.basename(best) in kept,
          f"best_model_path {best!r} not among {kept}")
    resumes = ", ".join(f"{t:.2f}" for t in resume_s)
    print(f"disk train: checkpoints {kept}, best {os.path.basename(best)};"
          f" checkpoint {ckpt_gb:.3f} GB; resumes (load + restore) "
          f"{resumes} s on {card}", flush=True)

    # 4. serve the best checkpoint; hold it against the trained module
    module.model.load_state_dict(load_checkpoint(best)["model"])
    module.model.eval()
    files = sorted(os.listdir(serve_dir))
    transform = ImageTransform(int(cfg.model.model.vision.image_size),
                               train=False)
    images = np.stack([transform(decode_image(
        open(os.path.join(serve_dir, f), "rb").read())) for f in files])
    want = make_image_embedder(module.model)(images).float()
    wave_s = []
    real_waves = serve.serve_waves

    def timed_waves(*a, **k):
        t = time.perf_counter()
        try:
            return real_waves(*a, **k)
        finally:
            torch.cuda.synchronize()
            wave_s.append(time.perf_counter() - t)

    out = io.StringIO()
    serve.serve_waves = timed_waves
    reset_launch_counts()
    try:
        with contextlib.redirect_stdout(out):
            rc = serve.main([f"ckpt_path={best}", "data=unimed",
                             "serve.mode=embed",
                             f"serve.input={serve_dir}",
                             f"paths.root_dir={root}"])
    finally:
        serve.serve_waves = real_waves
    counts = launch_counts()
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    check(rc == 0, f"serve exited {rc}")
    recs = [json.loads(line) for line in out.getvalue().splitlines()]
    check([os.path.basename(r["path"]) for r in recs] == files,
          f"served {len(recs)} records for {len(files)} images")
    got = torch.tensor([r["embedding"] for r in recs],
                       device=want.device)
    cos = (got * want).sum(-1).min().item()
    check(cos > 0.999, f"served embeddings vs the module's: cosine {cos}")
    check(counts["K1"] == len(files) // WAVE,
          f"serve launched K1 {counts['K1']} times")
    print(f"disk serve: {len(recs)} images in {wave_s[0]:.3f} s of waves "
          f"= {len(recs) / wave_s[0]:.1f} img/s (decode on the prefetch "
          f"thread included); min cosine against the trained module "
          f"{cos:.6f}; K1 launches {counts['K1']} on {card}", flush=True)

    # 5. one isolated save of the trained state, blocking and async
    path = os.path.join(work, "timed", "ckpt")
    t = time.perf_counter()
    save_checkpoint(path, trainer.state, extra={"epoch": 0})
    blocking_s = time.perf_counter() - t
    t = time.perf_counter()
    save_checkpoint(path, trainer.state, extra={"epoch": 0},
                    blocking=False)
    call_s = time.perf_counter() - t
    finalize_saves()
    async_s = time.perf_counter() - t
    print(f"disk train: one isolated save of "
          f"{os.path.getsize(path) / 1e9:.3f} GB: blocking "
          f"{blocking_s:.2f} s; async call {call_s:.2f} s "
          f"(the copy to the host), {async_s:.2f} s to commit on {card}",
          flush=True)

    # 6. the warm disk-backed path over an epoch, f32 and uint8
    for uint8 in (False, True):
        dm = instantiate(dict(cfg.data, emit_uint8=uint8))
        pairs_s, share, alone = time_trainer_windows(
            torch, trainer, module, dm, 2, epoch=5)
        print(f"disk train warm epoch: emit_uint8={str(uint8).lower()} "
              f"{pairs_s:.1f} pairs/s, loader wait {100 * share:.1f}% "
              f"of the time; the loader alone on the host {alone:.1f} "
              f"pairs/s; on {card}", flush=True)
    del objs, trainer, module
    torch.cuda.empty_cache()
    return total, (train_urls, val_url, best)


CHEX_IMAGES = 256
CHEX_BATCH = 64            # configs/data/chexpert.yaml batch_size


def write_chexpert(root: str, n: int = CHEX_IMAGES, seed: int = 11) -> str:
    """A CheXpert tree from a numpy seed: valid.csv and ``n`` frontal
    JPEGs of 320 x 390 (width x height) under valid/, each row with the 5
    competition tasks' labels, both classes in every task."""
    import csv

    import numpy as np
    from PIL import Image

    from medmoe_torch.data.datamodules import CheXpertDataModule

    rng = np.random.RandomState(seed)
    tasks = CheXpertDataModule.COMPETITION_TASKS
    labels = rng.randint(0, 2, (n, len(tasks)))
    labels[0], labels[1] = 0, 1
    os.makedirs(os.path.join(root, "valid"))
    rows = []
    for i in range(n):
        base = Image.fromarray((rng.rand(13, 10, 3) * 255).astype(np.uint8))
        arr = np.asarray(base.resize((320, 390), Image.BILINEAR),
                         dtype=np.int16) + rng.randint(-12, 13, (390, 320, 3))
        rel = f"valid/patient{i:05d}_study1_view1_frontal.jpg"
        Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(
            os.path.join(root, rel), format="JPEG", quality=90)
        rows.append({"Path": f"CheXpert-v1.0/{rel}",
                     "Frontal/Lateral": "Frontal",
                     **{t: float(v) for t, v in zip(tasks, labels[i])}})
    with open(os.path.join(root, "valid.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return root


def run_cli(torch, main, argv):
    """A CLI's ``main(argv)`` with every launch count set to 0 just before
    and read just after. Returns (its result, the launch counts, seconds,
    the JSON object of the last line it printed)."""
    out = io.StringIO()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("{")]
    check(bool(lines), f"{main.__module__} printed no JSON line")
    return result, counts, seconds, json.loads(lines[-1])


def phase_eval(torch, ef, card: str, work: str, train_urls: str,
               val_url: str, best: str):
    """The eval and deployment surfaces at full width on what
    phase_disk_train trained (its best checkpoint, its shards): zero-shot
    CheXpert (cli.eval_zs), retrieval and the linear probe over the UniMed
    shards, the trainer's test loop (cli.eval), two steps of classification
    fine-tuning (cli.train model=classification) and the encoders' export
    (cli.export) with a symbolic batch. Returns the K1 and K2 launches of
    these surfaces."""
    import numpy as np

    from medmoe_torch.cli import eval as eval_cli
    from medmoe_torch.cli import eval_zs
    from medmoe_torch.cli import export as export_cli
    from medmoe_torch.config import DotDict, compose
    from medmoe_torch.data.datamodules import CheXpertDataModule
    from medmoe_torch.eval import export as tex
    from medmoe_torch.eval import linear_probe as tlp
    from medmoe_torch.eval.zero_shot import (encode_class_prompts,
                                             load_for_eval,
                                             make_image_embedder)
    from medmoe_torch.train.classification import ClassificationModule

    total = {"K1": 0, "K2": 0}

    def add(counts):
        for k in total:
            total[k] += counts[k]

    common = [f"paths.root_dir={os.path.join(work, 'eval')}",
              "extras.print_config=false"]
    workers = f"data.num_workers={min(8, os.cpu_count() or 1)}"
    unimed = ["data=unimed", f"data.train_data_paths={train_urls}",
              f"data.val_data_paths={val_url}", "data.batch_size=32",
              workers, f"ckpt_path={best}"] + common

    # 1. zero-shot CheXpert through the eval CLI
    t0 = time.perf_counter()
    chex = write_chexpert(os.path.join(work, "chexpert"))
    print(f"eval: wrote a CheXpert tree of {CHEX_IMAGES} frontal JPEGs "
          f"(320 x 390) in {time.perf_counter() - t0:.1f} s", flush=True)
    zs_args = ["data=chexpert", f"data.data_dir={chex}",
               f"ckpt_path={best}"] + common
    metrics, counts, seconds, printed = run_cli(torch, eval_zs.main, zs_args)
    add(counts)
    names = CheXpertDataModule.COMPETITION_TASKS
    aucs = [metrics.get(f"zero_shot/auroc/{n}", math.nan) for n in names]
    check(printed == metrics, "eval_zs printed other metrics than it returned")
    check(all(0.0 <= a <= 1.0 for a in aucs), f"per-task AUROCs {aucs}")
    check(abs(metrics["zero_shot/auroc"] - float(np.mean(aucs))) < 1e-12,
          f"macro AUROC {metrics['zero_shot/auroc']} vs {np.mean(aucs)}")
    check(0.0 <= metrics["zero_shot/accuracy"] <= 1.0
          and metrics["zero_shot/n"] == CHEX_IMAGES, f"zero-shot {metrics}")
    check(counts["K1"] == -(-CHEX_IMAGES // CHEX_BATCH),
          f"zero-shot launched K1 {counts['K1']} times for "
          f"{-(-CHEX_IMAGES // CHEX_BATCH)} batches")
    # the same images through the embedder, timed warm, and through the
    # plain expert path (comparison launches: not counted)
    model, dm, tok = load_for_eval(compose("eval_zs", zs_args))
    embed = make_image_embedder(model)
    batches = [b["image"] for b in dm.test_dataloader()]
    class_emb = encode_class_prompts(model, tok, names,
                                     "this is a photo of {}", 25)
    embed(batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb = torch.cat([embed(b) for b in batches])
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    with plain_expert_path(ef):
        plain = torch.cat([embed(b) for b in batches])
    cos = (emb * plain).sum(-1).min().item()
    sim_err = (emb @ class_emb.T - plain @ class_emb.T).abs().max().item()
    check(cos > 0.999, f"zero-shot embeddings vs the plain expert path: "
          f"cosine {cos}")
    print(f"eval zero-shot: CheXpert AUROC {metrics['zero_shot/auroc']:.4f} "
          f"(tasks {', '.join(f'{a:.4f}' for a in aucs)}), accuracy "
          f"{metrics['zero_shot/accuracy']:.4f}; the CLI {seconds:.1f} s "
          f"(model init and JPEG decode included), K1 launches "
          f"{counts['K1']}; encode {CHEX_IMAGES / enc_s:.1f} img/s warm "
          f"({len(batches)} batches of {CHEX_BATCH}); vs the plain expert "
          f"path: min cosine {cos:.6f}, similarities max abs diff "
          f"{sim_err:.2e}; on {card}", flush=True)

    # 2. retrieval over the val shard
    metrics, counts, seconds, _ = run_cli(
        torch, eval_zs.main, unimed + ["eval.protocol=retrieval"])
    add(counts)
    for d in ("i2t", "t2i"):
        r = [metrics[f"retrieval/{d}_r@{k}"] for k in (1, 5, 10)]
        check(all(0.0 <= x <= 1.0 for x in r) and r == sorted(r),
              f"{d} recall {r}")
        check(1.0 <= metrics[f"retrieval/{d}_median_rank"] <= DISK_SHARD,
              f"{d} median rank {metrics[f'retrieval/{d}_median_rank']}")
    check(counts["K1"] == DISK_SHARD // 32, f"retrieval launched K1 "
          f"{counts['K1']} times")
    print(f"eval retrieval: {json.dumps(metrics)}; {seconds:.1f} s, K1 "
          f"launches {counts['K1']} on {card}", flush=True)

    # 3. the linear probe: the 6 train shards once each, the val shard
    metrics, counts, seconds, _ = run_cli(
        torch, eval_zs.main, unimed + ["eval.protocol=linear_probe",
                                       "data.resampled=false",
                                       "eval.linear_probe.epochs=50"])
    add(counts)
    accs = [metrics[f"linear_probe/acc@{p}%"] for p in (1, 10, 100)]
    check(all(0.0 <= a <= 1.0 for a in accs), f"probe accuracies {accs}")
    check(counts["K1"] == (6 * DISK_SHARD + DISK_SHARD) // 32,
          f"the probe launched K1 {counts['K1']} times")
    rng = np.random.RandomState(3)
    x = rng.randn(6 * DISK_SHARD, 768).astype(np.float32)
    y = rng.randint(0, 6, 6 * DISK_SHARD)
    tlp._train_head(x, y, 6, 1e-3, 50, False, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tlp._train_head(x, y, 6, 1e-3, 50, False, "cuda")
    torch.cuda.synchronize()
    head_ms = (time.perf_counter() - t0) * 1e3 / 50
    print(f"eval linear probe: accuracies at 1/10/100% {accs}; {seconds:.1f}"
          f" s for {6 * DISK_SHARD} + {DISK_SHARD} images and 3 heads, K1 "
          f"launches {counts['K1']}; a head step on {6 * DISK_SHARD} x 768 "
          f"features {head_ms:.3f} ms on {card}", flush=True)

    # 4. the trainer's test loop on the val shard (cli.eval)
    metrics, counts, seconds, _ = run_cli(
        torch, eval_cli.main, unimed + ["trainer.limit_test_batches=2"])
    add(counts)
    check(all(math.isfinite(v) for v in metrics.values())
          and "test/loss" in metrics, f"cli.eval metrics {metrics}")
    check(counts["K1"] == 2, f"cli.eval launched K1 {counts['K1']} times")
    print(f"eval test loop: {json.dumps(metrics)}; {seconds:.1f} s, K1 "
          f"launches {counts['K1']} on {card}", flush=True)

    # 5. two steps of classification fine-tuning (the modality label)
    overrides = [o for o in disk_overrides(train_urls, val_url, 1)
                 if not o.startswith(("callbacks=",
                                      "trainer.limit_train_batches=",
                                      "trainer.accumulate_grad_batches=",
                                      "trainer.limit_val_batches="))]
    cfg, metrics, objs, counts, routed, seconds, peak = drive_train(
        torch, overrides + [
            "model=classification", "model.freeze_encoder=false",
            "model.num_classes=6", "model.multilabel=false",
            "callbacks=none", "trainer.limit_train_batches=2",
            "trainer.accumulate_grad_batches=1",
            "trainer.limit_val_batches=0"], os.path.join(work, "cls"))
    add(counts)
    trainer, module = objs["trainer"], objs["module"]
    steps = trainer.state.step
    check(steps == 2 and math.isfinite(metrics["train/loss"]),
          f"classification: step {steps}, metrics {metrics}")
    check(counts["K1"] == counts["K2"] == 2,
          f"classification launches {counts} for 2 micro-batches")
    # against the same seeded init: the routed experts' rows and Swin moved
    # (weight decay 1e-6 moves the unrouted rows too)
    init_mod = ClassificationModule(vision=DotDict(cfg.model.model.vision),
                                    num_classes=6, freeze_encoder=False)
    init_mod.init_params(cfg.seed)
    init = init_mod.model.state_dict()
    now = {k: v.detach().cpu() for k, v in module.model.state_dict().items()}
    experts = sorted(set(torch.cat(routed).flatten().tolist()))
    bank = "encoder.swin_moe.moe.experts.proj_w0"
    moved = [e for e in range(now[bank].shape[0])
             if not torch.equal(now[bank][e], init[bank][e])]
    check(set(experts) <= set(moved), f"classification: routed experts "
          f"{experts}, moved bank rows {moved}")
    for k in ("encoder.swin_moe.swin.patch_embed.proj.weight",
              "encoder.swin_moe.swin.stage3_block1.mlp.fc2.weight",
              "head.classifier.weight"):
        check(not torch.equal(now[k], init[k]), f"classification: {k} "
              f"did not move")
    batch = trainer.to_device(next(iter(
        objs["datamodule"].train_dataloader(1))))
    step_ms = warm_step_ms(torch, trainer, module, batch)
    print(f"eval classification fine-tuning: {steps} steps in "
          f"{seconds:.1f} s (init included), loss {metrics['train/loss']:.4f}"
          f", acc {metrics['train/acc']:.4f}; launches {counts}; routed "
          f"experts {experts}, bank rows {moved} moved, Swin moved; warm "
          f"step of 32 {step_ms:.1f} ms; peak memory {peak:.2f} GB on {card}",
          flush=True)
    del objs, trainer, module, batch
    torch.cuda.empty_cache()

    # 6. export with a symbolic batch; the image program on the card
    out = os.path.join(work, "export")
    manifest, counts, seconds, printed = run_cli(
        torch, export_cli.main, unimed + ["export.platforms=[cuda]",
                                          f"export.dir={out}"])
    add(counts)
    check(manifest["platforms"] == ["cuda"] and manifest["image"]["input"]
          == "float32[b,224,224,3]", f"manifest {manifest}")
    check(counts["K1"] == 2, f"export (its round trip: the live module and "
          f"the program) launched K1 {counts['K1']} times")
    image = tex.call_exported(out, "image", "cuda")
    x = torch.from_numpy(batches[0][:32]).cuda()
    for b in (1, 32):
        before = ef.LAUNCHES
        got = image(x[:b])
        torch.cuda.synchronize()
        total["K1"] += ef.LAUNCHES - before
        check(ef.LAUNCHES == before + 1, f"the image program at b={b} "
              f"launched K1 {ef.LAUNCHES - before} times")
        err = (got.norm(dim=-1) - 1).abs().max().item()
        check(got.shape == (b, 768) and err < 1e-3,
              f"the image program at b={b}: {tuple(got.shape)}, |norm-1| "
              f"{err}")
    cos = (got * embed(x)).sum(-1).min().item()
    check(cos > 0.999, f"the image program vs the live embedder: cosine "
          f"{cos}")
    sizes = ", ".join(f"{k} {v / 1e6:.1f} MB"
                      for k, v in printed["bytes"].items())
    print(f"eval export: {seconds:.1f} s (model init, two torch.export "
          f"traces, saves and the round trip included); {sizes}; round "
          f"trip max abs err {manifest['roundtrip_max_abs_err']['cuda']} "
          f"(bound {tex.ROUNDTRIP_ATOL}); the image "
          f"program at b=1 and 32 launches K1 once each, min cosine "
          f"against the live embedder {cos:.6f}, on {card}", flush=True)
    del model, embed, image
    torch.cuda.empty_cache()
    return total


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "medmoe_torch")):
        fail("medmoe_torch/ not found beside this script: run it from a "
             "checkout of the repository")
    sys.path.insert(0, here)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = (smi.stdout.strip().splitlines() or ["nvidia-smi: no output"])[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}; PyYAML "
          f"{'present' if importlib.util.find_spec('yaml') else 'absent'}, "
          f"PIL {'present' if importlib.util.find_spec('PIL') else 'absent'}",
          flush=True)
    # f32 products in the plain versions stay f32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from medmoe_torch.ops import _build, expert_fusion as ef
    from medmoe_torch.ops import gloria_attention as ga

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs)}",
          flush=True)
    for name, (sec, log) in logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line or "error" in line:
                print(f"build {name}: {line.strip()}", flush=True)

    k1 = phase_k1(torch, ef)
    serve_launches, img_s = phase_serve(torch, ef, card, *full_width_config())
    k2 = phase_k2(torch, ef)
    k1_train, k2_train, pairs_s = phase_train(torch, ef, card)
    gl = phase_gloria(torch, ga, card)
    phase_gloria_wide(torch, ga, card)
    g256 = phase_gloria_train(torch, card)
    text = phase_text_train(torch, card)
    work = tempfile.mkdtemp(prefix="medmoe_disk_")
    try:
        disk, trained = phase_disk_train(torch, card, work)
        ev = phase_eval(torch, ef, card, work, *trained)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"main paths: serving {img_s:.1f} img/s with K1 launched "
          f"{serve_launches} times; pretraining_medmoe_ddp training "
          f"{pairs_s:.1f} pairs/s with K1 launched {k1_train} and K2 "
          f"{k2_train} times; gloria256 launches {g256}; text training "
          f"launches {text}; disk train, resume and serve launches {disk}; "
          f"eval, classification and export launches {ev}", flush=True)
    # K1 and K2 run in every phase that drives the model
    k1_all = serve_launches + k1_train + g256["K1"] + text["K1"] \
        + disk["K1"] + ev["K1"]
    k2_all = k2_train + g256["K2"] + text["K2"] + disk["K2"] + ev["K2"]

    def row(name, source, replaces, launches, r, **extra):
        extra.update({k: r[k] for k in ("k4a_only_ms", "both_ms", "prologue_ms",
                                        "prologue_bound_ms", "ms_b256",
                                        "bound_ms_b256") if k in r})
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None, **extra}

    gsrc = "medmoe_torch/csrc/gloria_attention"
    gtpu = "medmoe_tpu/ops/pallas/gloria_attention.py"
    print(json.dumps({"kernels": [
        row("expert_fusion_gather", "medmoe_torch/csrc/expert_fusion.cu",
            "medmoe_tpu/ops/pallas/expert_fusion.py:113", k1_all, k1,
            functions=list(K1_KERNELS)),
        row("expert_fusion_gather_bwd",
            "medmoe_torch/csrc/expert_fusion_bwd.cu",
            "medmoe_tpu/ops/pallas/expert_fusion.py:233", k2_all, k2),
        row("gloria_similarity_forward", f"{gsrc}.cu", f"{gtpu}:73",
            g256["K3"], gl["K3"],
            functions=[k.split()[-1] for k in K3_KERNELS]),
        row("gloria_similarity_backward d_ctx", f"{gsrc}_bwd.cu",
            f"{gtpu}:242", g256["K4a"], gl["K4a"],
            prologue_launches=g256["prologue"]),
        row("gloria_similarity_backward d_words", f"{gsrc}_bwd.cu",
            f"{gtpu}:274", text["K4b"], gl["K4b"],
            functions=["dwords_gemm_kernel", "dwords_wei_kernel"],
            prologue_launches=text["prologue"])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
