#!/usr/bin/env python3
"""Drive the PyTorch port (medmoe_torch) on one NVIDIA card, end to end.

    python3 chip_smoke.py            # from the root of a checkout

  1. prints the card's name and power limit (nvidia-smi) and whether
     PyYAML and PIL are installed (this script needs neither);
  2. builds every CUDA kernel from medmoe_torch/csrc, one nvcc each, all
     started together, and prints the build time and each kernel's ptxas
     registers and spills; checks in cuobjdump's SASS that the kernels on
     the wgmma core (K3's and the prologue's F1/F2, K4a's two passes, K1's
     projection and logit product, K2's projection and five products) run
     wgmma (HGMMA) fed by TMA (UTMALDG) and no mma.sync (HMMA);
  3. K1, the fused expert branch: holds the kernel against its plain
     PyTorch version on the card at B=32 flagship shapes (bf16, every
     expert used) and on small odd shapes, times both with CUDA events,
     prints each of its passes' device time (and the product passes'
     TFLOP/s) at B=32 and B=256 from one torch.profiler call each, beside
     a cuBLAS yardstick of one chunk's projection (torch.baddbmm over the
     gathered Wp with bias and ReLU, timed only), and times it at B=256
     flagship (the gloria256 step's shape), held against its plain version
     on two slices of 32 samples, one across a chunk boundary;
  4. serving: the full-width MedMoE (Swin-T + 6-expert gather MoE +
     BERT-base, bf16, seeded random weights) encodes the CheXpert class
     prompts and serves waves of 32 synthetic uint8 images through the
     serve CLI's wave loop; checks the records, that the kernel ran once
     per wave, and that the embeddings match the plain expert path;
  5. K2, the fused expert branch's backward: holds the kernel against its
     plain version at B=32 flagship shapes and on small odd shapes, times
     both, prints each of its passes' device time (and the product passes'
     TFLOP/s) at B=32 and B=256 from one torch.profiler call each, with
     the projection's yardstick, times it at B=256 flagship (the gloria256
     step's shape), holds the u that K1's projection writes bit for bit
     against the u K2's u pass writes, and holds FusedExpertGather's
     gradients against autograd through the plain forward;
  6. training: the train CLI's ``train`` on experiment=pretraining_medmoe_ddp
     with synthetic data at full width, 8 micro-batches of 32 in 2
     optimizer steps (accumulation cut from 80 to 4 to fit the run's time);
     checks the loss and grad norm, that K2 ran once per micro-batch and K1
     at least once per micro-batch, that the routed experts' rows and the
     Swin tower moved, and that the frozen BERT did not, and that the B=32
     losses took the einsum path (no GLoRIA kernel);
  7. K3, K4a and K4b, the GLoRIA similarity and its backward, as training
     runs them (K3 keeping its f32 state, the prologue running F3 from
     it): hold the kernels against their plain versions, K3's sim against
     it without the store and the backward against the one that
     recomputes F1 and F2 (bit for bit), at B=256 flagship shapes (bf16
     ctx in the local map's own layout, caption lengths from a seed in
     [3, 25], a seeded cotangent; both cotangents from one call, the text
     training's path) and on small odd shapes (captions of 40 words; M =
     132 with 5 captions of 9 words, ragged tiles), time both ways (K3
     with and without its store in alternating rounds, the
     backward's prologue alone, K4a alone with each of its two passes'
     device time and TFLOP/s on padded captions, the prologue + K4a, and the
     prologue + K4a + K4b, whose difference from the prologue + K4a is K4b
     alone, with the device time of each K4b pass, its product's TFLOP/s
     on padded captions and a torch.matmul of one chunk's product as a
     yardstick), print the bounds, the backward's scratch and the image chunk,
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
 12. K3, the prologue + K4a and both cotangents (K4b) at the rectangular
     shape each rank of a two-rank gloria256 launches, 128 images
     against 256 captions, held against their plain versions and timed
     beside their bounds, from K3's kept state and recomputing, K4b's
     passes and yardstick as in 7;
 13. the MoE modes: the expert branch at experiment=moe_single_modality's
     shape (4 experts, top-2, B=64, bf16, full width) in gather mode (K1
     twice a forward, K2 twice a backward) against topk (capacity factor
     2: nothing drops) and dense, outputs and gradients; then 2 optimizer
     steps of moe_single_modality as shipped (topk, capacity 1.5;
     accumulation cut from 10 to 2) and 1 of zero_shot_dense (no MoE);
 14. data-parallel training: one gloria256 step of 256 in one process
     (drop rates 0), then the same global batch as two gloo ranks of 128
     on the one card (this script with --ddp-rank, two processes on
     cuda:0, each one node of one card, through the train CLI's main),
     held against it (loss, grad_norm, the update), K3 once at 128 x 256
     on each rank; then one step through a one-rank NCCL group that the
     port's maybe_initialize opens; each with its warm step and peak
     memory;
 15. expert-parallel training: experiment=ep_full_mix as two gloo ranks
     of one expert group (data 1 x expert 2) in moe_mode=ep and gather,
     each against one process, and the checkpoint they saved;
 16. soft-label and hard-negative pretraining: 2 gloria256 steps of 256
     with BERT training and the soft global and local losses (K1, K2, K3,
     the prologue, K4a and K4b), the thresholds set between the first
     batch's distinct tool scores and the partition printed; the same
     first step through the einsum local loss, held against it; one
     gloria256 step with hard negatives as the global loss; one
     pretraining_medmoe_ddp step with soft labels (accumulation cut from 80
     to 2, the einsum soft local at B=32);
 17. the CNN towers and FLAVA (no hand-written kernel: K1–K4b's counters
     stay at 0): 2 steps of model=classification with resnet_50 + LoRA
     (norm=group, f32, uint8 224² images resized to 299² by the tower,
     batch 32; every lora_b left zero, the base kernels and the head
     moved), a resnet_50 forward on the card against the CPU on the
     trained weights (TF32 off), 1 linear-probe step (the encoder
     bit-unchanged), 1 step each of densenet_121 and resnext_50, and
     FLAVAPretrainingLoss at FLAVA's widths (hidden 768, vocabularies 30522
     and 8192, batch 32, 128 text tokens 15% masked, 196 patches masked by
     ImageMaskingGenerator((14, 14), 75)) behind a 6 × 768 multimodal
     encoder, forward and backward on the card against the CPU; each with
     its warm step, rate and peak memory;
 18. the CLI and host surface at full width: --help of the five CLIs
     through their console-script adapters; hparams_search=medmoe_tpe over
     experiment=pretraining_medmoe (its own composition: batches of the
     drawn size with global negatives), 2 trials of the shipped search
     space in this process (seed 1234's draws printed; each cut to
     accumulation 2, 2 train batches, 1 val batch) and 1 trial in a
     subprocess whose metrics come back through MEDMOE_METRICS_OUT;
     --multirun model.loss.temp3=5,10 (2 jobs of 1 step); debug=profiler
     (3 train batches of 256) with logger=many_loggers plus wandb
     (log_model) and mlflow: the Chrome trace names K1's and K2's
     kernels, the checkpoint saves ran blocking, metrics.csv and the JSONL
     files exist, and a warm step is timed with and without the profiler;
     then the C++ decode helper: the Unimed loader alone, PIL against
     native on the same shards, and 2 steps of pretraining_medmoe_ddp with
     data.use_native=true (or, without libjpeg's headers, that
     use_native=true raises);
 19. prints {"kernels": [...]}, with each kernel's launches counted over
     every phase that drives the model (serving, both trainings, text
     training, training from disk and its serving, eval and export, the
     MoE-mode trainings, the data- and expert-parallel steps, the
     soft-label runs and the CLI runs of this process), and, last, the
     device line.

Any failed check exits non-zero. Needs one CUDA card; fails without one.
``--profile`` adds torch.profiler breakdowns of one serving wave, one
B=32 training step and one gloria256 step; ``--only
gloria,gloria_wide,gloria_rect,moe_modes,ddp,ep,soft,cnn,cli`` runs just
those phases (no kernels line).
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
            passes = profile_passes(
                torch, lambda: ef.expert_fusion_gather(*args), f"K1 {name}",
                K1_KERNELS, pass_flops(args, K1_KERNELS))
            result.update(
                fwd_proj_kernel_ms=passes["fwd_proj_kernel"],
                proj_yardstick_ms=proj_yardstick(
                    torch, args, f"K1 {name}", "fwd_proj_kernel",
                    passes["fwd_proj_kernel"]))
        del args, out, ref
        torch.cuda.empty_cache()
    result.update(time_k1(torch, ef, GLORIA_BATCH))
    return result


def proj_yardstick(torch, args, label: str, name: str,
                   pass_ms: float) -> float:
    """The projection's yardstick: one torch.baddbmm (cuBLAS) a scale over
    the batch of ``args`` (one chunk), bias + x_s·Wp[idx] in bf16 then
    ReLU, on Wp and bp gathered per sample beforehand, timed with CUDA
    events beside the kernel pass ``name`` (``pass_ms`` device ms). Printed
    only: the port never calls it. Returns its ms."""
    xs, wp, bp, w1, b1, w2, b2, idx = args
    ix = idx.long()
    ws = [w[ix].to(torch.bfloat16) for w in wp]
    bs = [v[ix].to(torch.bfloat16)[:, None, :] for v in bp]

    def run():
        for x, w, v in zip(xs, ws, bs):
            torch.relu_(torch.baddbmm(v, x, w))

    ms = cuda_ms(run, iters=10)
    flops = sum(2 * x.shape[0] * x.shape[1] * x.shape[2] * w.shape[2]
                for x, w in zip(xs, ws))
    print(f"{label}: yardstick torch.baddbmm + relu of the projection "
          f"({len(xs)} scales, {idx.shape[0]} images, Wp gathered) "
          f"{ms:.3f} ms ({flops / max(ms, 1e-9) / 1e9:.1f} TFLOP/s), against "
          f"{name} {pass_ms:.3f} ms", flush=True)
    del ws, bs
    return ms


def k1_u_is_k2_u(torch, ef, args, d_out) -> None:
    """The u that K1's projection writes (h_0 at the identity scale)
    against the u that K2's u pass writes from its own projection's h (h_0
    at the identity scale), bit for bit: the scratch both wrappers
    allocate for one chunk, kept. Fails the run on a difference."""
    xs, wp, bp, w1, b1, w2, b2, idx = args
    kept = {}
    fwd, bwd = ef._fwd_buffers, ef._bwd_buffers
    ef._fwd_buffers = lambda *a: kept.setdefault("fwd", fwd(*a))
    ef._bwd_buffers = lambda *a: kept.setdefault("bwd", bwd(*a))
    try:
        ef.expert_fusion_gather(*args)
        ef.expert_fusion_gather_bwd(xs, wp, bp, w1, b1, w2, idx, d_out)
        torch.cuda.synchronize()
    finally:
        ef._fwd_buffers, ef._bwd_buffers = fwd, bwd
    p, b = max(x.shape[1] for x in xs), idx.shape[0]
    k2 = [h if x.shape[1] == p else u for x, h, u in
          zip(xs, kept["bwd"]["h"], kept["bwd"]["u"])]
    same = [torch.equal(u1[:b], u2[:b]) for u1, u2 in zip(kept["fwd"][0], k2)]
    print(f"K1 u (its projection's epilogue) vs K2 u (its u pass), B={b} "
          f"flagship, per scale: {['equal' if x else 'DIFFER' for x in same]}",
          flush=True)
    check(all(same), "K1's u is not K2's u bit for bit")


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
    profile_passes(torch, lambda: ef.expert_fusion_gather(*args),
                   f"K1 flagship B={b}", K1_KERNELS,
                   pass_flops(args, K1_KERNELS))
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
    reset_launch_counts()
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
        profile_wave(torch, embed, images[:WAVE])
    return launches, img_s


def profile_wave(torch, embed, images):
    """torch.profiler over one serving wave: device time by kernel and
    the expert-fusion kernels' share of it."""
    profile_device(torch, lambda: embed(images).cpu(), "one wave")


K1_KERNELS = ("fwd_proj_kernel", "fwd_logit_kernel", "fwd_combine_kernel")


def pass_flops(args, kernels) -> dict:
    """Operations of one call's product passes among ``kernels``: the
    projection (K1's, and K2's recompute of it), the logit product u·W1
    (K1's and K2's), K2's d_u product, its d_x product and its weight
    gradients (dW1 and every dWp)."""
    xs, wp, bp, w1, b1, w2, b2, idx = args
    b = idx.shape[0]
    _, e, h = w1.shape
    p = max(x.shape[1] for x in xs)
    mlp = len(xs) * 2 * b * p * e * h
    proj = sum(2 * b * x.shape[1] * x.shape[2] * e for x in xs)
    ops = {"fwd_proj_kernel": proj, "bwd_proj_kernel": proj,
           "fwd_logit_kernel": mlp,
           "bwd_act_kernel": mlp, "bwd_du_kernel": mlp,
           "bwd_dx_kernel": proj, "bwd_wgrad_kernel": mlp + proj}
    return {k: v for k, v in ops.items() if k in kernels}


K2_KERNELS = ("bwd_proj_kernel", "bwd_u_kernel", "bwd_act_kernel",
              "bwd_row_kernel",
              "bwd_du_kernel", "bwd_tlerp_kernel", "bwd_dx_kernel",
              "bwd_wgrad_kernel", "bwd_reduce_kernel")
K3_KERNELS = ("void sim_e_kernel", "void sim_wei_kernel",
              "void sim_finish_kernel")
K4A_KERNELS = ("void dctx_z_kernel", "dctx_gemm_kernel")
K4B_KERNELS = ("dwords_wei_kernel", "dwords_gemm_kernel", "dwords_sum_kernel")
GLORIA_KERNELS = K3_KERNELS + K4A_KERNELS + K4B_KERNELS


def dev_us(e) -> float:
    """A profiler event's own device time, in microseconds."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def profile_device(torch, fn, label: str):
    """torch.profiler over one call of ``fn``: device time by kernel and
    the expert-fusion kernels' share of it (K1: the forward's three passes;
    K2: the backward's nine, its projection recompute the first). The
    device's idle share is the benchmark's (``benchmark/trace.py``: the
    union of device intervals over the traced window)."""
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
    dev_ms = sum(dev_us(e) for e in rows) / 1e3
    k1_ms = sum(dev_us(e) for e in rows if e.key.startswith(K1_KERNELS)) / 1e3
    k2_ms = sum(dev_us(e) for e in rows if e.key.startswith(K2_KERNELS)) / 1e3
    gl_ms = sum(dev_us(e) for e in rows
                if e.key.startswith(GLORIA_KERNELS)) / 1e3
    share = max(dev_ms, 1e-9)
    print(f"profile: {label}: device time {dev_ms:.3f} ms summed over "
          f"kernels; K1 kernels {k1_ms:.3f} ms ({k1_ms / share:.1%} of "
          f"device time), K2 kernels {k2_ms:.3f} ms ({k2_ms / share:.1%}), "
          f"GLoRIA kernels {gl_ms:.3f} ms ({gl_ms / share:.1%})", flush=True)
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
                  f"time includes its projection recompute)", flush=True)
            passes = profile_passes(
                torch, lambda: ef.expert_fusion_gather_bwd(
                    xs, wp, bp, w1, b1, w2, idx, d_out), f"K2 {name}",
                K2_KERNELS, pass_flops(args, K2_KERNELS))
            result.update(
                bwd_proj_kernel_ms=passes["bwd_proj_kernel"],
                proj_yardstick_ms=proj_yardstick(
                    torch, args, f"K2 {name}", "bwd_proj_kernel",
                    passes["bwd_proj_kernel"]))
        del args, out, ref
        torch.cuda.empty_cache()
    result.update(time_k2(torch, ef, GLORIA_BATCH))
    args = k1_inputs(torch, b=3, p_list=(3136, 784, 196, 49),
                     d_list=(96, 192, 384, 768), e=768, h=384, k=6, seed=18)
    k1_u_is_k2_u(torch, ef, args, torch.randn(
        (3, 3136, 768), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(19)))
    del args

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


def profile_passes(torch, fn, label: str, kernels, flops=None,
                   prep=None) -> dict:
    """Device time of each of ``kernels`` (name prefixes) over one call of
    ``fn`` (torch.profiler): K1's passes, K2's, K3's or the prologue's
    three, or K4a's two; with
    ``flops`` ({prefix: operations of one call}) each pass's TFLOP/s too.
    With ``prep``, each call is ``fn(prep())`` and ``prep`` runs outside
    the profile. The profile opens with 20 ms or so of bf16 products that
    no list names, waited for, before the call: without them the first
    kernels of a short call were at times missing from a profile on the
    H100 (a 5 ms prologue read 0 ms). Returns {prefix: ms}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def args():
        out = () if prep is None else (prep(),)
        torch.cuda.synchronize()
        return out

    fn(*args())
    torch.cuda.synchronize()
    a = args()
    x = torch.ones((8192, 8192), dtype=torch.bfloat16, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(16):
            torch.matmul(x, x)
        torch.cuda.synchronize()
        fn(*a)
        torch.cuda.synchronize()
    del a, x
    ms = dict.fromkeys(kernels, 0.0)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for k in ms:
                if e.key.startswith(k):
                    ms[k] += dev_us(e) / 1e3
    print(f"{label} passes (device ms of one call): "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + f"; total {sum(ms.values()):.3f}", flush=True)
    for k, ops in (flops or {}).items():
        print(f"{label} pass {k.split()[-1]}: {ms[k]:.3f} ms, "
              f"{ops / max(ms[k], 1e-9) / 1e9:.1f} TFLOP/s on "
              f"{ops / 1e12:.2f} TFLOP", flush=True)
    return ms


def time_k2(torch, ef, b: int):
    """K2 (with its projection recompute) at flagship shapes and batch
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
    profile_passes(torch, lambda: ef.expert_fusion_gather_bwd(
        xs, wp, bp, w1, b1, w2, idx, d_out), f"K2 flagship B={b}", K2_KERNELS,
        pass_flops(args, K2_KERNELS))
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
    """Every counter of the port's registry to 0, the launch counters
    among them (``medmoe_torch/utils/trace.py``)."""
    from medmoe_torch.utils import trace

    trace.reset()


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
    profile_device(torch, lambda: step(trainer.state, [batch]),
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


def kept_state(ga, img, words, cap, temps):
    """K3 keeping its state, as the training path runs it when a gradient
    will be taken; returns the filled ``ga.KeptState``."""
    state = ga.KeptState()
    ga.gloria_similarity_forward(img, words, cap, *temps, kept=state)
    return state


def gloria_check(torch, ga, img, words, cap, cot, temps, name: str):
    """The training path's K3 (keeping its state) and backward (from that
    state) against the plain versions, with K3's sim equal to it without
    the store and the backward equal to the one that recomputes F1 and
    F2, bit for bit. Returns (K3, K4a, K4b) max abs errors."""
    state = ga.KeptState()
    out = ga.gloria_similarity_forward(img, words, cap, *temps, kept=state)
    bare = ga.gloria_similarity_forward(img, words, cap, *temps)
    torch.cuda.synchronize()
    check(state.tensors is not None, f"K3 {name}: kept no state")
    check(torch.equal(out, bare), f"K3 {name}: sim with the store differs "
          "from sim without it")
    ref = ga.gloria_similarity_reference(img, words, cap, *temps)
    err3 = gloria_err(torch, out, ref, f"K3 {name}", "fwd")
    del out, bare, ref
    d_img, d_words = ga.gloria_similarity_backward(img, words, cap, cot,
                                                   *temps, kept=state)
    check(state.tensors is None, f"K4 {name}: the prologue kept the state")
    again = ga.gloria_similarity_backward(img, words, cap, cot, *temps)
    torch.cuda.synchronize()
    same = torch.equal(d_img, again[0]) and torch.equal(d_words, again[1])
    print(f"K4 {name}: the backward from K3's kept state against the one "
          f"that recomputes: {'same bits' if same else 'DIFFERENT BITS'}",
          flush=True)
    check(same, f"K4 {name}: the kept and the recomputing backward differ")
    del again
    r_img, r_words = ga.gloria_similarity_bwd_reference(img, words, cap, cot,
                                                        *temps)
    err4a = gloria_err(torch, d_img, r_img, f"K4a {name} d_img", "bwd")
    err4b = gloria_err(torch, d_words, r_words, f"K4b {name} d_words", "bwd")
    del d_img, d_words, r_img, r_words
    torch.cuda.empty_cache()
    return err3, err4a, err4b


NEEDS = ((False, False), (True, False), (True, True))


def backward_ms(torch, ga, img, words, cap, cot, temps, iters: int = 3):
    """The backward's prologue alone, the prologue + K4a and the backward
    of both cotangents (need_img and need_words of each of ``NEEDS``),
    from K3's kept state as training runs them and recomputing F1 and F2:
    each call after a K3 of its own (with its store or without), timed
    with CUDA events around the backward, the two ways alternating, over
    ``iters`` calls after a warm one. Returns {"kept": [ms of the three],
    "recomputed": [ms of the three]}."""
    ms = {"kept": [0.0] * len(NEEDS), "recomputed": [0.0] * len(NEEDS)}
    for k in range(iters + 1):
        for i, (need_img, need_words) in enumerate(NEEDS):
            for way, row in ms.items():
                state = ga.KeptState() if way == "kept" else None
                ga.gloria_similarity_forward(img, words, cap, *temps,
                                             kept=state)
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                ga.gloria_similarity_backward(
                    img, words, cap, cot, *temps, need_img=need_img,
                    need_words=need_words, kept=state)
                ev[1].record()
                torch.cuda.synchronize()
                if k:
                    row[i] += ev[0].elapsed_time(ev[1]) / iters
    return ms


def k3_store_ms(torch, ga, img, words, cap, temps, name: str, card: str,
                rounds: int = 7, iters: int = 5) -> dict:
    """K3 with its store and without, in ``rounds`` alternating rounds of
    ``iters`` calls each, timed with CUDA events; prints the median and
    the range of each and the store's cost (the difference of the
    medians). Returns {"kept": median ms, "recomputed": median ms}."""
    import statistics

    calls = {"kept": lambda: ga.gloria_similarity_forward(
                 img, words, cap, *temps, kept=ga.KeptState()),
             "recomputed": lambda: ga.gloria_similarity_forward(
                 img, words, cap, *temps)}
    ms = {k: [] for k in calls}
    for fn in calls.values():
        fn()
    for _ in range(rounds):
        for k, fn in calls.items():
            ms[k].append(cuda_ms(fn, iters=iters, warmup=0))
    med = {k: statistics.median(v) for k, v in ms.items()}
    print(f"K3 {name}: with its store {med['kept']:.4f} ms (range "
          f"{min(ms['kept']):.4f}-{max(ms['kept']):.4f}), without "
          f"{med['recomputed']:.4f} ms (range {min(ms['recomputed']):.4f}-"
          f"{max(ms['recomputed']):.4f}), {rounds} alternating rounds of "
          f"{iters} calls; the store {med['kept'] - med['recomputed']:.4f} ms "
          f"on {card}", flush=True)
    return med


def k4b_passes(torch, ga, img, words, cap, cot, temps, name: str,
               alone_ms: float, card: str) -> dict:
    """K4b's passes over one backward of the words' cotangent alone, from
    K3's kept state as training runs it (torch.profiler): the prologue's
    f32 terms (``dwords_wei_kernel``), the
    product (``dwords_gemm_kernel``, with its TFLOP/s on padded captions,
    2·B_img·M·D·B_txt·TPAD) and the slices' sum (``dwords_sum_kernel``),
    beside K4b alone timed as a difference (``alone_ms``); then the
    product's yardstick: one torch.matmul (cuBLAS) of the last chunk's
    product, ctx_chunkᵀ against a contiguous copy of that chunk's Zds,
    which pass 1 writes through the C entry into a Z of this function's
    own, times the chunks. Printed only: the port never calls it. Returns
    {key: ms} for the kernels line."""
    from medmoe_torch.ops import _build

    b_img, d, h, w = img.shape
    b_txt, t, m = words.shape[0], words.shape[2], h * w
    tp = ga._tpad(t)
    flops = 2 * b_img * m * d * b_txt * tp
    passes = profile_passes(
        torch, lambda state: ga.gloria_similarity_backward(
            img, words, cap, cot, *temps, need_img=False, kept=state),
        f"K4b {name}", K4B_KERNELS, flops={"dwords_gemm_kernel": flops},
        prep=lambda: kept_state(ga, img, words, cap, temps))
    print(f"K4b {name}: passes {sum(passes.values()):.3f} ms of device time "
          f"against K4b alone {alone_ms:.4f} ms (the both-cotangent time less "
          f"the prologue + K4a's) on {card}", flush=True)
    pairs = ga.pair_cotangents(img, words, cap, cot, *temps,
                               kept=kept_state(ga, img, words, cap, temps))
    chunk, _ = ga.image_chunk(b_img, b_txt, m, t)
    z = torch.empty((chunk, m, b_txt * 2 * tp), dtype=torch.bfloat16,
                    device="cuda")
    d_ctx = torch.empty((b_img, m, d), dtype=torch.float32, device="cuda")
    lib = _build.load("gloria_attention_bwd")
    rc = lib.medmoe_gloria_cotangents(
        *pairs.args(), pairs.dwei.data_ptr(), pairs.vecs.data_ptr(),
        z.data_ptr(), chunk, d_ctx.data_ptr(), None, 0, None, None, None,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    check(rc == 0, f"K4b yardstick: pass 1 returned {rc}")
    b0 = (b_img - 1) // chunk * chunk
    nb = b_img - b0
    zds = z[:nb].reshape(nb * m, b_txt, 2, tp)[:, :, 1].reshape(
        nb * m, b_txt * tp).contiguous()
    a = pairs.ctx[b0:].reshape(nb * m, d)
    del pairs, z, d_ctx
    mm = cuda_ms(lambda: torch.matmul(a.T, zds), iters=3, warmup=1)
    mm_flops = 2 * nb * m * d * b_txt * tp
    chunks = -(-b_img // chunk)
    print(f"K4b {name}: yardstick torch.matmul of one chunk's product "
          f"[{d}, {nb * m}] x [{nb * m}, {b_txt * tp}] bf16 {mm:.3f} ms "
          f"({mm_flops / max(mm, 1e-9) / 1e9:.1f} TFLOP/s), x {chunks} "
          f"chunks {mm * chunks:.3f} ms, against dwords_gemm_kernel "
          f"{passes['dwords_gemm_kernel']:.3f} ms on {card}", flush=True)
    del a, zds
    torch.cuda.empty_cache()
    return dict(**{f"{k}_ms": v for k, v in passes.items()},
                matmul_yardstick_ms=mm * chunks)


def phase_gloria(torch, ga, card: str, words: int = 25):
    """K3, K4a and K4b as training runs them (K3 keeping its state, the
    backward from it) against their plain versions, and against K3 without
    its store and the backward that recomputes, at B=256 flagship shapes
    (captions of ``words`` words) and on small odd shapes; times of each
    both ways and of the plain versions, with the device time and TFLOP/s
    of each pass of K3, the prologue and K4a; K3+K4a against the einsum
    path at B=32."""
    temps = (4.0, 5.0, 10.0)
    results = {}
    cases = [
        (f"flagship B=256 T={words}",
         (GLORIA_BATCH, GLORIA_BATCH, 768, 56, 56, words)),
        ("odd 3x5 D=48 7x5 T=9", (3, 5, 48, 7, 5, 9)),
        ("odd 4x3 D=80 9x9 T=32", (4, 3, 80, 9, 9, 32)),
        ("odd 3x5 D=48 7x5 T=40", (3, 5, 48, 7, 5, 40)),
        ("odd 3x5 D=48 12x11 T=9", (3, 5, 48, 12, 11, 9)),
        ("odd 2x3 D=80 7x7 T=96", (2, 3, 80, 7, 7, 96)),
    ]
    for name, shape in cases:
        img, words, cap, cot = gloria_inputs(torch, *shape, seed=21)
        b_img, b_txt, d = shape[0], shape[1], shape[2]
        err3, err4a, err4b = gloria_check(torch, ga, img, words, cap, cot,
                                          temps, name)
        if results:
            continue
        h, w, t = shape[3:]
        scratch = ga.backward_scratch_bytes(b_img, b_txt, h * w, d, t)
        chunk, z_bytes = ga.image_chunk(b_img, b_txt, h * w, t)
        kept = ga.kept_bytes(b_img, b_txt, h * w, d, t)
        keeps = ga.keeps_state(b_img, b_txt, h * w, d, t, torch.cuda.
                               get_device_properties(0).total_memory)
        print(f"K4 {name}: backward scratch {scratch / 1e9:.3f} GB (bf16 "
              f"d_wei and per-word vectors per pair, K4b's f32 accumulators, "
              f"the prologue's passes over a chunk when it recomputes); E "
              f"[hi | lo of e] and Z [a2 | d_scores] {z_bytes / 1e9:.3f} GB "
              f"for a chunk of {chunk} images; K3's kept state "
              f"{kept / 1e9:.3f} GB, kept on this card: {keeps}", flush=True)

        def fwd():
            ga.gloria_similarity_forward(img, words, cap, *temps)

        def bwd(need_img, need_words, plain=False):
            fn = ga.gloria_similarity_bwd_reference if plain \
                else ga.gloria_similarity_backward
            return lambda: fn(img, words, cap, cot, *temps,
                              need_img=need_img, need_words=need_words)

        def prep():
            return kept_state(ga, img, words, cap, temps)

        # the training path: K3 keeping its state, the prologue (F3 alone)
        # from it, then K4a and K4b; the recomputing path (K3 without its
        # store, the prologue running F1 and F2 again) as a second line
        store = k3_store_ms(torch, ga, img, words, cap, temps, name, card)
        ms3, re3 = store["kept"], store["recomputed"]
        times = backward_ms(torch, ga, img, words, cap, cot, temps)
        ms_pro, ms4a, ms_both = times["kept"]
        re_pro, re4a, re_both = times["recomputed"]
        plain3 = cuda_ms(lambda: ga.gloria_similarity_reference(
            img, words, cap, *temps), iters=1, warmup=0)
        # F1 is a product of 2·B_img·M·D·B_txt·TPAD operations on padded
        # captions, F2 twice that (e's bf16 hi and lo); K3's passes with
        # its store and without, then the prologue's from the kept state
        # (F3 alone) and recomputing (F1 and F2 again, f32 wei and the
        # d_wei loop of F3)
        f1 = 2 * b_img * h * w * d * b_txt * ga._tpad(t)
        k3_flops = {K3_KERNELS[0]: f1, K3_KERNELS[1]: 2 * f1}
        k3_passes = profile_passes(torch, lambda: prep(), f"K3 {name}",
                                   K3_KERNELS, flops=k3_flops)
        re_k3_passes = profile_passes(torch, fwd, f"K3 without its store "
                                      f"{name}", K3_KERNELS, flops=k3_flops)
        pro_passes = profile_passes(
            torch, lambda state: ga.pair_cotangents(img, words, cap, cot,
                                                    *temps, kept=state),
            f"prologue {name}", K3_KERNELS, prep=prep)
        re_pro_passes = profile_passes(
            torch, lambda: ga.pair_cotangents(img, words, cap, cot, *temps),
            f"prologue recomputing {name}", K3_KERNELS, flops=k3_flops)
        # K4a alone (both passes, from one prologue's scratch); K4b alone
        # is the both-cotangent time less the prologue + K4a
        pairs = ga.pair_cotangents(img, words, cap, cot, *temps,
                                   kept=prep())
        ms_k4a = cuda_ms(lambda: ga.cotangents_of(pairs), iters=3, warmup=1)
        # each of K4a's passes is a product of 2·B_img·M·D·B_txt·2·TPAD
        # operations on padded captions
        padded = 2 * b_img * h * w * d * b_txt * 2 * ga._tpad(t)
        passes = profile_passes(torch, lambda: ga.cotangents_of(pairs),
                                f"K4a {name}", K4A_KERNELS,
                                flops=dict.fromkeys(K4A_KERNELS, padded))
        del pairs
        plain4a = cuda_ms(bwd(True, False, True), iters=1, warmup=0)
        plain4b = cuda_ms(bwd(False, True, True), iters=1, warmup=0)
        out_img = img.numel() * img.element_size()
        for key, ms, re, plain, err, products, out_bytes in (
                ("K3", ms3, re3, plain3, err3, 2, b_img * b_txt * 4),
                ("K4a", ms4a, re4a, plain4a, err4a, 3,
                 out_img + b_img * b_txt * 4),
                ("K4b", ms_both - ms4a, re_both - re4a, plain4b, err4b, 1,
                 words.numel() * 2 + b_img * b_txt * 4)):
            bound, by, gflop, mb = gloria_bound(img, words, out_bytes, products)
            results[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                bound_ms=bound, bound_by=by,
                                recompute_ms=re)
            print(f"{key} {name}: kernel_ms {ms:.4f} plain_ms {plain:.4f} "
                  f"bound_ms {bound:.4f} ({by}: {products} products, "
                  f"{gflop:.1f} GFLOP, {mb:.1f} MB); recomputing "
                  f"{re:.4f} ms on {card}", flush=True)
        pro_bound, _, _, _ = gloria_bound(img, words,
                                          prologue_out_bytes(ga, shape), 2)
        for prefix, found in (("", k3_passes), ("prologue_", pro_passes),
                              ("recompute_", re_k3_passes),
                              ("recompute_prologue_", re_pro_passes)):
            results["K3"].update(**{f"{prefix}{k.split()[-1]}_ms": v
                                    for k, v in found.items()})
        results["K4a"].update(k4a_only_ms=ms_k4a, **{
            f"{k.split()[-1]}_ms": v for k, v in passes.items()})
        results["K4b"].update(both_ms=ms_both, recompute_both_ms=re_both,
                              **k4b_passes(torch, ga, img, words, cap, cot,
                                           temps, name, ms_both - ms4a, card))
        for key in ("K4a", "K4b"):
            results[key].update(prologue_ms=ms_pro, prologue_bound_ms=pro_bound,
                                recompute_prologue_ms=re_pro)
        print(f"K4a {name}: the backward's prologue alone {ms_pro:.4f} ms "
              f"from K3's kept state, {re_pro:.4f} ms recomputing (bound "
              f"{pro_bound:.4f} ms), K4a alone (both passes) {ms_k4a:.4f} ms, "
              f"prologue + K4a {ms4a:.4f} ms ({re4a:.4f} recomputing); bound "
              f"{results['K4a']['bound_ms']:.4f} ms on {card}", flush=True)
        print(f"K4b {name}: prologue + K4a + K4b (both cotangents) "
              f"{ms_both:.4f} ms ({re_both:.4f} recomputing), K4b alone "
              f"{ms_both - ms4a:.4f} ms (bound "
              f"{results['K4b']['bound_ms']:.4f} ms: its own product) on "
              f"{card}", flush=True)
        print("K3's kernel_ms keeps its state and K4a's includes the "
              "prologue from it, as training runs them; K4b's is the "
              "both-cotangent time less the prologue + K4a; recompute_* "
              "are the same without the kept state", flush=True)
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
    """K3, K4a and K4b as training runs them (``gloria_check``) against
    their plain versions at B=256 flagship shapes with captions of
    ``words`` words, and the times of K3, its plain version, the
    backward's prologue, the prologue + K4a and the backward of both
    cotangents there, from K3's kept state and recomputing."""
    temps = (4.0, 5.0, 10.0)
    shape = (GLORIA_BATCH, GLORIA_BATCH, 768, 56, 56, words)
    name = f"flagship B=256 T={words}"
    img, words_, cap, cot = gloria_inputs(torch, *shape, seed=23)
    gloria_check(torch, ga, img, words_, cap, cot, temps, name)

    store = k3_store_ms(torch, ga, img, words_, cap, temps, name, card)
    ms3, re3 = store["kept"], store["recomputed"]
    times = backward_ms(torch, ga, img, words_, cap, cot, temps)
    (ms_pro, ms4a, ms_both), (re_pro, re4a, re_both) = (times["kept"],
                                                        times["recomputed"])
    plain3 = cuda_ms(lambda: ga.gloria_similarity_reference(
        img, words_, cap, *temps), iters=1, warmup=0)
    bound3, by, gflop, _ = gloria_bound(img, words_, GLORIA_BATCH ** 2 * 4, 2)
    pro_bound, _, _, _ = gloria_bound(img, words_, prologue_out_bytes(ga, shape),
                                      2)
    print(f"K3 {name}: kernel_ms {ms3:.4f} keeping its state ({re3:.4f} "
          f"without) plain_ms {plain3:.4f} bound_ms {bound3:.4f} ({by}: 2 "
          f"products, {gflop:.1f} GFLOP); the backward's prologue alone "
          f"{ms_pro:.4f} ms from the kept state ({re_pro:.4f} recomputing; "
          f"bound {pro_bound:.4f} ms), prologue + K4a {ms4a:.4f} ms "
          f"({re4a:.4f}), prologue + K4a + K4b {ms_both:.4f} ms "
          f"({re_both:.4f}; K4b alone {ms_both - ms4a:.4f} ms) on {card}",
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
        profile_device(torch, lambda: step(trainer.state, [batch]),
                       f"one gloria256 step (B={GLORIA_BATCH})")
    del objs, trainer, module, batch
    torch.cuda.empty_cache()
    return counts


def warm_step_ms(torch, trainer, module, batch, steps: int = 1) -> float:
    """The mean of ``steps`` optimizer steps of one batch, after one
    untimed step, on the host clock around work that ends in a device
    sync."""
    from medmoe_torch.train.step import build_train_step

    step = build_train_step(module, 1)
    step(trainer.state, [batch])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(trainer.state, [batch])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


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


# ---------------------------------------------------------------------------
# data-parallel training, the rectangular GLoRIA shape, the MoE modes
# ---------------------------------------------------------------------------

RECT = (GLORIA_BATCH // 2, GLORIA_BATCH)    # one of two ranks' images x all captions


def phase_gloria_rect(torch, ga, card: str, words: int = 25):
    """K3, the prologue + K4a and both cotangents (K4b) as training runs
    them (``gloria_check``) against their plain versions at the shape each
    rank of a two-rank gloria256 launches: B_img = 128 images against
    B_txt = 256 captions at full width; their times beside their bounds,
    from K3's kept state and recomputing. Returns {kernel: rect_*
    fields}."""
    temps = (4.0, 5.0, 10.0)
    b_img, b_txt = RECT
    shape = (b_img, b_txt, 768, 56, 56, words)
    name = f"rectangular {b_img}x{b_txt} T={words}"
    img, words_, cap, cot = gloria_inputs(torch, *shape, seed=24)
    err3, err4a, err4b = gloria_check(torch, ga, img, words_, cap, cot, temps,
                                      name)

    def bwd(need_img, need_words, plain=False):
        fn = ga.gloria_similarity_bwd_reference if plain \
            else ga.gloria_similarity_backward
        return lambda: fn(img, words_, cap, cot, *temps, need_img=need_img,
                          need_words=need_words)

    store = k3_store_ms(torch, ga, img, words_, cap, temps, name, card)
    ms3, re3 = store["kept"], store["recomputed"]
    times = backward_ms(torch, ga, img, words_, cap, cot, temps)
    (ms_pro, ms4a, ms_both), (re_pro, re4a, re_both) = (times["kept"],
                                                        times["recomputed"])
    plain3 = cuda_ms(lambda: ga.gloria_similarity_reference(
        img, words_, cap, *temps), iters=1, warmup=0)
    plain4a = cuda_ms(bwd(True, False, True), iters=1, warmup=0)
    plain4b = cuda_ms(bwd(False, True, True), iters=1, warmup=0)
    out_img = img.numel() * img.element_size()
    results = {}
    for key, ms, re, plain, err, products, out_bytes in (
            ("K3", ms3, re3, plain3, err3, 2, b_img * b_txt * 4),
            ("K4a", ms4a, re4a, plain4a, err4a, 3,
             out_img + b_img * b_txt * 4),
            ("K4b", ms_both - ms4a, re_both - re4a, plain4b, err4b, 1,
             words_.numel() * 2 + b_img * b_txt * 4)):
        bound, by, gflop, mb = gloria_bound(img, words_, out_bytes, products)
        results[key] = {"rect_shape": f"{b_img}x{b_txt}",
                        "rect_max_abs_err": err, "rect_ms": ms,
                        "rect_recompute_ms": re,
                        "rect_plain_ms": plain, "rect_bound_ms": bound}
        print(f"{key} {name}: kernel_ms {ms:.4f} plain_ms {plain:.4f} "
              f"bound_ms {bound:.4f} ({by}: {products} products, "
              f"{gflop:.1f} GFLOP, {mb:.1f} MB); recomputing {re:.4f} ms "
              f"on {card}", flush=True)
    pro_bound, _, _, _ = gloria_bound(img, words_,
                                      prologue_out_bytes(ga, shape), 2)
    print(f"K4 {name}: the backward's prologue alone {ms_pro:.4f} ms from "
          f"K3's kept state, {re_pro:.4f} ms recomputing (bound "
          f"{pro_bound:.4f} ms), prologue + K4a {ms4a:.4f} ms ({re4a:.4f}), "
          f"prologue + K4a + K4b {ms_both:.4f} ms ({re_both:.4f}) on {card}",
          flush=True)
    for key in ("K4a", "K4b"):
        results[key].update(rect_prologue_ms=ms_pro,
                            rect_recompute_prologue_ms=re_pro)
    results["K4b"].update(**{f"rect_{k}": v for k, v in k4b_passes(
        torch, ga, img, words_, cap, cot, temps, name, ms_both - ms4a,
        card).items()})
    del img, words_, cap, cot
    torch.cuda.empty_cache()
    return results


DDP_LR = 5e-5                        # experiment=gloria256's lr
DDP_OVERRIDES = [
    "experiment=gloria256", "data=synthetic",
    f"data.num_samples={2 * GLORIA_BATCH}", "trainer.max_epochs=1",
    "trainer.limit_train_batches=1", "trainer.limit_val_batches=0",
    "trainer.num_sanity_val_steps=0", "callbacks=none", "logger=csv",
    "extras.print_config=false", "trainer.log_every_n_steps=1",
    "model.model.vision.drop_path_rate=0.0",
    "model.model.text.hidden_dropout_prob=0.0",
    "model.model.text.attention_probs_dropout_prob=0.0"]


def trainable_state(module):
    return {n: p.detach().float().cpu()
            for n, p in module.model.named_parameters() if p.requires_grad}


def step_timer(seconds: list):
    """step_hooks' ``after``: the wall time of each optimizer step, the
    device synced at both ends."""
    import torch

    t = [None]

    def before(_state):
        torch.cuda.synchronize()
        t[0] = time.perf_counter()

    def after(_state):
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t[0])
        t[0] = time.perf_counter()
    return before, after


def probe_collectives(torch, dist) -> dict:
    """Which of all_gather, all_gather_into_tensor and all_reduce the group's
    backend takes on CUDA tensors (printed; the port calls all_gather and
    all_reduce, and a refusal there fails the phase)."""
    x = torch.full((2, 3), float(dist.get_rank()), device="cuda")
    took = {}
    for name, call in (
            ("all_gather", lambda: dist.all_gather(
                [torch.empty_like(x) for _ in range(dist.get_world_size())],
                x)),
            ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
                torch.empty((2 * dist.get_world_size(), 3), device="cuda"),
                x)),
            ("all_reduce", lambda: dist.all_reduce(x.clone()))):
        try:
            call()
            torch.cuda.synchronize()
            took[name] = "ok"
        except Exception as exc:          # reported, then judged by the caller
            took[name] = f"{type(exc).__name__}: {str(exc)[:120]}"
    return took


def ddp_rank_main() -> int:
    """One rank of phase_ddp: joins a gloo group on cuda:0 from the
    environment phase_ddp sets, then runs the train CLI's ``main`` as one
    of two nodes of one card (a node batch of 128); writes its launch
    counts, K3's shapes, metrics, step time and peak memory, and rank 0 its
    trained parameters, under ``--ddp-out``."""
    out = sys.argv[sys.argv.index("--ddp-out") + 1]
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import datetime

    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ["RANK"])
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{os.environ['MASTER_PORT']}",
        rank=rank, world_size=2, timeout=datetime.timedelta(seconds=300))
    from medmoe_torch.cli import train as cli
    from medmoe_torch.ops import gloria_attention as ga

    probe = probe_collectives(torch, dist)
    captured, shapes, seconds = {}, [], []
    real_train, real_fwd = cli.train, ga.gloria_similarity_forward

    def train(cfg):
        metrics, objs = real_train(cfg)
        captured.update(objs)
        return metrics, objs

    def fwd(img, words, *a):
        shapes.append([img.shape[0], words.shape[0]])
        return real_fwd(img, words, *a)

    cli.train, ga.gloria_similarity_forward = train, fwd
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    try:
        with step_hooks(*step_timer(seconds)):
            cli.main(DDP_OVERRIDES + [
                "trainer=ddp", "trainer.devices=1", "trainer.num_nodes=2",
                f"data.batch_size={GLORIA_BATCH // 2}",
                f"paths.root_dir={os.path.join(out, f'rank{rank}')}"])
        torch.cuda.synchronize()
        counts = launch_counts()
        trainer = captured["trainer"]
        if rank == 0:
            torch.save(trainable_state(captured["module"]),
                       os.path.join(out, "params.pt"))
        result = {"rank": rank, "counts": counts, "k3_shapes": list(shapes),
                  "metrics": trainer.metrics_history[-1],
                  "step_s": list(seconds), "steps": trainer.state.step,
                  "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        batch = trainer.to_device(next(iter(
            captured["datamodule"].train_dataloader(1))))
        result["warm_ms"] = warm_step_ms(torch, trainer, captured["module"],
                                         batch)
        result.update({
            "device": str(trainer.device), "probe": probe,
            "backend": dist.get_backend(), "world": dist.get_world_size()})
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def hold_update(torch, got, want, init, steps: int, lr: float, label: str,
                min_cos: float = 0.9):
    """The bf16 policy of tests/test_torch_train.py: the cosine of the whole
    update > ``min_cos`` (0.9), and every element within 2·steps·lr."""
    bound = 2 * steps * lr
    dots = ng = nw = 0.0
    worst = 0.0
    for k, w in want.items():
        g, i = got[k], init[k]
        worst = max(worst, (g - w).abs().max().item())
        dg, dw = (g - i).flatten().double(), (w - i).flatten().double()
        dots += float(dg @ dw)
        ng += float(dg @ dg)
        nw += float(dw @ dw)
    cos = dots / math.sqrt(ng * nw)
    print(f"{label}: parameters against the single-process step: cosine of "
          f"the whole update {cos:.6f} (> {min_cos}), largest element "
          f"difference {worst:.3e} (bound 2*steps*lr = {bound:.1e})",
          flush=True)
    check(cos > min_cos and worst <= bound,
          f"{label}: the update differs from the single-process step's")
    return cos, worst


def phase_ddp(torch, card: str):
    """experiment=gloria256 at full width with a global batch of 256 as two
    ranks of 128 on the one card (two gloo processes on cuda:0, each one
    node of one card), held against the single-process step on the same
    seed (drop rates 0); then one step through a one-rank NCCL group that
    the port's maybe_initialize opens. Returns the launch counts of the
    main path: the single-process step, both ranks and the NCCL step."""
    from medmoe_torch.cli.train import main as cli_main
    from medmoe_torch.models.medmoe import init_weights

    # the single-process reference: one step of 256, drop rates 0
    seconds = []
    with step_hooks(*step_timer(seconds)):
        cfg, metrics, objs, counts, _, _, peak_gb = drive_train(
            torch, DDP_OVERRIDES)
    module, trainer = objs["module"], objs["trainer"]
    ref = trainable_state(module)
    init = init_weights(type(module.model)(module.model.vision,
                                           module.model.text),
                        seed=cfg.seed).state_dict()
    init = {k: init[k].float() for k in ref}
    total = dict(counts)
    batch = trainer.to_device(next(iter(objs["datamodule"].train_dataloader(1))))
    warm = warm_step_ms(torch, trainer, module, batch)
    print(f"ddp: single-process step of {GLORIA_BATCH}: loss "
          f"{metrics['train/loss']:.6f} grad_norm "
          f"{metrics['train/grad_norm']:.6f}, first step "
          f"{seconds[0] * 1e3:.1f} ms, warm step {warm:.1f} ms, peak "
          f"{peak_gb:.2f} GB; launches {counts}", flush=True)
    del batch, trainer
    del objs, module
    torch.cuda.empty_cache()

    # two gloo ranks of 128 on cuda:0
    work = tempfile.mkdtemp(prefix="medmoe_ddp_")
    try:
        env = dict(os.environ, WORLD_SIZE="2", LOCAL_RANK="0",
                   MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--ddp-rank",
             "--ddp-out", work], env=dict(env, RANK=str(r)))
            for r in range(2)]
        try:
            rcs = [p.wait(timeout=420) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        check(rcs == [0, 0], f"ddp: the rank processes exited with {rcs}")
        ranks = [json.load(open(os.path.join(work, f"rank{r}.json")))
                 for r in range(2)]
        got = torch.load(os.path.join(work, "params.pt"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"ddp: gloo on CUDA tensors takes {ranks[0]['probe']}", flush=True)
    for r in ranks:
        c = r["counts"]
        print(f"ddp rank {r['rank']} ({r['backend']}, world {r['world']}, "
              f"{r['device']}): {r['steps']} step, K3 shapes "
              f"{r['k3_shapes']}, launches {c}, step wall: first "
              f"{r['step_s'][0] * 1e3:.1f} ms, warm {r['warm_ms']:.1f} ms; "
              f"peak memory {r['peak_gb']:.2f} GB on {card}", flush=True)
        check(r["backend"] == "gloo" and r["world"] == 2
              and r["device"] == "cuda:0", f"ddp rank {r['rank']}: "
              f"{r['backend']} world {r['world']} on {r['device']}")
        check(r["steps"] == 1, f"ddp rank {r['rank']}: {r['steps']} steps")
        check(r["k3_shapes"] == [list(RECT)], f"ddp rank {r['rank']}: K3 "
              f"shapes {r['k3_shapes']}, want one at {RECT}")
        check(c["K3"] == c["prologue"] == c["K4a"] == 1 and c["K4b"] == 0,
              f"ddp rank {r['rank']}: GLoRIA launches {c}")
        check(c["K1"] == c["K2"] == 1, f"ddp rank {r['rank']}: K1/K2 "
              f"launches {c} for one micro-batch")
        for k, v in c.items():
            total[k] += v
    m = ranks[0]["metrics"]
    check(m == ranks[1]["metrics"] or all(
        abs(m[k] - ranks[1]["metrics"][k]) <= 1e-6 * abs(m[k])
        for k in m if k.startswith("train/")),
        "ddp: the ranks' averaged metrics differ")
    for key in ("train/loss", "train/grad_norm"):
        rel = abs(m[key] - metrics[key]) / abs(metrics[key])
        print(f"ddp: {key} two ranks {m[key]:.6f} against one process "
              f"{metrics[key]:.6f}: rel {rel:.2e} (rtol 2e-2)", flush=True)
        check(rel <= 2e-2, f"ddp: {key} differs from the single process")
    hold_update(torch, got, ref, init, 1, DDP_LR, "ddp two ranks")
    print(f"ddp: two ranks of {GLORIA_BATCH // 2} in {wall:.1f} s of wall "
          f"time (both processes' start, build load, init and the step)",
          flush=True)

    # one rank over NCCL, the group opened by the port's maybe_initialize
    saved = {k: os.environ.get(k) for k in ("RANK", "LOCAL_RANK",
                                            "WORLD_SIZE", "MASTER_ADDR",
                                            "MASTER_PORT")}
    os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1",
                      MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
    import torch.distributed as dist

    from medmoe_torch.cli import train as cli
    from medmoe_torch.parallel.multihost import maybe_initialize

    captured, seconds = {}, []
    real_train = cli.train

    def train(cfg_):
        out = real_train(cfg_)
        captured.update(out[1])
        return out

    cli.train = train
    root = tempfile.mkdtemp(prefix="medmoe_nccl_")
    try:
        check(maybe_initialize(1, "gpu"), "ddp: maybe_initialize opened no "
              "group")
        backend = dist.get_backend()
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        with step_hooks(*step_timer(seconds)):
            nccl = cli_main(DDP_OVERRIDES + ["trainer=ddp", "trainer.devices=1",
                                             f"data.batch_size={GLORIA_BATCH}",
                                             f"paths.root_dir={root}"])
        torch.cuda.synchronize()
        counts = launch_counts()
        got = trainable_state(captured["module"])
        peak_nccl = torch.cuda.max_memory_allocated() / 1e9
        batch = captured["trainer"].to_device(next(iter(
            captured["datamodule"].train_dataloader(1))))
        warm = warm_step_ms(torch, captured["trainer"], captured["module"],
                            batch)
        del batch
    finally:
        cli.train = real_train
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(backend == "nccl", f"ddp: the one-rank group ran {backend}")
    check(captured["module"].ddp is not None, "ddp: no DDP wrapper")
    for key in ("train/loss", "train/grad_norm"):
        check(math.isfinite(nccl[key]) and nccl[key] > 0,
              f"ddp nccl: {key} = {nccl[key]}")
    check(counts["K3"] == counts["K4a"] == counts["K1"] == counts["K2"] == 1,
          f"ddp nccl: launches {counts}")
    hold_update(torch, got, ref, init, 1, DDP_LR, "ddp nccl")
    print(f"ddp: one NCCL rank of {GLORIA_BATCH}: loss {nccl['train/loss']:.6f} "
          f"grad_norm {nccl['train/grad_norm']:.6f} (one process: "
          f"{metrics['train/loss']:.6f}, {metrics['train/grad_norm']:.6f}); "
          f"first step {seconds[0] * 1e3:.1f} ms, warm step {warm:.1f} ms, "
          f"peak {peak_nccl:.2f} GB; launches {counts} on {card}", flush=True)
    for k, v in counts.items():
        total[k] += v
    del captured, got, ref, init
    torch.cuda.empty_cache()
    return total


MOE_OVERRIDES = [
    "experiment=moe_single_modality", "data=synthetic",
    "data.num_samples=256", "trainer.max_epochs=1",
    "trainer.accumulate_grad_batches=2", "trainer.limit_train_batches=4",
    "trainer.limit_val_batches=1", "trainer.num_sanity_val_steps=0",
    "callbacks=none", "logger=csv", "extras.print_config=false",
    "trainer.log_every_n_steps=1"]
DENSE_OVERRIDES = [
    "experiment=zero_shot_dense", "data=synthetic",
    f"data.num_samples={GLORIA_BATCH}", "trainer.max_epochs=1",
    "trainer.accumulate_grad_batches=1", "trainer.limit_train_batches=1",
    "trainer.limit_val_batches=0", "trainer.num_sanity_val_steps=0",
    "callbacks=none", "logger=csv", "extras.print_config=false",
    "trainer.log_every_n_steps=1"]


def moe_grads(torch, fn, leaves, cot):
    """fn() → [B, P, E] f32; (the output, its gradients at ``leaves`` for
    the cotangent ``cot``)."""
    for t in leaves:
        t.grad = None
    out = fn()
    grads = torch.autograd.grad(out, leaves, cot)
    return out.detach(), grads


def hold_close(torch, got, want, name: str, rtol: float) -> float:
    """Every element within rtol·max|want| of ``want``."""
    scale = want.abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    ok = bool(torch.isfinite(got).all()) and err <= rtol * scale
    print(f"{name}: max_abs_err {err:.3e} max|ref| {scale:.3e} (limit "
          f"{rtol:g}*max|ref|) {'ok' if ok else 'MISMATCH'}", flush=True)
    check(ok, f"{name}: disagrees")
    return err


def phase_moe_modes(torch, ef, card: str):
    """The expert branch at moe_single_modality's shape (4 experts, top-2,
    B = 64, bf16, full width) in gather mode (K1 twice a forward, K2 twice
    a backward) against topk (capacity factor 2: 64 slots an expert, all
    that top-2 over 64 samples can send it, so nothing drops) and against
    dense; then 2 optimizer steps of experiment=moe_single_modality as
    shipped (topk, capacity factor 1.5; accumulation cut from 10 to 2) and
    one of experiment=zero_shot_dense (no MoE). Returns the launch counts
    of the two training runs."""
    from medmoe_torch.models import moe as tmoe

    b, k = 64, 4
    p_list, d_list = (3136, 784, 196, 49), (96, 192, 384, 768)
    xs, wp, bp, w1, b1, w2, b2, _ = k1_inputs(torch, b, p_list, d_list, 768,
                                              384, k, seed=31)
    bank = tmoe.ExpertBank(tmoe.MoEConfig(num_experts=k, hidden_dims=d_list,
                                          output_dim=768, top_k=2)).cuda()
    with torch.no_grad():
        for s in range(4):
            getattr(bank, f"proj_w{s}").copy_(wp[s])
            getattr(bank, f"proj_b{s}").copy_(bp[s])
        for name, t in (("attn_w1", w1), ("attn_b1", b1), ("attn_w2", w2),
                        ("attn_b2", b2)):
            getattr(bank, name).copy_(t)
    g = torch.Generator(device="cuda").manual_seed(32)
    probs = torch.softmax(torch.randn((b, k), generator=g, device="cuda"), -1)
    idx, w = tmoe.topk_routing(probs, 2)
    check(len(set(idx.flatten().tolist())) == k, "moe: an expert is unused")
    cot = torch.randn((b, 3136, 768), generator=g, device="cuda") / 3136
    pyr = [x.detach().clone().requires_grad_() for x in xs]
    leaves = pyr + list(bank.parameters())
    names = [f"d_x{s}" for s in range(4)] + [n for n, _ in
                                             bank.named_parameters()]
    onehot = (idx.long()[..., None] == torch.arange(k, device="cuda"))
    combine = torch.sum(onehot.float() * w[..., None], dim=1)
    runs = {}
    for mode, fn in (
            ("gather", lambda: bank.apply_gathered(pyr, idx, w)),
            ("topk", lambda: bank.apply_dispatched(pyr, idx, 2.0, w)),
            ("dense", lambda: bank.apply_dense(pyr, combine))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = (ef.LAUNCHES, ef.BWD_LAUNCHES)
        out, grads = moe_grads(torch, fn, leaves, cot)
        torch.cuda.synchronize()
        launched = (ef.LAUNCHES - before[0], ef.BWD_LAUNCHES - before[1])
        ms = cuda_ms(lambda: moe_grads(torch, fn, leaves, cot), iters=2,
                     warmup=0)
        runs[mode] = (out, grads)
        print(f"moe {mode}: forward + backward {ms:.2f} ms, peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, K1/K2 "
              f"launches {launched} on {card}", flush=True)
        if mode == "gather":
            check(launched == (2, 2), f"moe gather top-2 launched K1/K2 "
                  f"{launched} times, want twice each")
        else:
            check(launched == (0, 0), f"moe {mode} launched K1/K2")
        torch.cuda.empty_cache()
    # gather (K1/K2) against the grouped einsums: the kernels' bf16 rounding
    # points are the JAX kernel's, the einsum modes' the JAX XLA path's,
    # equal in value up to f32 order; a bf16 flip moves single elements
    want_out, want_grads = runs["gather"]
    for mode in ("topk", "dense"):
        out, grads = runs[mode]
        hold_close(torch, out, want_out, f"moe {mode} vs gather: out", 2e-2)
        for name, got, want in zip(names, grads, want_grads):
            if name == "attn_b2":
                continue       # zero in exact arithmetic (a softmax shift)
            hold_close(torch, got, want, f"moe {mode} vs gather: {name}",
                       3e-2)
    del runs, want_out, want_grads, pyr, leaves, bank, xs
    torch.cuda.empty_cache()

    total = {}
    for label, overrides, steps in (("moe_single_modality", MOE_OVERRIDES, 2),
                                    ("zero_shot_dense", DENSE_OVERRIDES, 1)):
        seconds = []
        with step_hooks(*step_timer(seconds)):
            cfg, metrics, objs, counts, routed, wall, peak_gb = drive_train(
                torch, overrides)
        trainer, module = objs["trainer"], objs["module"]
        check(trainer.state.step == steps, f"{label}: {trainer.state.step} "
              f"optimizer steps, want {steps}")
        for key in ("train/loss", "train/grad_norm"):
            check(key in metrics and math.isfinite(metrics[key])
                  and metrics[key] > 0, f"{label}: {key} not finite positive")
        check(counts["K1"] == counts["K2"] == 0, f"{label}: K1/K2 launched "
              f"{counts}")
        experts, moved = check_moved(
            torch, module, cfg.seed,
            routed or [torch.zeros(0, dtype=torch.long)], label)
        print(f"{label}: {steps} optimizer steps, loss "
              f"{metrics['train/loss']:.6f} grad_norm "
              f"{metrics['train/grad_norm']:.6f}; routed experts {experts}, "
              f"{moved} bank rows moved, Swin moved, frozen BERT unchanged; "
              f"launches {counts}; steps "
              f"{[round(s * 1e3, 1) for s in seconds]} ms; peak "
              f"{peak_gb:.2f} GB on {card}", flush=True)
        for key, v in counts.items():
            total[key] = total.get(key, 0) + v
        del objs, trainer, module
        torch.cuda.empty_cache()
    return total


EP_BATCH = 128                       # ep_full_mix's global batch of 256, cut
EP_LR = 5e-5                         # med-moe_pretraining's lr
EP_OVERRIDES = [
    "experiment=ep_full_mix", "data=synthetic",
    f"data.num_samples={EP_BATCH}", f"data.batch_size={EP_BATCH}",
    "trainer.max_epochs=1", "trainer.accumulate_grad_batches=1",
    "trainer.limit_train_batches=1", "trainer.limit_val_batches=0",
    "trainer.num_sanity_val_steps=0", "callbacks=none", "logger=csv",
    "extras.print_config=false", "trainer.log_every_n_steps=1",
    "model.model.vision.drop_path_rate=0.0",
    "model.model.text.hidden_dropout_prob=0.0",
    "model.model.text.attention_probs_dropout_prob=0.0"]
#: (label, the rank processes' mode, the one process's mode)
EP_RUNS = (("ep", "ep", "topk"), ("gather", "gather", "gather"))


def ep_rank_main() -> int:
    """One rank of phase_ep: joins a gloo group of two on cuda:0 from the
    environment phase_ep sets, then runs the train CLI's ``main`` as one of
    two nodes of one card on a data 1 × expert 2 grid (each rank 3 of the
    6 experts, both the whole batch of EP_BATCH), once a mode of EP_RUNS;
    after the ``ep`` run every rank calls save_checkpoint (rank 0 writes the
    whole bank). Writes its launch counts, K3's shapes, metrics, step times,
    peak memory and its trainable parameters under ``--ep-out``."""
    out = sys.argv[sys.argv.index("--ep-out") + 1]
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import datetime

    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(os.environ["RANK"])
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{os.environ['MASTER_PORT']}",
        rank=rank, world_size=2, timeout=datetime.timedelta(seconds=300))
    from medmoe_torch.cli import train as cli
    from medmoe_torch.ops import gloria_attention as ga
    from medmoe_torch.utils.checkpoint import save_checkpoint

    results = []
    try:
        for label, mode, _ in EP_RUNS:
            captured, shapes, seconds = {}, [], []
            real_train, real_fwd = cli.train, ga.gloria_similarity_forward

            def train(cfg):
                metrics, objs = real_train(cfg)
                captured.update(objs)
                return metrics, objs

            def fwd(img, words, *a):
                shapes.append([img.shape[0], words.shape[0]])
                return real_fwd(img, words, *a)

            cli.train, ga.gloria_similarity_forward = train, fwd
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            try:
                with step_hooks(*step_timer(seconds)):
                    cli.main(EP_OVERRIDES + [
                        f"model.model.vision.moe_mode={mode}",
                        "trainer.devices=1", "trainer.num_nodes=2",
                        f"paths.root_dir={os.path.join(out, label, str(rank))}"])
                torch.cuda.synchronize()
            finally:
                cli.train, ga.gloria_similarity_forward = real_train, real_fwd
            counts = launch_counts()
            trainer, module = captured["trainer"], captured["module"]
            torch.save(trainable_state(module),
                       os.path.join(out, f"{label}.rank{rank}.pt"))
            if label == "ep":
                save_checkpoint(os.path.join(out, "ep.ckpt"), trainer.state)
            result = {"label": label, "rank": rank, "counts": counts,
                      "k3_shapes": list(shapes),
                      "metrics": trainer.metrics_history[-1],
                      "step_s": list(seconds), "steps": trainer.state.step,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "grid": [trainer.grid.data, trainer.grid.expert],
                      "mode": module.model.image_encoder.swin_moe.moe.config
                      .mode,
                      "local_experts": int(
                          module.model.image_encoder.swin_moe.moe.experts
                          .proj_w0.shape[0])}
            batch = trainer.to_device(next(iter(
                captured["datamodule"].train_dataloader(1))))
            result["warm_ms"] = warm_step_ms(torch, trainer, module, batch)
            result.update({"device": str(trainer.device),
                           "backend": dist.get_backend(),
                           "world": dist.get_world_size()})
            results.append(result)
            del captured, trainer, module, batch
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    return 0


def phase_ep(torch, card: str):
    """experiment=ep_full_mix at full width (6 experts, top-1, capacity
    1.25, bf16, drop rates 0), one step of a global batch of EP_BATCH, as
    two gloo ranks on cuda:0 laid out data 1 × expert 2 (each rank 3
    experts, the whole batch): (a) moe_mode=ep against one process of topk,
    (b) moe_mode=gather (K1/K2 on the all-gathered bank) against one
    process of gather, each on the same seed and batch: loss and grad_norm
    within 1e-3 relative, the update's cosine > 0.99 and 2·lr per element,
    the replicated parameters bit-equal on both ranks, K3/K4a on each rank;
    (c) the checkpoint the two ranks saved after (a), loaded by one
    process: the whole bank of the ranks' slices, bit for bit, and the
    one process's state after the same step by the same update check.
    Returns the launch counts of the main path: the one-process steps and
    both ranks' runs."""
    from medmoe_torch.models.medmoe import init_weights
    from medmoe_torch.parallel.sharding import is_expert_param
    from medmoe_torch.utils.checkpoint import load_checkpoint

    print(f"ep: ep_full_mix cut to one step (accumulation 10 -> 1) of a "
          f"global batch of {EP_BATCH} (256 -> {EP_BATCH}), drop rates 0",
          flush=True)
    refs, total, init = {}, {}, None
    for label, _, mode in EP_RUNS:
        seconds = []
        with step_hooks(*step_timer(seconds)):
            cfg, metrics, objs, counts, _, _, peak_gb = drive_train(
                torch, EP_OVERRIDES + [f"model.model.vision.moe_mode={mode}",
                                       "trainer.mesh.expert=1"])
        module, trainer = objs["module"], objs["trainer"]
        check(trainer.state.step == 1, f"ep {label}: one process took "
              f"{trainer.state.step} steps")
        refs[label] = (metrics, trainable_state(module))
        if init is None:
            init = init_weights(type(module.model)(module.model.vision,
                                                   module.model.text),
                                seed=cfg.seed).state_dict()
            init = {k: init[k].float() for k in refs[label][1]}
        batch = trainer.to_device(next(iter(
            objs["datamodule"].train_dataloader(1))))
        warm = warm_step_ms(torch, trainer, module, batch)
        print(f"ep {label}: one process of {mode} at {EP_BATCH}: loss "
              f"{metrics['train/loss']:.6f} grad_norm "
              f"{metrics['train/grad_norm']:.6f}, first step "
              f"{seconds[0] * 1e3:.1f} ms, warm step {warm:.1f} ms, peak "
              f"{peak_gb:.2f} GB; launches {counts} on {card}", flush=True)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        del batch, trainer, module, objs
        torch.cuda.empty_cache()

    work = tempfile.mkdtemp(prefix="medmoe_ep_")
    try:
        env = dict(os.environ, WORLD_SIZE="2", LOCAL_RANK="0",
                   MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--ep-rank",
             "--ep-out", work], env=dict(env, RANK=str(r)))
            for r in range(2)]
        try:
            rcs = [p.wait(timeout=480) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        check(rcs == [0, 0], f"ep: the rank processes exited with {rcs}")
        ranks = [json.load(open(os.path.join(work, f"rank{r}.json")))
                 for r in range(2)]
        states = {label: [torch.load(os.path.join(work, f"{label}.rank{r}.pt"))
                          for r in range(2)] for label, _, _ in EP_RUNS}
        ckpt = load_checkpoint(os.path.join(work, "ep.ckpt"))
    finally:
        shutil.rmtree(work, ignore_errors=True)

    for i, (label, mode, ref_mode) in enumerate(EP_RUNS):
        metrics, ref = refs[label]
        for res in (ranks[0][i], ranks[1][i]):
            c = res["counts"]
            print(f"ep {label} rank {res['rank']} ({res['backend']}, world "
                  f"{res['world']}, grid {res['grid']}, {res['device']}, "
                  f"{res['local_experts']} of 6 experts, mode {res['mode']}): "
                  f"{res['steps']} step, K3 shapes {res['k3_shapes']}, "
                  f"launches {c}, step wall: first "
                  f"{res['step_s'][0] * 1e3:.1f} ms, warm "
                  f"{res['warm_ms']:.1f} ms; peak memory "
                  f"{res['peak_gb']:.2f} GB on {card}", flush=True)
            check(res["backend"] == "gloo" and res["world"] == 2
                  and res["device"] == "cuda:0" and res["grid"] == [1, 2]
                  and res["local_experts"] == 3 and res["mode"] == mode,
                  f"ep {label} rank {res['rank']}: not expert-parallel: "
                  f"{res}")
            check(res["steps"] == 1, f"ep {label}: {res['steps']} steps")
            check(res["k3_shapes"] == [[EP_BATCH, EP_BATCH]],
                  f"ep {label}: K3 shapes {res['k3_shapes']}")
            check(c["K3"] == c["prologue"] == c["K4a"] == 1
                  and c["K4b"] == 0, f"ep {label}: GLoRIA launches {c}")
            if mode == "gather":
                check(c["K1"] >= 1 and c["K2"] == 1,
                      f"ep {label}: K1/K2 launches {c}")
            else:
                check(c["K1"] == c["K2"] == 0,
                      f"ep {label}: K1/K2 launched in {mode} mode: {c}")
            for k, v in c.items():
                total[k] = total.get(k, 0) + v
        m = ranks[0][i]["metrics"]
        check(all(m[k] == ranks[1][i]["metrics"][k] for k in m
                  if k.startswith("train/")),
              f"ep {label}: the ranks' metrics differ")
        for key in ("train/loss", "train/grad_norm"):
            rel = abs(m[key] - metrics[key]) / abs(metrics[key])
            print(f"ep {label}: {key} two expert ranks {m[key]:.6f} against "
                  f"one process of {ref_mode} {metrics[key]:.6f}: rel "
                  f"{rel:.2e} (rtol 1e-3)", flush=True)
            check(rel <= 1e-3, f"ep {label}: {key} differs from one process")
        r0, r1 = states[label]
        whole = {}
        for k, v in r0.items():
            if is_expert_param(k):
                whole[k] = torch.cat([v, r1[k]])
            else:
                check(torch.equal(v, r1[k]), f"ep {label}: replicated "
                      f"parameter {k} differs between the ranks")
                whole[k] = v
        print(f"ep {label}: the replicated parameters are bit-equal on both "
              f"ranks", flush=True)
        hold_update(torch, whole, ref, init, 1, EP_LR, f"ep {label}",
                    min_cos=0.99)
        if label == "ep":
            # (c): the file the two ranks saved holds the whole bank
            saved = ckpt["model"]
            for k, v in whole.items():
                check(torch.equal(saved[k].float(), v),
                      f"ep checkpoint: {k} is not the ranks' state")
            opt = ckpt["optimizer"]["state"]
            banks = [s for s in opt.values()
                     if s["exp_avg"].dim() == 3 and s["exp_avg"].shape[0] == 6]
            check(len(banks) >= 4, "ep checkpoint: the Adam moments of the "
                  "whole bank are missing")
            hold_update(torch, {k: saved[k].float() for k in ref}, ref, init,
                        1, EP_LR, "ep checkpoint", min_cos=0.99)
            print(f"ep checkpoint: {len(saved)} tensors, the whole bank of "
                  f"both ranks' slices bit for bit, {len(banks)} bank Adam "
                  f"moments with 6 experts", flush=True)
    print(f"ep: two expert ranks, both modes, in {wall:.1f} s of wall time "
          f"(both processes' start, init, two runs and their warm steps)",
          flush=True)
    del refs, states, ckpt, init
    torch.cuda.empty_cache()
    return total


SOFT_LOSSES = [
    "model.loss.soft_label=true",
    "model.loss.global_loss._target_="
    "medmoe_torch.ops.losses.SoftGLORIAGlobalContrastiveLoss",
    "model.loss.local_loss._target_="
    "medmoe_torch.ops.losses.SoftGLORIALocalContrastiveLoss"]
SOFT_OVERRIDES = GLORIA_OVERRIDES + SOFT_LOSSES + [
    "model.model.text.freeze_bert=false"]
SOFT_SMALL_OVERRIDES = [
    o for o in TRAIN_OVERRIDES if not o.startswith((
        "trainer.limit_train_batches", "trainer.accumulate_grad_batches",
        "trainer.limit_val_batches"))] + SOFT_LOSSES + [
    "trainer.limit_train_batches=2", "trainer.accumulate_grad_batches=2",
    "trainer.limit_val_batches=0"]
SOFT_QUANTILES = (0.9, 0.5)          # threshold0, threshold1


def csv_step_rows(cfg):
    """The per-step rows (those with the lr) of a run's metrics.csv."""
    import csv

    path = os.path.join(cfg.paths.output_dir, "csv", "metrics.csv")
    with open(path) as f:
        return [{k: float(v) for k, v in row.items() if v != ""}
                for row in csv.DictReader(f) if row.get("lr")]


def soft_thresholds(torch, overrides, label: str):
    """The seeded module on the card and the first train batch: its tool
    scores, thresholds at their off-diagonal SOFT_QUANTILES, the partition
    printed per anchor and checked not degenerate, the tool forward timed.
    Returns (threshold overrides, the initial trainable parameters, the
    tool BERT's initial state)."""
    from medmoe_torch.cli.train import fit_vocab
    from medmoe_torch.config import compose
    from medmoe_torch.utils.instantiate import instantiate

    # the module the train CLI builds: its vocabulary, its seed
    cfg = compose("train", overrides + ["paths.root_dir=unused"])
    dm = instantiate(cfg.data)
    fit_vocab(cfg, dm)
    module = instantiate(cfg.model)
    module.init_params(cfg.seed)
    module.model.to("cuda")
    module.capture_tool_params("cuda")
    batch = {k: torch.as_tensor(v).cuda()
             for k, v in next(iter(dm.train_dataloader(0))).items()}
    scores, _ = module.soft_targets(batch)
    tool_ms = cuda_ms(lambda: module.soft_targets(batch), iters=5)
    b = scores.shape[0]
    off = scores[~torch.eye(b, dtype=torch.bool, device="cuda")].double()
    # synthetic captions repeat (one a class: such pairs score 1 up to
    # rounding), so the scores form clusters (gaps above 1e-5 between
    # them) and the thresholds sit in the gaps, at the clusters' quantiles
    raw = torch.unique(off)
    cut = torch.nonzero(raw[1:] - raw[:-1] > 1e-5).flatten()
    gaps = (raw[cut] + raw[cut + 1]) / 2
    n = len(gaps) + 1
    check(n >= 3, f"{label}: {n} distinct tool scores")

    def between(q):
        return gaps[min(int(q * (n - 1)), n - 2)].item()

    thr0, thr1 = between(SOFT_QUANTILES[0]), between(SOFT_QUANTILES[1])
    pos, neg = (scores > thr0).sum(1), (scores <= thr1).sum(1)
    neither = int(((scores > thr1) & (scores <= thr0)).sum())
    print(f"{label}: tool scores of the first batch of {b}: off-diagonal "
          f"{off.min().item():.6f} to {off.max().item():.6f}, {n} "
          f"distinct; threshold0 {thr0!r} (q{SOFT_QUANTILES[0]} of the "
          f"distinct), threshold1 {thr1!r} (q{SOFT_QUANTILES[1]}); "
          f"positives per anchor min/median/max "
          f"{pos.min().item()}/{pos.median().item()}/{pos.max().item()}, "
          f"negatives {neg.min().item()}/{neg.median().item()}/"
          f"{neg.max().item()}, {neither} pairs in neither; the tool forward "
          f"(BERT at {b} x {batch['input_ids'].shape[1]}, "
          f"{'snapshot' if module.tool_bert is not None else 'live, frozen'}"
          f") {tool_ms:.3f} ms", flush=True)
    check(bool(((pos >= 2) & (neg >= 1)).any()) and neither > 0,
          f"{label}: the soft partition is degenerate")
    init = {n: p.detach().float().cpu().clone()
            for n, p in module.model.named_parameters() if p.requires_grad}
    tool = None if module.tool_bert is None else {
        k: v.detach().cpu().clone()
        for k, v in module.tool_bert.state_dict().items()}
    del module, batch, scores, dm
    torch.cuda.empty_cache()
    return ([f"model.loss.threshold0={thr0!r}",
             f"model.loss.threshold1={thr1!r}"], init, tool, tool_ms)


def phase_soft(torch, card: str):
    """Soft-label and hard-negative pretraining at full width: (a) 2
    gloria256 steps of 256 with BERT training, the soft global and local
    losses (K1, K2, K3, the prologue, K4a and K4b), thresholds from the
    first batch's tool scores; (b) its first step again with the local
    loss's einsum path (model.loss.local_loss.impl=xla), held against it;
    (c) one gloria256 step with HardNegativeContrastiveLoss as the global
    loss; (d) pretraining_medmoe_ddp with soft labels (BERT frozen, as
    shipped; accumulation cut from 80 to 2): the einsum soft local at B=32,
    K1/K2. Returns the launch counts of the four runs."""
    total = dict.fromkeys(launch_counts(), 0)

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    # (a) soft gloria256, BERT training
    thr, init, tool0, tool_ms = soft_thresholds(torch, SOFT_OVERRIDES,
                                                "soft gloria256")
    first = {}

    def keep_first(state):
        if not first:
            first.update({n: p.detach().float().cpu().clone()
                          for n, p in state.model.named_parameters()
                          if p.requires_grad})

    roots = [tempfile.mkdtemp(prefix="medmoe_soft_") for _ in range(2)]
    try:
        with step_hooks(after=keep_first):
            cfg, metrics, objs, counts, _, _, peak_gb = drive_train(
                torch, SOFT_OVERRIDES + thr, roots[0])
        rows = csv_step_rows(cfg)
        trainer, module = objs["trainer"], objs["module"]
        add(counts)
        print(f"soft gloria256: {trainer.state.step} optimizer steps of "
              f"{GLORIA_BATCH} pairs; launches {counts}; per step "
              + json.dumps([{k: round(r[f'train/{k}'], 6) for k in
                             ("loss", "l_loss", "g_loss", "grad_norm")}
                            for r in rows]), flush=True)
        check(trainer.state.step == 2 and len(rows) == 2,
              f"soft gloria256: {trainer.state.step} steps")
        for r in rows:
            check(r["train/l_loss"] != 0 and r["train/g_loss"] != 0,
                  "soft gloria256: a soft loss is 0")
            check(math.isfinite(r["train/grad_norm"])
                  and r["train/grad_norm"] > 0,
                  "soft gloria256: grad_norm not positive and finite")
        check(math.isfinite(metrics.get("val/loss", float("nan"))),
              "soft gloria256: val/loss not finite")
        check(counts["K3"] == 3 and counts["prologue"] == counts["K4a"]
              == counts["K4b"] == counts["K2"] == 2 and counts["K1"] >= 3,
              f"soft gloria256: launches {counts}, expected K3 3 times (2 "
              f"train, 1 val), the prologue, K4a, K4b and K2 twice")
        tool = module.tool_bert.state_dict()
        check(all(torch.equal(tool[k].cpu(), v) for k, v in tool0.items()),
              "soft gloria256: the tool BERT changed")
        bert = "text_encoder.bert."
        check(any(not torch.equal(first[k], init[k]) for k in init
                  if k.startswith(bert)), "soft gloria256: BERT did not move")
        check(module.tool_bert is not None
              and not set(map(id, module.tool_bert.parameters()))
              & set(map(id, trainer.state.params)),
              "soft gloria256: the tool BERT is in the optimizer")
        batch = trainer.to_device(next(iter(
            objs["datamodule"].train_dataloader(1))))
        step_ms = warm_step_ms(torch, trainer, module, batch)
        peak = max(peak_gb, torch.cuda.max_memory_allocated() / 1e9)
        print(f"soft gloria256: BERT moved, the tool BERT did not; warm step "
              f"{step_ms:.3f} ms = {GLORIA_BATCH / step_ms * 1e3:.1f} "
              f"pairs/s; the tool forward {tool_ms:.3f} ms; peak memory "
              f"{peak:.2f} GB on {card}", flush=True)
        del objs, trainer, module, batch, tool
        torch.cuda.empty_cache()

        # (b) the same first step through the einsum path
        plain, step_s = {}, []
        start, stop = step_timer(step_s)

        def keep_plain(state):
            stop(state)
            plain.update({n: p.detach().float().cpu().clone()
                          for n, p in state.model.named_parameters()
                          if p.requires_grad})

        with step_hooks(start, keep_plain):
            cfg_b, _, objs, counts, _, seconds, peak_b = drive_train(
                torch, SOFT_OVERRIDES + thr + [
                    "model.loss.local_loss.impl=xla",
                    "trainer.limit_train_batches=1",
                    "trainer.limit_val_batches=0"], roots[1])
        add(counts)
        check(counts["K3"] == counts["K4a"] == counts["K4b"] == 0,
              f"soft einsum: GLoRIA kernels launched {counts}")
        row = csv_step_rows(cfg_b)[0]
        del objs
        torch.cuda.empty_cache()
    finally:
        for r in roots:
            shutil.rmtree(r, ignore_errors=True)
    for key in ("loss", "l_loss", "grad_norm"):
        got, want = rows[0][f"train/{key}"], row[f"train/{key}"]
        rel = abs(got - want) / max(abs(want), 1e-12)
        print(f"soft gloria256: step 1 {key} kernels {got:.6f} against the "
              f"einsum path {want:.6f}: rel {rel:.2e} (rtol 2e-2)",
              flush=True)
        check(rel <= 2e-2, f"soft: {key} of the kernels' path differs from "
              f"the einsum path's")
    hold_update(torch, first, plain, init, 1, 5e-5, "soft kernels vs einsum",
                min_cos=0.99)
    print(f"soft einsum path: its step of {GLORIA_BATCH} {step_s[0]:.3f} s "
          f"(the first, cold; the run {seconds:.1f} s with init), peak "
          f"{peak_b:.2f} GB", flush=True)
    del first, plain, init

    # (c) hard negatives as the global loss
    cfg, metrics, objs, counts, _, seconds, peak_c = drive_train(
        torch, GLORIA_OVERRIDES + [
            "model.loss.global_loss._target_="
            "medmoe_torch.ops.losses.HardNegativeContrastiveLoss",
            "trainer.limit_train_batches=1", "trainer.limit_val_batches=0"])
    add(counts)
    print(f"hard negatives: 1 step of {GLORIA_BATCH}: train/loss "
          f"{metrics['train/loss']:.6f} g_loss {metrics['train/g_loss']:.6f} "
          f"grad_norm {metrics['train/grad_norm']:.6f}; launches {counts}; "
          f"{seconds:.1f} s, peak {peak_c:.2f} GB", flush=True)
    check(math.isfinite(metrics["train/loss"])
          and metrics["train/grad_norm"] > 0, "hard negatives: loss or "
          "grad_norm")
    check(counts["K3"] == counts["K4a"] == counts["K2"] == 1,
          f"hard negatives: launches {counts}")
    del objs
    torch.cuda.empty_cache()

    # (d) the small batch: soft labels at B=32, BERT frozen
    print("soft pretraining_medmoe_ddp: accumulate_grad_batches cut from 80 "
          "to 2 (1 optimizer step of 2 x 32 pairs)", flush=True)
    thr, _, _, tool_ms = soft_thresholds(torch, SOFT_SMALL_OVERRIDES,
                                         "soft pretraining_medmoe_ddp")
    cfg, metrics, objs, counts, _, seconds, peak_d = drive_train(
        torch, SOFT_SMALL_OVERRIDES + thr)
    add(counts)
    print(f"soft pretraining_medmoe_ddp: {objs['trainer'].state.step} step: "
          f"train/loss {metrics['train/loss']:.6f} l_loss "
          f"{metrics['train/l_loss']:.6f} g_loss {metrics['train/g_loss']:.6f}"
          f" grad_norm {metrics['train/grad_norm']:.6f}; launches {counts}; "
          f"{seconds:.1f} s, peak {peak_d:.2f} GB on {card}", flush=True)
    check(objs["trainer"].state.step == 1, "soft pretraining_medmoe_ddp: "
          "steps")
    check(metrics["train/l_loss"] != 0 and metrics["train/g_loss"] != 0
          and math.isfinite(metrics["train/grad_norm"])
          and metrics["train/grad_norm"] > 0,
          "soft pretraining_medmoe_ddp: a soft loss is 0 or grad_norm bad")
    check(objs["module"].tool_bert is None, "soft pretraining_medmoe_ddp: "
          "a snapshot with BERT frozen")
    check(counts["K2"] == 2 and counts["K1"] >= 2 and counts["K3"] == 0,
          f"soft pretraining_medmoe_ddp: launches {counts}")
    del objs
    torch.cuda.empty_cache()
    return total


CNN_BATCH = 32
CNN_TIMED = 3           # warm steps timed per cell and precision
CNN_OVERRIDES = [
    "experiment=pretraining_medmoe_ddp",
    "model=classification", "model.vision.model_name=resnet_50",
    "model.vision.lora=true", "model.vision.norm=group",
    "model.freeze_encoder=false", "model.num_classes=6",
    "model.multilabel=false", "data=synthetic", "data.emit_uint8=true",
    f"data.batch_size={CNN_BATCH}", f"data.num_samples={2 * CNN_BATCH}",
    "data.image_size=224", "trainer.max_epochs=1",
    "trainer.limit_train_batches=2", "trainer.accumulate_grad_batches=1",
    "trainer.limit_val_batches=0", "trainer.num_sanity_val_steps=0",
    "callbacks=none", "logger=csv", "extras.print_config=false",
    "trainer.log_every_n_steps=1"]


@contextlib.contextmanager
def tf32_convolutions(torch):
    """cuDNN's TF32 convolutions, PyTorch's default (and what cli.train
    runs, which leaves the flag alone), for the block; the script's own
    setting (off) after it."""
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = was


def cnn_init(torch, cfg):
    """The classifier that ``cfg``'s run started from: the same vision
    config and seed, on the CPU."""
    from medmoe_torch.config import DotDict
    from medmoe_torch.train.classification import ClassificationModule

    mod = ClassificationModule(vision=DotDict(cfg.model.vision),
                               num_classes=int(cfg.model.num_classes),
                               freeze_encoder=bool(cfg.model.freeze_encoder))
    mod.init_params(cfg.seed)
    return {k: v.clone() for k, v in mod.model.state_dict().items()}


def cnn_train(torch, card: str, label: str, overrides, steps: int):
    """``steps`` optimizer steps of model=classification on uint8 224²
    images through the train CLI's ``train``; checks the loss, grad_norm
    and that no hand-written kernel ran; returns (module, init state,
    trained state, warm step ms, peak GB)."""
    cfg, metrics, objs, counts, _, seconds, peak = drive_train(
        torch, overrides + [f"trainer.limit_train_batches={steps}"])
    trainer, module = objs["trainer"], objs["module"]
    batch = trainer.to_device(next(iter(
        objs["datamodule"].train_dataloader(1))))
    check(batch["image"].dtype == torch.uint8, f"{label}: not uint8 images")
    check(trainer.state.step == steps, f"{label}: {trainer.state.step} "
          f"steps")
    check(math.isfinite(metrics["train/loss"])
          and math.isfinite(metrics["train/grad_norm"])
          and metrics["train/grad_norm"] > 0,
          f"{label}: loss or grad_norm: {metrics}")
    check(not any(counts.values()), f"{label}: kernels launched {counts}")
    now = {k: v.detach().cpu() for k, v in module.model.state_dict().items()}
    init = cnn_init(torch, cfg)
    torch.cuda.reset_peak_memory_stats()
    step_ms = warm_step_ms(torch, trainer, module, batch, CNN_TIMED)
    peak = max(peak, torch.cuda.max_memory_allocated() / 1e9)
    with tf32_convolutions(torch):
        tf32_ms = warm_step_ms(torch, trainer, module, batch, CNN_TIMED)
    print(f"{label}: {steps} steps of {CNN_BATCH} uint8 224² images "
          f"(resized to 299²) in {seconds:.1f} s (init included); train/loss "
          f"{metrics['train/loss']:.6f}, grad_norm "
          f"{metrics['train/grad_norm']:.6f}; warm step (mean of "
          f"{CNN_TIMED}) {step_ms:.3f} ms = "
          f"{CNN_BATCH / step_ms * 1e3:.1f} img/s f32, {tf32_ms:.3f} ms = "
          f"{CNN_BATCH / tf32_ms * 1e3:.1f} img/s with TF32 convolutions "
          f"(cuDNN's default, what cli.train runs); peak {peak:.2f} GB; "
          f"launches {counts} on {card}", flush=True)
    del objs, trainer, batch
    return module, init, now, step_ms, peak


def cnn_card_vs_cpu(torch, module, label: str):
    """One forward and backward of the classifier on 4 uint8 224² images
    (resized to 299²) on the card against the same weights on the CPU, in
    f32 (TF32 off). The tower's global and local features within 1e-3 of
    their largest value (f32 sums in another order give ~1e-5). The
    gradients of the cross entropy against a float64 run on the CPU: a
    299² ResNet's f32 gradient is itself that far from float64 (ReLU
    inputs within rounding of 0 fall on either side, and on some tensors
    the CPU's own f32 lies hundredths of the tensor's largest element off
    its float64), so the card's f32 must be no further from float64 than 4
    times the CPU's f32 is, by the worst tensor's max |Δ| / max |g| and by
    1 − cosine over all gradients. Then the features again with cuDNN's
    TF32 convolutions, PyTorch's default: within 2e-2 of their largest
    (inputs rounded to 10 mantissa bits, 2⁻¹¹ a product, over 50–120
    convolutions, each renormalised)."""
    import numpy as np
    import torch.nn.functional as F

    from medmoe_torch.models.resnet import resize_pixels
    from medmoe_torch.train.classification import ClassificationModule

    cpu = ClassificationModule(vision=module.vision_cfg,
                               num_classes=module.num_classes,
                               freeze_encoder=module.freeze_encoder)
    cpu.model.load_state_dict({k: v.cpu()
                               for k, v in module.model.state_dict().items()})
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randint(0, 256, (4, 224, 224, 3),
                                     dtype=np.uint8))
    y = torch.from_numpy(rng.randint(0, module.num_classes, 4))

    def grads(model):
        return {n: p.grad.cpu().double() for n, p in model.named_parameters()
                if p.grad is not None}

    def run(model, dev):
        model.zero_grad(set_to_none=True)
        g, loc, _ = model.encoder(x.to(dev))
        F.cross_entropy(model.head(g), y.to(dev)).backward()
        return g.detach().cpu(), loc.detach().cpu(), grads(model)

    want, got = run(cpu.model, "cpu"), run(module.model, "cuda")
    # the float64 reference: the tower's backbone on the resized pixels
    # (the tower and the head cast to f32 themselves)
    ref = cpu.model.double()
    ref.zero_grad(set_to_none=True)
    g64, _ = ref.encoder.tower.model(resize_pixels(x).double())
    F.cross_entropy(ref.head.classifier(g64), y).backward()
    exact = grads(ref)
    for i, name in enumerate(("global", "local")):
        err = (got[i] - want[i]).abs().max().item()
        scale = want[i].abs().max().item()
        print(f"{label} card vs CPU, {name} {tuple(want[i].shape)}: max |Δ| "
              f"{err:.3e}, max |CPU| {scale:.3e} (bound 1e-3 of it)",
              flush=True)
        check(err <= 1e-3 * scale, f"{label}: card and CPU {name} features "
              f"differ by {err}")
    check(set(want[2]) == set(got[2]) == set(exact) and len(exact) > 50,
          f"{label}: {len(want[2])} gradients on the CPU, {len(got[2])} on "
          f"the card, {len(exact)} in float64")

    def off(g):
        """(worst max |Δ| / max |g| and its tensor, 1 − cosine) of ``g``
        against the float64 gradients."""
        worst = max(((g[k] - exact[k]).abs().max().item()
                     / max(exact[k].abs().max().item(), 1e-300), k)
                    for k in exact)
        a = torch.cat([g[k].flatten() for k in sorted(exact)])
        b = torch.cat([exact[k].flatten() for k in sorted(exact)])
        return worst, 1 - (a @ b / (a.norm() * b.norm())).item()

    (card_w, card_k), card_c = off(got[2])
    (cpu_w, cpu_k), cpu_c = off(want[2])
    print(f"{label}, {len(exact)} gradients against float64: the card's "
          f"f32 worst max |Δ| / max |g| {card_w:.3e} ({card_k}), 1 − cosine "
          f"{card_c:.3e}; the CPU's f32 {cpu_w:.3e} ({cpu_k}), {cpu_c:.3e} "
          f"(bound 4 times the CPU's)", flush=True)
    check(card_w <= 4 * max(cpu_w, 1e-6), f"{label}: the card's gradients "
          f"{card_w} off float64 against the CPU's {cpu_w}")
    check(card_c <= 4 * max(cpu_c, 1e-12), f"{label}: the card's gradient "
          f"cosine off float64 by {card_c} against the CPU's {cpu_c}")
    with torch.no_grad(), tf32_convolutions(torch):
        tf32 = module.model.encoder(x.cuda())
    for i, name in enumerate(("global", "local")):
        err = (tf32[i].cpu() - want[i]).abs().max().item()
        scale = want[i].abs().max().item()
        print(f"{label} card with TF32 convolutions vs CPU, {name}: max |Δ| "
              f"{err:.3e} = {err / scale:.3e} of max |CPU| (bound 2e-2)",
              flush=True)
        check(err <= 2e-2 * scale, f"{label}: TF32 {name} features differ "
              f"by {err}")
    module.model.zero_grad(set_to_none=True)


def flava_inputs(np, seed: int = 5, b: int = 32, t: int = 128,
                 grid: int = 14, d: int = 768, vocab: int = 30522,
                 image_vocab: int = 8192):
    """FLAVA's published shapes (torchmultimodal ``flava_model``): batch
    32, text 128 tokens with 15% masked for MLM, 196 image patches masked
    by ImageMaskingGenerator((14, 14), 75) for MIM (labels in the 8192
    visual codebook), ITM labels; the unimodal encoders' hidden states
    drawn from a numpy seed (the losses and the multimodal encoder are
    what runs)."""
    from medmoe_torch.data.masking import ImageMaskingGenerator

    rng = np.random.RandomState(seed)
    p = grid * grid
    img_h = rng.randn(b, p + 1, d).astype(np.float32)      # CLS + patches
    txt_h = rng.randn(b, t, d).astype(np.float32)
    mlm = rng.randint(0, vocab, (b, t)).astype(np.int64)
    mlm[rng.rand(b, t) >= 0.15] = -1
    masks = ImageMaskingGenerator((grid, grid), 75 * p // 196, seed=seed)
    mim = rng.randint(0, image_vocab, (b, p)).astype(np.int64)
    for i in range(b):
        mim[i][masks().reshape(-1) == 0] = -1
    return {"img_h": img_h, "txt_h": txt_h, "mlm": mlm, "mim": mim,
            "itm": rng.randint(0, 2, b).astype(np.int64),
            "img_g": rng.randn(b, d).astype(np.float32),
            "txt_g": rng.randn(b, d).astype(np.float32)}


def flava_step(torch, loss_fn, encoder, x):
    """FLAVAPretrainingLoss at its published widths, the multimodal
    encoder's output feeding ITM: the loss dict."""
    mm = encoder(torch.cat([x["img_h"], x["txt_h"]], dim=1))
    return loss_fn(image_sequence=x["img_g"], text_sequence=x["txt_g"],
                   image_masked_sequence=x["img_h"][:, 1:],
                   text_masked_sequence=x["txt_h"],
                   multimodal_masked_sequence=mm.last_hidden_state,
                   itm_labels=x["itm"], mlm_labels=x["mlm"],
                   mim_labels=x["mim"])


def phase_cnn(torch, card: str):
    """The CNN towers with LoRA through classification fine-tuning, and the
    FLAVA losses, on the card at full width (f32, norm=group, uint8 224²
    images resized to 299² by the tower, batch 32): (1) 2 fine-tuning
    steps of resnet_50 + LoRA (every lora_b left zero, the base kernels
    and the head moved); (2) 1 linear-probe step (the encoder
    bit-unchanged, the head moved); (3) 1 step each of densenet_121 and
    resnext_50; (4) for resnet_50 + LoRA, densenet_121 and resnext_50, a
    forward and backward on the card against the same weights on the CPU
    (``cnn_card_vs_cpu``), and each step's time also with TF32
    convolutions; (5) FLAVAPretrainingLoss at hidden 768 with a
    6 × 768 multimodal encoder, forward and backward on the card against
    the CPU. No hand-written kernel runs: K1–K4b's counters stay at 0."""
    import numpy as np

    from medmoe_torch.models.medmoe import init_weights
    from medmoe_torch.models.transformer import \
        FLAVATransformerWithoutEmbeddings
    from medmoe_torch.ops.flava import FLAVAPretrainingLoss
    from medmoe_torch.train.optim import adam

    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "cnn: TF32 is on")
    reset_launch_counts()
    # (1) resnet_50 + LoRA fine-tuning
    module, init, now, _, _ = cnn_train(torch, card, "cnn resnet_50+LoRA",
                                        CNN_OVERRIDES, 2)
    lora_b = [k for k in now if k.endswith("lora_b")]
    check(lora_b and all(now[k].abs().sum() > 0 for k in lora_b),
          "cnn resnet_50: a lora_b is still zero")
    check(all(not init[k].any() for k in lora_b), "cnn resnet_50: lora_b "
          "did not start at zero")
    tower = "encoder.resnet.model."
    for k in (tower + "conv1.weight", tower + "layer3_block5.conv2.weight",
              tower + "layer4_block2.conv3.weight", "head.classifier.weight"):
        check(not torch.equal(now[k], init[k]), f"cnn resnet_50: {k} did "
              f"not move")
    print(f"cnn resnet_50+LoRA: {len(lora_b)} lora_b left zero; the base "
          f"kernels and the head moved", flush=True)
    # (4) the card against the CPU on the trained weights (lora_b live)
    cnn_card_vs_cpu(torch, module, "cnn resnet_50+LoRA")
    del module, init, now
    torch.cuda.empty_cache()

    # (2) the linear probe
    module, init, now, _, _ = cnn_train(
        torch, card, "cnn resnet_50 linear probe",
        CNN_OVERRIDES + ["model.freeze_encoder=true"], 1)
    enc = [k for k in now if k.startswith("encoder.")]
    check(enc and all(torch.equal(now[k], init[k]) for k in enc),
          "cnn linear probe: the encoder changed")
    check(not torch.equal(now["head.classifier.weight"],
                          init["head.classifier.weight"]),
          "cnn linear probe: the head did not move")
    del module, init, now
    torch.cuda.empty_cache()

    # (3) densenet_121 and resnext_50
    for name in ("densenet_121", "resnext_50"):
        module, _, _, _, _ = cnn_train(
            torch, card, f"cnn {name}",
            CNN_OVERRIDES + [f"model.vision.model_name={name}"], 1)
        cnn_card_vs_cpu(torch, module, f"cnn {name}")
        del module
        torch.cuda.empty_cache()

    # (5) FLAVA at its published widths, card against CPU
    host = flava_inputs(np)
    nets = []
    for dev in ("cpu", "cuda"):
        loss_fn = FLAVAPretrainingLoss(hidden_size=768,
                                       text_vocab_size=30522,
                                       image_vocab_size=8192)
        enc6 = FLAVATransformerWithoutEmbeddings(num_layers=6, dim=768,
                                                 num_heads=12)
        init_weights(loss_fn, 7)
        init_weights(enc6, 8)
        nets.append((loss_fn.to(dev), enc6.to(dev)))
    outs = []
    for (loss_fn, enc6), dev in zip(nets, ("cpu", "cuda")):
        x = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        losses = flava_step(torch, loss_fn, enc6, x)
        losses["loss"].backward()
        # the encoder's pooler feeds no loss (ITM pools on its own)
        grads = {n: p.grad.detach().cpu() for m in (loss_fn, enc6)
                 for n, p in m.named_parameters(prefix=type(m).__name__)
                 if p.grad is not None}
        outs.append(({k: v.item() for k, v in losses.items()}, grads))
    (closs, cgrad), (gloss, ggrad) = outs
    check(set(cgrad) == set(ggrad) and len(cgrad) >= 100,
          f"flava: {len(cgrad)} gradients on the CPU, {len(ggrad)} on the "
          f"card")
    # a key bias shifts a query's logits alike: its gradient is 0 in exact
    # arithmetic and rounding noise on either side (tests/test_torch_train.py
    # ZERO_GRAD), held below 1e-4 of the largest gradient instead
    zero = [k for k in cgrad if k.endswith("attention.k_proj.bias")]
    top = max(g.abs().max().item() for g in cgrad.values())
    noise = max(max(cgrad[k].abs().max().item(), ggrad[k].abs().max().item())
                for k in zero)
    check(noise <= 1e-4 * top, f"flava: key-bias gradients {noise} against "
          f"the largest {top}")
    worst = max(((ggrad[k] - cgrad[k]).abs().max().item()
                 / max(cgrad[k].abs().max().item(), 1e-30), k)
                for k in cgrad if k not in zero)
    print("flava: losses on the card " + json.dumps(
        {k: round(v, 6) for k, v in gloss.items()}) + ", on the CPU "
        + json.dumps({k: round(v, 6) for k, v in closs.items()})
        + f"; gradients: largest max |Δ| / max |g| {worst[0]:.3e} "
        f"({worst[1]}; bound 1e-3); the key biases' (0 in exact "
        f"arithmetic) at most {noise:.3e} of the largest gradient {top:.3e}",
        flush=True)
    check(set(gloss) == {"mlm_loss", "mim_loss", "itm_loss",
                         "global_contrastive_loss", "loss"},
          f"flava: terms {sorted(gloss)}")
    for k, v in closs.items():
        check(math.isfinite(gloss[k]) and abs(gloss[k] - v) <= 1e-4 * abs(v),
              f"flava: {k} card {gloss[k]} against CPU {v}")
    check(worst[0] <= 1e-3, f"flava: gradient {worst[1]} off by {worst[0]}")
    loss_fn, enc6 = nets[1]
    opt = adam(lr=1e-4).init(list(loss_fn.parameters())
                             + list(enc6.parameters()))
    x = {k: torch.from_numpy(v).cuda() for k, v in host.items()}

    def step():
        opt.zero_grad(set_to_none=True)
        flava_step(torch, loss_fn, enc6, x)["loss"].backward()
        opt.step()

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(step, iters=3, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"flava: warm step (forward, backward, Adam) of 32 pairs {ms:.3f} "
          f"ms = {32 / ms * 1e3:.1f} pairs/s; peak {peak:.2f} GB on {card}",
          flush=True)
    del nets, loss_fn, enc6, opt, x
    torch.cuda.empty_cache()
    counts = launch_counts()
    check(not any(counts.values()), f"cnn: K1–K4b launched {counts}")
    return counts


CLI_OVERRIDES = [
    "experiment=pretraining_medmoe", "data=synthetic", "trainer.max_epochs=1",
    "trainer.num_sanity_val_steps=0", "extras.print_config=false",
    "trainer.log_every_n_steps=1"]
# hparams_search=medmoe_tpe as shipped (its search space and seed 1234),
# 2 trials, each cut to accumulation 2, 2 train batches and 1 val batch
CLI_SWEEP = CLI_OVERRIDES + [
    "hparams_search=medmoe_tpe", "hparams_search.n_trials=2",
    "hparams_search.n_startup_trials=2", "trainer.accumulate_grad_batches=2",
    "trainer.limit_train_batches=2", "trainer.limit_val_batches=1",
    "data.num_samples=512", "callbacks=none", "logger=csv"]
CLI_SCRIPTS = ("train", "evaluate", "eval_zs", "serve", "export")


def cli_help():
    """``--help`` of the five CLIs through their console-script adapters:
    each prints the config groups and returns status 0."""
    from medmoe_torch.cli import _script

    argv = sys.argv
    for name in CLI_SCRIPTS:
        out = io.StringIO()
        sys.argv = [f"medmoe-torch-{name}", "--help"]
        try:
            with contextlib.redirect_stdout(out):
                status = getattr(_script, name)()
        finally:
            sys.argv = argv
        text = out.getvalue()
        check(status == 0 and "config groups:" in text
              and "hparams_search=medmoe_random, medmoe_tpe" in text,
              f"medmoe-torch-{name} --help: status {status}, {text[:300]!r}")
    print(f"cli: --help of {len(CLI_SCRIPTS)} CLIs "
          f"(medmoe_torch.cli._script.{', '.join(CLI_SCRIPTS)}) printed the "
          f"config groups, status 0", flush=True)


def native_probe() -> str:
    """'' when g++ and libjpeg's headers are there, else what is missing."""
    gxx = shutil.which("g++")
    if gxx is None:
        return "g++ not found"
    probe = subprocess.run([gxx, "-E", "-x", "c++", "-"],
                           input="#include <jpeglib.h>\n",
                           capture_output=True, text=True, timeout=60)
    return "" if probe.returncode == 0 else "jpeglib.h not found"


def loader_pairs_s(cfg, epoch: int, batches: int) -> float:
    """The Unimed loader alone on the host: ``batches`` batches of
    ``epoch``, pairs/s."""
    import itertools

    from medmoe_torch.utils.instantiate import instantiate

    dm = instantiate(cfg.data, ranks_per_node=1)
    t0 = time.perf_counter()
    with contextlib.closing(dm.train_dataloader(epoch)) as loader:
        n = sum(len(b["cap_lens"]) for b in itertools.islice(loader,
                                                             batches))
    seconds = time.perf_counter() - t0
    check(n == batches * dm.batch_size, f"loader drew {n} pairs")
    return n / seconds


def phase_cli(torch, card: str):
    """The CLI and host surface at full width (bf16, weights from the
    seed): --help, a TPE sweep of experiment=pretraining_medmoe in this
    process and one trial in a subprocess, --multirun of 2 jobs, debug=
    profiler with every logger, and the C++ decode helper against PIL.
    Returns the launch counts summed over the runs of this process."""
    import gc
    import random

    from medmoe_torch.cli import train as tcli
    from medmoe_torch.config import compose, to_dict
    from medmoe_torch.data import native
    from medmoe_torch.train import callbacks as tcb
    from medmoe_torch.train import sweep

    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    cli_help()
    print("cli: cuts: sweep trials at accumulation 2 (of 10), 2 train "
          "batches, 1 val batch, 1 epoch, no sanity validation; the "
          "multirun's jobs 1 step and no validation; debug=profiler 3 train "
          "batches (of 30) and 1 val batch; the native-decode training 2 "
          "steps of pretraining_medmoe_ddp (accumulation 2 of 80)",
          flush=True)
    work = tempfile.mkdtemp(prefix="medmoe_cli_")
    try:
        # 1. a TPE sweep in this process: pretraining_medmoe's own
        # composition (global negatives), 2 trials of the shipped space
        argv = CLI_SWEEP + [f"paths.root_dir={os.path.join(work, 'sweep')}"]
        hs = compose("train", argv).hparams_search
        rng = random.Random(int(hs.seed))     # the sampler's startup draws
        draws = [sweep._sample(hs.params, rng) for _ in range(2)]
        print(f"cli: sweep space {json.dumps(to_dict(hs.params))}; seed "
              f"{hs.seed} draws data.batch_size "
              f"{[d['data.batch_size'] for d in draws]}, lr "
              f"{[d['model.optimizer.lr'] for d in draws]}, "
              f"classifier_loss_weight "
              f"{[d['model.loss.classifier_loss_weight'] for d in draws]}",
              flush=True)
        trials = []
        real_job = tcli.run_job

        def recorded(overrides):
            if "hparams_search=null" not in overrides:
                return real_job(overrides)        # the sweep itself
            torch.cuda.synchronize()
            before, t0 = launch_counts(), time.perf_counter()
            try:
                metrics = real_job(overrides)
            except Exception as e:
                trials.append((overrides, repr(e), None, None))
                raise
            torch.cuda.synchronize()
            after = launch_counts()
            trials.append((overrides, metrics, time.perf_counter() - t0,
                           {k: after[k] - before[k] for k in after}))
            gc.collect()                  # the trial's model and Adam state
            torch.cuda.empty_cache()
            return metrics

        tcli.run_job = recorded
        reset_launch_counts()
        try:
            metrics = tcli.main(argv)
        finally:
            tcli.run_job = real_job
        add(launch_counts())
        check(len(trials) == 2, f"sweep ran {len(trials)} trials")
        for i, (overrides, m, seconds, counts) in enumerate(trials):
            check(seconds is not None, f"sweep trial {i} failed: {m}")
            b = int(next(o for o in overrides
                         if o.startswith("data.batch_size=")).split("=")[1])
            check(b == draws[i]["data.batch_size"], f"trial {i}: batch {b}")
            check(math.isfinite(m["val/loss"]) and math.isfinite(
                m["train/loss"]), f"trial {i} metrics {m}")
            check(counts["K2"] == 2 and counts["K1"] >= 3,
                  f"trial {i} (2 micro-batches, 1 val batch): {counts}")
            if b > 64:         # the fused local loss: K3/prologue/K4a
                check(counts["K3"] >= 3 and counts["prologue"] == 2
                      and counts["K4a"] == 2 and counts["K4b"] == 0,
                      f"trial {i} at B={b}: {counts}")
            print(f"cli: sweep trial {i} (data.batch_size={b}): {seconds:.1f} "
                  f"s (model init and the first steps included), "
                  f"epoch_time_s {m['epoch_time_s']:.3f}, pairs_per_sec "
                  f"{m['pairs_per_sec']:.1f}, train/loss "
                  f"{m['train/loss']:.6f}, val/loss {m['val/loss']:.6f}; "
                  f"launches {counts} on {card}", flush=True)
        best = {k: v for k, v in metrics.items() if k.startswith("best/")}
        check(math.isfinite(metrics["val/loss"]) and sorted(best) == sorted(
            f"best/{k}" for k in hs.params), f"sweep result {metrics}")
        print(f"cli: sweep best val/loss {metrics['val/loss']:.6f} with "
              f"{json.dumps(best)}", flush=True)

        # 2. one trial as its own process, its metrics back through
        # MEDMOE_METRICS_OUT (its launches are that process's)
        here = os.path.dirname(os.path.abspath(__file__))
        saved = os.environ.get("PYTHONPATH")
        os.environ["PYTHONPATH"] = here + (os.pathsep + saved if saved
                                           else "")
        t0 = time.perf_counter()
        try:
            sub = tcli.main(CLI_SWEEP + [
                f"paths.root_dir={os.path.join(work, 'sub')}",
                "hparams_search.launcher=subprocess",
                "hparams_search.n_trials=1"])
        finally:
            if saved is None:
                os.environ.pop("PYTHONPATH")
            else:
                os.environ["PYTHONPATH"] = saved
        check(math.isfinite(sub["val/loss"]) and len(
            [k for k in sub if k.startswith("best/")]) == 3,
            f"subprocess sweep {sub}")
        print(f"cli: a subprocess trial (python -m medmoe_torch.cli.train): "
              f"{time.perf_counter() - t0:.1f} s, val/loss "
              f"{sub['val/loss']:.6f} through MEDMOE_METRICS_OUT", flush=True)

        # 3. --multirun of 2 jobs, each one step
        reset_launch_counts()
        t0 = time.perf_counter()
        multi = tcli.main(["-m"] + CLI_OVERRIDES + [
            "model.loss.temp3=5,10", "trainer.limit_train_batches=1",
            "trainer.accumulate_grad_batches=1", "trainer.limit_val_batches=0",
            "data.num_samples=256", "callbacks=none", "logger=csv",
            f"paths.root_dir={os.path.join(work, 'multi')}"])
        counts = launch_counts()
        add(counts)
        check(multi["multirun/n_jobs"] == 2 and multi["multirun/n_failed"] == 0
              and all(math.isfinite(multi[f"job{i}/train/loss"])
                      for i in (0, 1)), f"multirun {multi}")
        check(counts["K1"] == counts["K2"] == counts["K3"] == 2,
              f"multirun launches {counts}")
        print(f"cli: --multirun model.loss.temp3=5,10: 2 jobs, 0 failed, "
              f"train/loss {multi['job0/train/loss']:.6f} / "
              f"{multi['job1/train/loss']:.6f}; "
              f"{time.perf_counter() - t0:.1f} s; launches {counts}",
              flush=True)

        # 4. debug=profiler with every logger, wandb with log_model
        saves = []
        real_save = tcb.save_checkpoint

        def recording_save(path, state, extra=None, blocking=True):
            saves.append((os.path.basename(path), blocking))
            return real_save(path, state, extra=extra, blocking=blocking)

        tcb.save_checkpoint = recording_save
        try:
            cfg, metrics, objs, counts, _, seconds, _ = drive_train(
                torch, CLI_OVERRIDES + [
                    "debug=profiler", "trainer.limit_train_batches=3",
                    "trainer.limit_val_batches=1", "data.num_samples=768",
                    "logger=many_loggers",
                    "+logger.wandb._target_="
                    "medmoe_torch.utils.loggers.WandbLogger",
                    "+logger.wandb.save_dir=${paths.output_dir}",
                    "+logger.wandb.log_model=true",
                    "+logger.mlflow._target_="
                    "medmoe_torch.utils.loggers.MLFlowLogger",
                    "+logger.mlflow.save_dir=${paths.output_dir}"],
                os.path.join(work, "profiler"))
        finally:
            tcb.save_checkpoint = real_save
        add(counts)
        trainer, module = objs["trainer"], objs["module"]
        out = cfg.paths.output_dir
        check(cfg.trainer.profiler == "torch" and trainer.state.step == 1
              and math.isfinite(metrics["train/loss"]),
              f"debug=profiler: step {trainer.state.step}, {metrics}")
        check(counts["K1"] == 4 and counts["K2"] == 3 and counts["K3"] == 4
              and counts["prologue"] == counts["K4a"] == 3,
              f"debug=profiler launches {counts} (3 micro-batches, 1 val)")
        trace = os.path.join(cfg.trainer.default_root_dir, "profile",
                             "trace_rank0.json")
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        found = {k: sum(n.startswith(k) for n in kernels)
                 for k in K1_KERNELS + K2_KERNELS}
        check(found["fwd_logit_kernel"] >= 3 and found["bwd_row_kernel"] >= 3,
              f"the trace's K1/K2 kernels: {found}")
        check(saves == [("epoch_000", True), ("last", True)],
              f"checkpoint saves (path, blocking): {saves}")
        check(os.path.isfile(os.path.join(out, "csv", "metrics.csv")),
              "no metrics.csv")
        jsonl = {}
        for sdk, name in (("wandb", "wandb_fallback.jsonl"),
                          ("mlflow", "mlflow_fallback.jsonl")):
            present = importlib.util.find_spec(sdk) is not None
            path = os.path.join(out, name)
            check(present or os.path.isfile(path), f"no {name}")
            jsonl[sdk] = "SDK present" if present else [
                json.loads(line).get("event", "metrics")
                for line in open(path)]
        check("SDK present" == jsonl["wandb"]
              or jsonl["wandb"].count("checkpoint") == 2,
              f"wandb fallback records {jsonl['wandb']}")
        events_tb = [n for _, _, names in os.walk(os.path.join(
            out, "tensorboard")) for n in names
            if n.startswith("events.out.tfevents")]
        print(f"cli: debug=profiler (detect_anomaly on, as debug/default "
              f"sets): 1 optimizer step of 3 x 256 in {seconds:.1f} s (init "
              f"included); trace {os.path.getsize(trace) / 1e6:.1f} MB, "
              f"{len(kernels)} kernel events, K1/K2 kernels {found}; "
              f"checkpoint saves {saves} (blocking: wandb log_model reads "
              f"them); JSONL {jsonl}; TensorBoard event files "
              f"{len(events_tb)} (tensorboard "
              f"{'present' if importlib.util.find_spec('tensorboard') else 'absent'}); "
              f"launches {counts}", flush=True)
        from torch.profiler import ProfilerActivity, profile

        batch = trainer.to_device(next(iter(
            objs["datamodule"].train_dataloader(1))))
        plain = warm_step_ms(torch, trainer, module, batch, 2)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            profiled = warm_step_ms(torch, trainer, module, batch, 2)
        plain2 = warm_step_ms(torch, trainer, module, batch, 2)
        print(f"cli: warm pretraining_medmoe step of 256 (mean of 2): "
              f"{plain:.3f} ms, {profiled:.3f} ms under torch.profiler "
              f"(CPU + CUDA), {plain2:.3f} ms again without "
              f"({profiled / min(plain, plain2) - 1:+.1%}) on {card}",
              flush=True)
        del objs, trainer, module, batch
        torch.cuda.empty_cache()

        # 5. the C++ decode helper against PIL, on shards written here
        t0 = time.perf_counter()
        train_urls, val_url, _ = write_disk_data(os.path.join(work, "disk"))
        print(f"cli: wrote 6 + 1 shards of {DISK_SHARD} JPEG pairs in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        missing = native_probe()
        over = disk_overrides(train_urls, val_url, 1)
        workers = compose("train", over).data.num_workers
        loader = os.path.join(work, "loader")
        if missing:
            from medmoe_torch.data.datamodules import UnimedDataModule

            raised = ""
            try:
                UnimedDataModule(train_data_paths=train_urls, use_native=True)
            except RuntimeError as e:
                raised = str(e)
            check("g++" in raised, f"use_native=true without the helper "
                  f"({missing}) raised {raised!r}")
            pil = [loader_pairs_s(compose("train", over + [
                f"paths.root_dir={loader}"]), epoch, 12) for epoch in (0, 1)]
            print(f"cli: native decode NOT run on this machine ({missing}); "
                  f"data.use_native=true raises: {raised.splitlines()[0]}; "
                  f"the Unimed loader alone with PIL, 12 batches of 32 (256 "
                  f"x 320 JPEGs to 224², {workers} decode threads): {pil} "
                  f"pairs/s", flush=True)
            return total
        t0 = time.perf_counter()
        native.build()
        print(f"cli: built {os.path.basename(native.library_path())} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        rates = {"pil": [], "native": []}
        for epoch, kind in enumerate(("pil", "native", "native", "pil")):
            cfg = compose("train", over + [
                f"data.use_native={kind == 'native'}",
                f"paths.root_dir={loader}"])
            rates[kind].append(loader_pairs_s(cfg, epoch, 12))
        print(f"cli: the Unimed loader alone, 12 batches of 32 (256 x 320 "
              f"JPEGs to 224², {workers} decode threads), pairs/s: PIL "
              f"{rates['pil']}, native {rates['native']} (order PIL, native, "
              f"native, PIL); native / PIL "
              f"{sum(rates['native']) / sum(rates['pil']):.2f}x", flush=True)
        cfg, metrics, objs, counts, _, seconds, _ = drive_train(
            torch, over + ["data.use_native=true"],
            os.path.join(work, "native_train"))
        add(counts)
        check(objs["datamodule"].use_native and objs["trainer"].state.step == 2
              and math.isfinite(metrics["train/loss"])
              and counts["K2"] == 4, f"native training: "
              f"{objs['trainer'].state.step} steps, {metrics}, {counts}")
        print(f"cli: pretraining_medmoe_ddp with data.use_native=true: 2 "
              f"steps (4 x 32) in {seconds:.1f} s (init included), "
              f"{metrics['pairs_per_sec']:.1f} pairs/s, loader wait "
              f"{100 * metrics['loader_wait_share']:.1f}%, train/loss "
              f"{metrics['train/loss']:.6f}; launches {counts} on {card}",
              flush=True)
        del objs
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return total



def kernel_name(mangled: str) -> str:
    """``_Z13dctx_z_kernelILi1EEv...`` → ``dctx_z_kernel<1>``, and
    ``_Z14sim_wei_kernelILb0EEv...`` → ``sim_wei_kernel<0>``."""
    import re

    m = re.match(r"_Z(\d+)", mangled)
    if not m:
        return mangled
    n = int(m.group(1))
    name = mangled[m.end():m.end() + n]
    tmpl = re.match(r"IL[ib](\d+)EE", mangled[m.end() + n:])
    return f"{name}<{tmpl.group(1)}>" if tmpl else name


def ptxas_summary(log: str) -> list:
    """One line a kernel from nvcc's ``-Xptxas -v`` log: registers, spill
    stores and loads, and any error."""
    import re

    rows, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?(\w+)'?", line)
        if m:
            fn = kernel_name(m.group(1))
            rows.setdefault(fn, {})
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill and fn:
            rows[fn]["spills"] = f"{spill.group(1)}/{spill.group(2)} bytes " \
                                 "spill stores/loads"
        used = re.search(r"Used (\d+) registers", line)
        if used and fn:
            rows[fn]["regs"] = f"{used.group(1)} registers"
    out = [f"{fn}: " + ", ".join(v[k] for k in ("regs", "spills") if k in v)
           for fn, v in rows.items() if v]
    return out + [line.strip() for line in log.splitlines()
                  if "error" in line or "warning" in line]


# the kernels on the wgmma core, by library: every instantiation must be
# found in the SASS
WGMMA_KERNELS = {
    "gloria_attention": {"sim_e_kernel<1>", "sim_e_kernel<2>",
                         "sim_e_kernel<3>", "sim_e_kernel<4>",
                         "sim_wei_kernel<0>", "sim_wei_kernel<1>"},
    "gloria_attention_bwd": {"dctx_z_kernel<1>", "dctx_z_kernel<2>",
                             "dctx_z_kernel<3>", "dctx_z_kernel<4>",
                             "dctx_gemm_kernel", "dwords_gemm_kernel"},
    "expert_fusion": {"fwd_proj_kernel", "fwd_logit_kernel"},
    "expert_fusion_bwd": {"bwd_proj_kernel", "bwd_act_kernel", "bwd_du_kernel",
                          "bwd_dx_kernel", "bwd_wgrad_kernel"},
}


def check_wgmma_sass(_build) -> None:
    """The wgmma-core kernels in the built libraries' SASS (cuobjdump): K3's
    and the prologue's F1 and F2 (``sim_e_kernel<1..4>``,
    ``sim_wei_kernel<0,1>``), K4a's two passes, K4b's product, K1's
    projection and logit product, and K2's projection and five products
    (its logit product, d_u, d_x and the weight gradients); each must hold
    wgmma (HGMMA) and TMA loads (UTMALDG) and no mma.sync (HMMA). Prints
    each one's counts with its local-memory stores and loads (STL/LDL)."""
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        print(f"sass: {tool} not found: the wgmma kernels' instructions not "
              "checked", flush=True)
        return
    for lib, names in WGMMA_KERNELS.items():
        sass = subprocess.run([tool, "-sass", _build.library_path(lib)],
                              capture_output=True, text=True,
                              timeout=300).stdout
        seen = set()
        for part in sass.split("Function : ")[1:]:
            name = kernel_name(part.split()[0])
            if name not in names:
                continue
            ops = {op: len([ln for ln in part.splitlines()
                            if f" {op}" in ln and "/*" in ln])
                   for op in ("HGMMA", "UTMALDG", "HMMA", "STL", "LDL")}
            print(f"sass {name}: "
                  + ", ".join(f"{k} {v}" for k, v in ops.items()), flush=True)
            check(ops["HGMMA"] > 0 and ops["UTMALDG"] > 0 and ops["HMMA"] == 0,
                  f"{name} is not a wgmma + TMA kernel: {ops}")
            seen.add(name)
        check(seen == names, f"{lib}: wgmma kernels not found in the SASS: "
              f"{sorted(names - seen)}")


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
        for line in ptxas_summary(log):
            print(f"build {name}: {line}", flush=True)
    check_wgmma_sass(_build)

    if "--only" in sys.argv:         # a quick look at some of the phases
        only = sys.argv[sys.argv.index("--only") + 1].split(",")
        for name in only:
            {"gloria": lambda: phase_gloria(torch, ga, card),
             "gloria_wide": lambda: phase_gloria_wide(torch, ga, card),
             "gloria_rect": lambda: phase_gloria_rect(torch, ga, card),
             "moe_modes": lambda: phase_moe_modes(torch, ef, card),
             "ddp": lambda: phase_ddp(torch, card),
             "ep": lambda: phase_ep(torch, card),
             "soft": lambda: phase_soft(torch, card),
             "cnn": lambda: phase_cnn(torch, card),
             "cli": lambda: phase_cli(torch, card)}[name]()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

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
    rect = phase_gloria_rect(torch, ga, card)
    moe = phase_moe_modes(torch, ef, card)
    ddp = phase_ddp(torch, card)
    ep = phase_ep(torch, card)
    soft = phase_soft(torch, card)
    cnn = phase_cnn(torch, card)
    cli = phase_cli(torch, card)
    print(f"main paths: serving {img_s:.1f} img/s with K1 launched "
          f"{serve_launches} times; pretraining_medmoe_ddp training "
          f"{pairs_s:.1f} pairs/s with K1 launched {k1_train} and K2 "
          f"{k2_train} times; gloria256 launches {g256}; text training "
          f"launches {text}; disk train, resume and serve launches {disk}; "
          f"eval, classification and export launches {ev}; MoE-mode "
          f"training launches {moe}; data-parallel launches (one process, "
          f"both ranks, the NCCL rank) {ddp}; expert-parallel launches (one "
          f"process of topk and of gather, both ranks of ep and of gather) "
          f"{ep}; soft-label and hard-negative launches {soft}; CNN "
          f"fine-tuning and FLAVA launches {cnn} (none); CLI launches (the "
          f"sweep, the multirun, debug=profiler, native-decode training) "
          f"{cli}", flush=True)
    # K1 and K2 run in every phase that drives the model
    k1_all = serve_launches + k1_train + g256["K1"] + text["K1"] \
        + disk["K1"] + ev["K1"] + moe["K1"] + ddp["K1"] + ep["K1"] \
        + soft["K1"] + cli["K1"]
    k2_all = k2_train + g256["K2"] + text["K2"] + disk["K2"] + ev["K2"] \
        + moe["K2"] + ddp["K2"] + ep["K2"] + soft["K2"] + cli["K2"]
    gl_all = {k: g256[k] + text[k] + moe[k] + ddp[k] + ep[k] + soft[k]
              + cli[k] for k in ("K3", "prologue", "K4a", "K4b")}

    def row(name, source, replaces, launches, r, **extra):
        extra.update({k: r[k] for k in (
            "sim_e_kernel_ms", "sim_wei_kernel_ms", "sim_finish_kernel_ms",
            "prologue_sim_e_kernel_ms", "prologue_sim_wei_kernel_ms",
            "prologue_sim_finish_kernel_ms", "k4a_only_ms",
            "dctx_z_kernel_ms", "dctx_gemm_kernel_ms", "both_ms",
            "dwords_wei_kernel_ms", "dwords_gemm_kernel_ms",
            "dwords_sum_kernel_ms", "matmul_yardstick_ms",
            "fwd_proj_kernel_ms", "bwd_proj_kernel_ms", "proj_yardstick_ms",
            "prologue_ms", "prologue_bound_ms", "ms_b256", "bound_ms_b256",
            "recompute_ms", "recompute_prologue_ms", "recompute_both_ms",
            "recompute_sim_e_kernel_ms", "recompute_sim_wei_kernel_ms",
            "recompute_sim_finish_kernel_ms",
            "recompute_prologue_sim_e_kernel_ms",
            "recompute_prologue_sim_wei_kernel_ms",
            "recompute_prologue_sim_finish_kernel_ms")
            if k in r})
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
            gl_all["K3"], gl["K3"],
            functions=[k.split()[-1] for k in K3_KERNELS], **rect["K3"]),
        row("gloria_similarity_backward d_ctx", f"{gsrc}_bwd.cu",
            f"{gtpu}:242", gl_all["K4a"], gl["K4a"],
            prologue_launches=gl_all["prologue"], **rect["K4a"]),
        row("gloria_similarity_backward d_words", f"{gsrc}_bwd.cu",
            f"{gtpu}:274", gl_all["K4b"], gl["K4b"],
            functions=list(K4B_KERNELS),
            prologue_launches=text["prologue"] + soft["K4b"],
            **rect["K4b"])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(ddp_rank_main() if "--ddp-rank" in sys.argv
             else ep_rank_main() if "--ep-rank" in sys.argv else main())
