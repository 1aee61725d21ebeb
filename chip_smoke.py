#!/usr/bin/env python3
"""Drive the PyTorch port (medmoe_torch) on one NVIDIA card, end to end.

    python3 chip_smoke.py            # from the root of a checkout

  1. prints the card's name and power limit (nvidia-smi) and whether
     PyYAML and PIL are installed (this script needs neither);
  2. builds every CUDA kernel from medmoe_torch/csrc, one nvcc each, all
     started together, and prints the build time and ptxas resources;
  3. K1, the fused expert branch: holds the kernel against its plain
     PyTorch version on the card at B=32 flagship shapes (bf16, every
     expert used) and on small odd shapes, and times both with CUDA events;
  4. serving: the full-width MedMoE (Swin-T + 6-expert gather MoE +
     BERT-base, bf16, seeded random weights) encodes the CheXpert class
     prompts and serves waves of 32 synthetic uint8 images through the
     serve CLI's wave loop; checks the records, that the kernel ran once
     per wave, and that the embeddings match the plain expert path;
  5. prints {"kernels": [...]} and, last, the device line.

Any failed check exits non-zero. Needs one CUDA card; fails without one.
``--profile`` adds a torch.profiler breakdown of one serving wave.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import math
import os
import subprocess
import sys
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


def phase_k1(torch, ef):
    # rtol/atol of the JAX package's own fused-vs-XLA test
    # (tests/test_pallas_expert.py): both sides round at the same bf16
    # points, and a different f32 summation order can flip one bf16 ulp
    # (2^-8 relative) in h, u or a
    rtol, atol = 2e-2, 2e-3
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
        check(out.shape == ref.shape, f"K1 {name}: shape {tuple(out.shape)} "
              f"vs {tuple(ref.shape)}")
        check(bool(torch.isfinite(out).all()), f"K1 {name}: non-finite output")
        err = (out - ref).abs().max().item()
        ok = torch.allclose(out, ref, rtol=rtol, atol=atol)
        print(f"K1 {name}: max_abs_err {err:.3e} (rtol {rtol}, atol {atol}) "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        check(ok, f"K1 {name}: kernel disagrees with its plain version")
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
        del args, out, ref
        torch.cuda.empty_cache()
    return result


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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        embed(images).cpu()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only (kernels, copies), so no time counts twice
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                  key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    k1_ms = sum(dev_us(e) for e in rows
                if e.key.startswith(("proj_kernel", "attn_kernel"))) / 1e3
    print(f"profile: one wave: device busy {busy_ms:.3f} ms of a "
          f"{wave_ms:.3f} ms unprofiled wave (idle "
          f"{max(0.0, 1 - busy_ms / wave_ms):.1%}); expert-fusion kernels "
          f"{k1_ms:.3f} ms ({k1_ms / max(busy_ms, 1e-9):.1%} of device time)",
          flush=True)
    for e in rows[:20]:
        print(f"profile: {dev_us(e) / 1e3:9.3f} ms {e.count:5d}x "
              f"{e.key[:100]}", flush=True)


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

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs)}",
          flush=True)
    for name, (sec, log) in logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line or "error" in line:
                print(f"build {name}: {line.strip()}", flush=True)

    k1 = phase_k1(torch, ef)
    launches, img_s = phase_serve(torch, ef, card, *full_width_config())

    print(json.dumps({"kernels": [{
        "name": "expert_fusion_gather", "route": "cuda",
        "source": "medmoe_torch/csrc/expert_fusion.cu",
        "replaces": "medmoe_tpu/ops/pallas/expert_fusion.py:113",
        "launches": launches, "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
