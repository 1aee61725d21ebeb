"""Entry "train": the port's optimizer step,
``medmoe_torch.train.step.build_train_step(module, accum)``, on the
configuration's ``MedMoEPretrainingModule``.

Set-up builds the module on the device, fills its weights from the seed,
points its training-mode noise at a seeded generator, makes the pool of
micro-batches, and drives the step through its first ``check_steps``
steps on the pool's first steps (they warm up every shape the window
runs). Their losses, the first gradient (read from Adam's first moment)
and the parameters' change are kept for the check. The window then runs
whole optimizer steps over the pool, back to back, until ``--seconds``
have passed, and ends in a device sync: ``train_pairs_per_s`` is every
pair of those steps over the window's time. With ``--trace 1`` one more
step runs under the profiler. Once the program is freed the reference
follows the same first steps.
"""

from __future__ import annotations

import gc
import math
import sys
import time

import torch

from benchmark import compare, traffic, weights
from benchmark.harness import Cell, Outcome, Spans, overrides
from benchmark.trace import profile

SPANS = ("make_batch", "train_step")


def _launches():
    from medmoe_torch.ops import expert_fusion as ef
    from medmoe_torch.ops import gloria_attention as ga

    return {"K1": ef.LAUNCHES, "K2": ef.BWD_LAUNCHES, "K3": ga.LAUNCHES,
            "prologue": ga.PROLOGUE_LAUNCHES, "K4a": ga.DCTX_LAUNCHES,
            "K4b": ga.DWORDS_LAUNCHES}


def build(cell: Cell):
    """(module, state, step, pool) of the program, on the cell's device."""
    from medmoe_torch.config import compose
    from medmoe_torch.models.layers import set_generator
    from medmoe_torch.train.state import TrainState
    from medmoe_torch.train.step import build_train_step
    from medmoe_torch.utils.instantiate import instantiate

    cfg = compose("train", overrides(cell.config))
    dev = cell.device
    with torch.device(dev):
        module = instantiate(cfg.model)
    module.model.to(dev)
    weights.fill(module.model.named_parameters(),
                 traffic.sub_seed(cell.seed, 0))
    b = int(cell.traffic["micro_batch"])
    if dev.type == "cuda":
        module.check_kernel_limits(b)
    set_generator(module.model, torch.Generator(device=dev).manual_seed(
        traffic.sub_seed(cell.seed, 2)))
    tx = module.make_optimizer(
        gradient_clip_val=float(cell.config["optimizer"]["clip"]))
    state = TrainState.create(module.model, tx)
    accum = int(cell.config["accumulate_grad_batches"])
    step = build_train_step(module, accum)
    model_cfg = cell.config["model"]
    pool = traffic.train_pool(cell.traffic, accum,
                              int(model_cfg["text"]["max_length"]),
                              int(model_cfg["vision"]["image_size"]),
                              cell.seed, dev)
    return module, state, step, pool


def first_steps(module, state, step, pool, n: int) -> dict:
    """Drive ``step`` through the pool's first ``n`` steps: each step's
    loss and each micro-batch's (read from the module's ``loss_fn`` as the
    step calls it), each micro-batch's expert ids (read from the program's
    ``topk_routing``), the first step's clipped gradient a leaf (Adam's
    first moment after one step over 1 − β1) and every leaf's change after
    the n."""
    names = {p: name for name, p in module.model.named_parameters()}
    start = {name: p.detach().clone()
             for name, p in module.model.named_parameters()}
    from medmoe_torch.models import moe

    b1 = module.make_optimizer().b1
    out = {"loss": [], "micro_loss": [], "grad1": {}, "routes": []}
    loss_fn = module.loss_fn
    routing = moe.topk_routing

    def recorded(batch):
        loss, metrics = loss_fn(batch)
        out["micro_loss"].append(metrics["loss"])
        return loss, metrics

    def routed(probs, k):
        idx, w = routing(probs, k)
        out["routes"].append(idx.detach().clone())
        return idx, w

    module.loss_fn = recorded
    moe.topk_routing = routed
    try:
        for i in range(n):
            state, metrics = step(state, pool[i % len(pool)])
            out["loss"].append(float(metrics["loss"]))
            if i == 0:
                for p in state.params:
                    st = state.optimizer.state.get(p, {})
                    g = st["exp_avg"] / (1 - b1) if "exp_avg" in st else \
                        torch.zeros_like(p)
                    out["grad1"][names[p]] = float(torch.linalg.vector_norm(g))
    finally:
        del module.loss_fn
        moe.topk_routing = routing
    out["micro_loss"] = [float(x) for x in out["micro_loss"]]
    out["change"] = {name: float(torch.linalg.vector_norm(p.detach()
                                                          - start[name]))
                     for name, p in module.model.named_parameters()}
    return out


def reference_readings(cell: Cell, low=None, routes=None) -> dict:
    """The reference's readings of the same first steps, with float32
    products (TF32 off) or, as the control, float8 ones. Where the
    configuration's ``compare.train`` sets ``route_tie``, the reference
    takes ``routes`` (another side's expert ids) where its router ties."""
    from benchmark.reference.model import MedMoE
    from benchmark.reference.train import follow

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = cell.device
    model_cfg = dict(cell.config["model"])
    with torch.device(dev):
        model = MedMoE(model_cfg, low)
    model.to(dev)
    weights.fill(model.named_parameters(), traffic.sub_seed(cell.seed, 0))
    if cell.config["model"]["text"].get("freeze_bert", False):
        model.text_encoder.bert.requires_grad_(False)
    accum = int(cell.config["accumulate_grad_batches"])
    pool = traffic.train_pool(cell.traffic, accum,
                              int(model_cfg["text"]["max_length"]),
                              int(model_cfg["vision"]["image_size"]),
                              cell.seed, dev)
    n = int(cell.traffic["check_steps"])
    gen = torch.Generator(device=dev).manual_seed(
        traffic.sub_seed(cell.seed, 2))
    tie = cell.config["compare"]["train"].get("route_tie")
    out = follow(model, [pool[i % len(pool)] for i in range(n)],
                 cell.config["loss"], float(cell.config["optimizer"]["lr"]),
                 float(cell.config["optimizer"]["clip"]), gen,
                 routes=routes if tie is not None else None,
                 tie=tie or 0.0)
    del model, pool
    return out


def run(cell: Cell) -> Outcome:
    on_cuda = cell.device.type == "cuda"
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    spans = Spans()
    marks = {"imported": time.time() - cell.t_start}
    module, state, step, pool = build(cell)
    sync()
    marks["built"] = time.time() - cell.t_start
    prog = first_steps(module, state, step, pool,
                       int(cell.traffic["check_steps"]))
    sync()
    setup_s = time.time() - cell.t_start
    print(f"benchmark: set-up {setup_s:.3f} s; first losses {prog['loss']}",
          file=sys.stderr, flush=True)

    b = int(cell.traffic["micro_batch"])
    accum = int(cell.config["accumulate_grad_batches"])
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    losses = []
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < cell.seconds:
        with spans.span("make_batch"):
            micro = pool[n % len(pool)]
        with spans.span("train_step"):
            state, metrics = step(state, micro)
        losses.append(metrics["loss"])
        n += 1
    sync()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    failed = accum * sum(1 for x in losses if not math.isfinite(float(x)))
    trace = None
    if cell.trace and on_cuda:
        def one_step():
            with spans.span("make_batch"):
                micro = pool[n % len(pool)]
            with spans.span("train_step"):
                step(state, micro)
        trace = profile(one_step, SPANS)
    profiled = pool[n % len(pool)]
    cap_lens = [mb["cap_lens"].tolist() for mb in profiled]
    tokens = [mb["attention_mask"].sum(1).tolist() for mb in profiled]
    notes = {"launches": _launches() if on_cuda else {},
             "steps": n, "window_s": window_s, "setup_marks": marks}
    del module, state, step, pool, profiled, micro, metrics, losses
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = reference_readings(cell, routes=prog["routes"])
    notes["reference_s"] = time.perf_counter() - t_ref
    numbers = compare.train_numbers(prog, ref,
                                    cell.config["compare"]["train"])
    rate = n * accum * b / window_s
    work = {"kind": "train", "model": cell.config["model"],
            "micro_batch": b, "profiled_cap_lens": cap_lens,
            "profiled_tokens": tokens,
            "step_s": window_s / max(n, 1), "peak_bytes": peak}
    return Outcome(attempted=n * accum, failed=failed,
                   metrics={"train_pairs_per_s": (rate, "pairs/s"),
                            "setup_s": (setup_s, "s")},
                   memory_peak_bytes=int(peak), compare=numbers, trace=trace,
                   work=work, notes=notes)
