"""One rank of the two-process tests of tests/test_torch_parallel.py. It
imports no JAX, so a rank starts in a few seconds.

    python -m tests.torch_rank_worker SPEC.json RANK

SPEC holds ``init`` (a ``file://`` store), ``world``, ``task`` and the
task's inputs; the rank writes its result to ``<out>.<rank>.json``. The
group's join and every collective have a deadline (``DEADLINE``, the train
CLI's own group deadline), so a rank that hangs fails instead of waiting on
the others; it is long because a test run with several workers can starve
a rank for minutes while its peer waits in a collective.

Tasks:

- ``gather``: ``gather_tensor`` of this rank's rows of ``x`` with each
  backprop type, the values and the gradient of Σ y·(w + rank);
- ``train``: the train CLI's ``main`` on ``overrides`` inside the group this
  worker opened, optionally sending itself SIGTERM after optimizer step
  ``sigterm_after`` when it is rank ``sigterm_rank``; with ``runs``
  (a list of override lists) one ``main`` after another in the same
  group, each rank saving its model's ``state_dict`` (its slice of an
  expert-parallel bank) to ``<out>.<rank>.<run>.pt``;
- ``flava``: ``FLAVAGlobalContrastiveLoss(axis_name="data")`` on this
  rank's rows of ``img`` and ``txt`` (global negatives over the group):
  the loss, this rank's logit rows, and the gradients of the loss to the
  rank's rows and to ``logit_scale``;
- ``regions``: the expert-region functions (``enter_experts``,
  ``leave_experts``, ``gather_experts``) over a group of all ranks: the
  values and the gradients of Σ y·(w + rank).
"""

import datetime
import json
import os
import signal
import sys

import numpy as np
import torch
import torch.distributed as dist

DEADLINE = datetime.timedelta(minutes=10)


def _gather(spec, rank):
    from medmoe_torch.parallel import collectives as C

    x_all = np.asarray(spec["x"], np.float32)
    w = np.asarray(spec["w"], np.float32) + rank
    n = x_all.shape[0] // spec["world"]
    out = {"rank": C.get_rank(), "world": C.get_world_size(),
           "any": C.any_rank(rank == 1, torch.device("cpu")),
           "mean": C.all_reduce_mean(torch.tensor([float(rank)])).item()}
    for kind in ("global", "local", "none"):
        x = torch.from_numpy(x_all[rank * n:(rank + 1) * n]).requires_grad_()
        y = C.gather_tensor(x, C.BackpropType.from_str(kind))
        if y.requires_grad:
            (y * torch.from_numpy(w)).sum().backward()
        grad = x.grad if x.grad is not None else torch.zeros_like(x)
        out[kind] = {"y": y.detach().tolist(), "grad": grad.tolist()}
    return out


def _flava(spec, rank):
    from medmoe_torch.ops.flava import FLAVAGlobalContrastiveLoss

    img_all = np.asarray(spec["img"], np.float32)
    txt_all = np.asarray(spec["txt"], np.float32)
    n = img_all.shape[0] // spec["world"]
    img = torch.from_numpy(img_all[rank * n:(rank + 1) * n]).requires_grad_()
    txt = torch.from_numpy(txt_all[rank * n:(rank + 1) * n]).requires_grad_()
    loss_fn = FLAVAGlobalContrastiveLoss(axis_name="data")
    out = loss_fn(img, txt)
    out.loss.backward()
    return {"loss": out.loss.item(),
            "image_logits": out.image_logits.detach().tolist(),
            "text_logits": out.text_logits.detach().tolist(),
            "d_img": img.grad.tolist(), "d_txt": txt.grad.tolist(),
            "d_scale": loss_fn.logit_scale.grad.item()}


def _regions(spec, rank):
    from medmoe_torch.parallel import collectives as C

    x_all = np.asarray(spec["x"], np.float32)
    n = x_all.shape[0] // spec["world"]
    out = {}
    for name, fn, rows in (
            ("enter", C.enter_experts, x_all),
            ("leave", C.leave_experts, x_all * (rank + 1)),
            ("gather", C.gather_experts, x_all[rank * n:(rank + 1) * n])):
        w = np.asarray(spec["w"], np.float32) \
            + (rank if name != "gather" else 0)
        x = torch.from_numpy(np.ascontiguousarray(rows)).requires_grad_()
        y = fn(x, None)
        (y * torch.from_numpy(w[:y.shape[0]])).sum().backward()
        out[name] = {"y": y.detach().tolist(), "grad": x.grad.tolist()}
    return out


def _train_runs(spec, rank):
    results = []
    for i, overrides in enumerate(spec["runs"]):
        res, module = _train(dict(spec, overrides=overrides), rank)
        torch.save(module.model.state_dict(), f"{spec['out']}.{rank}.{i}.pt")
        results.append(res)
    return results


def _train(spec, rank):
    from medmoe_torch.cli import train as cli
    from medmoe_torch.train import loop

    captured = {}
    real_train = cli.train

    def train(cfg):
        metrics, objs = real_train(cfg)
        captured.update(objs)
        return metrics, objs

    cli.train = train
    if spec.get("sigterm_rank") == rank:
        real_build = loop.build_train_step

        def build(module, accum_steps=1):
            step = real_build(module, accum_steps)

            def signalling(state, window):
                out = step(state, window)
                if state.step == spec["sigterm_after"]:
                    os.kill(os.getpid(), signal.SIGTERM)
                return out
            return signalling

        loop.build_train_step = build
    try:
        cli.main(spec["overrides"])
    finally:
        cli.train = real_train
    trainer = captured["trainer"]
    result = {"rank": rank, "world": dist.get_world_size(),
              "step": trainer.state.step, "interrupted": trainer.interrupted,
              "history": trainer.metrics_history}
    return result, captured["module"]


def main():
    spec_path, rank = sys.argv[1], int(sys.argv[2])
    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=spec["init"], rank=rank,
                            world_size=spec["world"],
                            timeout=DEADLINE)
    try:
        tasks = {"gather": _gather, "regions": _regions, "flava": _flava,
                 "train": lambda sp, r: _train(sp, r)[0],
                 "train_runs": _train_runs}
        result = tasks[spec["task"]](spec, rank)
    finally:
        dist.destroy_process_group()
    with open(f"{spec['out']}.{rank}.json", "w") as f:
        json.dump(result, f)


if __name__ == "__main__":
    main()
