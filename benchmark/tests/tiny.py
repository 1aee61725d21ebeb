"""Tiny cells for the harness's CPU tests: the real configuration files
with every width cut, so that the port's plain CPU path and the reference
run in seconds."""

from __future__ import annotations

import copy
import time

import torch

from benchmark import harness


def tiny_config(name: str = "medmoe-gather6", dtype: str = "float32"):
    bench = harness.bench_spec()
    entry = {c["name"]: c for c in bench["configs"]}[name]
    cfg = copy.deepcopy(harness.load_json(f"{harness.ROOT}/{entry['file']}"))
    cfg["model"]["vision"].update(
        image_size=64, swin_window_size=2, swin_embed_dim=8,
        swin_depths=[1, 1, 2, 1], swin_num_heads=[1, 2, 2, 4], embed_dim=32,
        dtype=dtype)
    cfg["model"]["text"].update(hidden_size=32, num_layers=4, num_heads=2,
                                intermediate_size=64, max_length=10,
                                dtype=dtype)
    cfg["accumulate_grad_batches"] = 2
    return cfg


#: the top-2 capacity dispatch of ``experiment=moe_single_modality``
TOPK = {"num_experts": 4, "moe_mode": "topk", "router_top_k": 2,
        "capacity_factor": 1.5}


def tiny_cell(workload: str, seed: int = 2 ** 31 + 11, dtype: str = "float32",
              seconds: float = 0.3, moe=None) -> harness.Cell:
    """A cell of BENCHMARK.json at tiny widths; ``moe`` overrides the
    expert layer's settings (``TOPK``)."""
    bench = harness.bench_spec()
    w, _, tr = harness.cell_spec(bench, workload)
    cfg = tiny_config(w["config"], dtype)
    if moe:
        cfg["model"]["vision"].update(moe)
    tr = copy.deepcopy(tr)
    if tr["entry"] == "train":
        tr.update(micro_batch=8, caption_tokens={"min": 3, "max": 10})
        if moe:
            tr["label_classes"] = cfg["model"]["vision"]["num_experts"]
    else:
        tr.update(wave=8, pool_waves=3, sample_from=2, sample_waves=1,
                  traced_waves=2)
    return harness.Cell(workload, seed, seconds, False, 1, cfg, tr,
                        torch.device("cpu"), time.time())
