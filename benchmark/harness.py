"""The benchmark's driver: one run of one cell.

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` reads ``BENCHMARK.json``, finds the cell's configuration
(its ``file``) and traffic mix (``benchmark/traffic/<traffic>.json``),
runs the mix's entry (``benchmark/entries/<entry>.py``), and with
``--trace 1`` each per-layer metric's reader
(``benchmark/metrics/<name>.py``). It prints the compared numbers with
their limits as the last lines of standard error, and one JSON result as
the last line of standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROGRAM = "medmoe_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "medmoe_tpu")


@dataclass
class Cell:
    name: str
    seed: int
    seconds: float
    trace: bool
    chips: int
    config: dict
    traffic: dict
    device: object
    t_start: float


@dataclass
class Outcome:
    attempted: int
    failed: int
    metrics: Dict[str, float]
    memory_peak_bytes: int
    #: (name, value, limit): correct while every value is within its
    #: limit; a limit of None reports the number without comparing it
    compare: List[Tuple[str, float, Optional[float]]]
    trace: Optional[object] = None
    #: what the per-layer readers need beside the trace
    work: Dict[str, object] = field(default_factory=dict)
    #: printed on an earlier line of standard error
    notes: Dict[str, object] = field(default_factory=dict)


def load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def bench_spec() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell_spec(bench: dict, name: str) -> Tuple[dict, dict, dict]:
    """(workload entry, configuration file, traffic file) of a cell."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{', '.join(sorted(cells))}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(os.path.join(ROOT, cfg_entry["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
    return w, config, traffic


def traffic_names() -> List[str]:
    """Every traffic mix there is, by file name."""
    return sorted(n[:-5] for n in os.listdir(os.path.join(HERE, "traffic"))
                  if n.endswith(".json"))


def entry(kind: str):
    return importlib.import_module(f"benchmark.entries.{kind}")


def metric_reader(name: str):
    """The module ``benchmark/metrics/<name>.py`` (a name may hold dots)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def per_layer_names(bench: dict, cell: str) -> List[dict]:
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell])]


def overrides(config: dict) -> List[str]:
    """The configuration file as overrides of the port's config
    composition: its experiment, then every size it states."""
    out = [f"experiment={config['experiment']}"]
    groups = (("model.model.vision", config["model"]["vision"]),
              ("model.model.text", config["model"]["text"]),
              ("model.loss", config["loss"]))
    for prefix, values in groups:
        for k, v in values.items():
            text = v if isinstance(v, str) else \
                json.dumps(v).replace(" ", "")
            out.append(f"{prefix}.{k}={text}")
    out.append(f"model.optimizer.lr={config['optimizer']['lr']}")
    out.append(f"trainer.gradient_clip_val={config['optimizer']['clip']}")
    out.append("trainer.accumulate_grad_batches="
               f"{config['accumulate_grad_batches']}")
    return out


class Spans:
    """The benchmark's own spans (``torch.profiler.record_function``
    ranges) around its calls into the program; ``switch`` closes the open
    span and opens the next."""

    def __init__(self):
        self._open = None

    def switch(self, name: Optional[str]) -> None:
        import torch

        if self._open is not None:
            self._open.__exit__(None, None, None)
            self._open = None
        if name is not None:
            self._open = torch.profiler.record_function(name)
            self._open.__enter__()

    @contextlib.contextmanager
    def span(self, name: str):
        self.switch(name)
        try:
            yield
        finally:
            self.switch(None)


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def is_correct(compare) -> bool:
    return all(math.isfinite(v) and v <= lim for _, v, lim in compare
               if lim is not None)


def end_to_end_names(bench: dict, cell: str) -> List[str]:
    return [m["name"] for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]


def result_line(cell: Cell, out: Outcome, per_layer: Dict[str, Tuple[float,
                str]], device: dict, e2e: List[str]) -> dict:
    """The result; with ``--trace 0`` the cell's end-to-end metrics, each
    the entry's metric of the name before its first dot (a cell may take
    ``train_pairs_per_s.topk``, a bound of its own, for the entry's
    ``train_pairs_per_s``)."""
    bench_metrics = {}
    if cell.trace:
        for name, (value, unit) in per_layer.items():
            bench_metrics[name] = {"value": value, "unit": unit}
    else:
        for name in e2e:
            value, unit = out.metrics[name.split(".", 1)[0]]
            bench_metrics[name] = {"value": value, "unit": unit}
    res = {"correct": is_correct(out.compare), "attempted": out.attempted,
           "failed": out.failed, "metrics": bench_metrics, "device": device}
    if cell.trace and out.trace is not None:
        res["breakdown"] = out.trace.breakdown()
    res["compared"] = {n: {"value": v, "limit": lim}
                       for n, v, lim in out.compare if lim is not None}
    return res


def main(argv: List[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = bench_spec()
    w, config, traffic = cell_spec(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(w["chips"]):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {w['chips']} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    try:
        program = importlib.import_module(PROGRAM)
    except ImportError as exc:
        print(f"benchmark: the program {PROGRAM} is missing: {exc}",
              file=sys.stderr)
        return 2
    if not os.path.abspath(program.__file__).startswith(ROOT + os.sep):
        print(f"benchmark: {PROGRAM} comes from {program.__file__}, not from "
              f"this checkout", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    cell = Cell(args.workload, args.seed, args.seconds, bool(args.trace),
                int(w["chips"]), config, traffic, torch.device("cuda", 0),
                t_start)
    return finish(bench, cell, entry(traffic["entry"]).run(cell))


def finish(bench: dict, cell: Cell, out: Outcome) -> int:
    """Per-layer metrics, the check for JAX, and the result."""
    import torch

    per_layer: Dict[str, Tuple[float, str]] = {}
    if cell.trace:
        for m in per_layer_names(bench, cell.name):
            value = metric_reader(m["name"]).read(out.trace, out.work)
            if value is not None:
                per_layer[m["name"]] = (value, m["unit"])
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    on_cuda = getattr(cell.device, "type", "cpu") == "cuda"
    device = {"platform": "gpu" if on_cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_cuda else "cpu",
              "count": cell.chips,
              "memory_peak_bytes": out.memory_peak_bytes}
    if cell.trace and out.trace is not None:
        device["busy_s"] = out.trace.busy_s
        device["window_s"] = out.trace.window_s
    notes = dict(out.notes, uncompared={n: v for n, v, lim in out.compare
                                        if lim is None})
    print("benchmark: notes " + json.dumps(notes), file=sys.stderr)
    for name, value, limit in out.compare:
        if limit is not None:
            print(f"compare {name} {value!r} limit {limit!r}",
                  file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result_line(cell, out, per_layer, device,
                                 end_to_end_names(bench, cell.name))),
          flush=True)
    return 0
