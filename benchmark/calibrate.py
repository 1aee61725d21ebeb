"""Readings that the limits of ``correct`` are set from (run on the card):

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--control fp8,int8] [--faults half]
    python3 benchmark/calibrate.py --config <name> --traffic <name> ...

For each seed, in one process: the program's numbers against the
reference (the lower readings), and on the control seeds the control's,
the reference computed with float8 (or int8) products in the program's
place (the upper readings). ``--faults`` plants faults under the timed path
(``benchmark/faults.py``) and reads each against the same reference. A
configuration and traffic mix that no cell names yet are read with
``--config`` and ``--traffic``. Serving also prints the largest gap between
the program's and the reference's router probabilities, which
``route_tie`` must exceed, and the share of images that have more than one
tied route. One JSON line a reading.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import compare, faults, harness, traffic  # noqa: E402


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def train_seed(cell, controls, planted):
    from benchmark.entries import train as T

    def program():
        module, state, step, pool = T.build(cell)
        out = T.first_steps(module, state, step, pool,
                            int(cell.traffic["check_steps"]))
        del module, state, step, pool
        _free()
        return out

    prog = program()
    broken = {}
    for f in planted:
        with faults.planted("train", f):
            broken[f] = program()
    lim = cell.config["compare"]["train"]
    ref = T.reference_readings(cell, routes=prog["routes"])
    _free()
    rows = [("program", compare.train_numbers(prog, ref, lim))]
    print(json.dumps({"seed": cell.seed, "worst_leaves":
                      compare.worst_leaves(prog, ref)}), flush=True)
    for f, p in broken.items():
        if compare.routes_followed(lim):
            ref_f = T.reference_readings(cell, routes=p["routes"])
            _free()
        else:
            ref_f = ref
        rows.append((f, compare.train_numbers(p, ref_f, lim)))
    for low in controls:
        ctl = T.reference_readings(cell, low)
        _free()
        ref_c = ref
        if compare.routes_followed(lim):
            ref_c = T.reference_readings(cell, routes=ctl["routes"])
            _free()
        rows.append((f"control_{low}", compare.train_numbers(ctl, ref_c,
                                                             lim)))
        print(json.dumps({"seed": cell.seed, "control_worst_leaves":
                          compare.worst_leaves(ctl, ref_c)}), flush=True)
    return rows


def serve_seed(cell, controls, planted):
    from medmoe_torch.cli.serve import serve_waves

    from benchmark.entries import serve as S

    t = cell.traffic
    temp3 = float(cell.config["loss"]["temp3"])
    size = int(cell.config["model"]["vision"]["image_size"])
    pool = traffic.serve_pool(t, size, cell.seed, cell.device)

    def program(with_probs=False):
        model, embed, class_emb = S.build(cell)
        kept = []

        def capture(images):
            e = embed(images)
            kept.append(e.float().cpu())
            return e

        out = S.Records(harness.Spans())
        serve_waves(capture, S.waves(pool, len(pool), None, harness.Spans(),
                                     []),
                    "classify", t["class_names"], class_emb, temp3, out)
        recs = {r["path"]: r for r in map(json.loads, out.lines)
                if "error" not in r}
        probs = None
        if with_probs:
            with torch.no_grad():
                probs = torch.cat([
                    model.encode_image(torch.as_tensor(w).to(cell.device))[2]
                    .float().cpu() for w in pool])
        del model, embed
        _free()
        served = []
        for n, w in enumerate(pool):
            emb = kept[n] if n < len(kept) else torch.zeros(0)
            for i in range(len(w)):
                r = recs.get(f"w{n}/{i}")
                served.append({
                    "embedding": emb[i].tolist() if i < len(emb) else None,
                    "probs": None if r is None else r["probs"],
                    "label": None if r is None else r["label"]})
        return served, probs

    served, probs = program(with_probs=True)
    broken = {}
    for f in planted:
        with faults.planted("serve", f):
            broken[f] = program()[0]
    ref = S.reference_rows(cell, pool)
    extra = {"route_gap": _route_gap(cell, pool, probs),
             "route_tied": sum(len(c) > 1 for c in ref) / len(ref)}
    lim = cell.config["compare"]["serve"]
    rows = [("program", compare.serve_numbers(served, ref, lim, temp3))]
    rows += [(f, compare.serve_numbers(b, ref, lim, temp3))
             for f, b in broken.items()]
    for low in controls:
        ctl = S.reference_rows(cell, pool, low)
        as_served = [{"embedding": c[0]["embedding"], "probs": c[0]["probs"],
                      "label": max(c[0]["sims"], key=c[0]["sims"].get)}
                     for c in ctl]
        rows.append((f"control_{low}", compare.serve_numbers(
            as_served, ref, lim, temp3)))
    _free()
    return rows, extra


def _route_gap(cell, pool, prog_probs):
    """The largest gap between the program's router probabilities and the
    reference's, over the pool's images."""
    from benchmark.reference.model import MedMoE
    from benchmark import weights

    with torch.device(cell.device):
        model = MedMoE(cell.config["model"])
    model.to(cell.device).eval()
    weights.fill(model.named_parameters(), traffic.sub_seed(cell.seed, 0))
    with torch.no_grad():
        ref = torch.cat([model.image(torch.as_tensor(w[i:i + 64])
                                     .to(cell.device))[2].cpu()
                         for w in pool for i in range(0, len(w), 64)])
    del model
    _free()
    return float((ref - prog_probs).abs().max())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", help="a cell of BENCHMARK.json")
    ap.add_argument("--config", help="a configuration, by file name")
    ap.add_argument("--traffic", help="a traffic mix, by file name")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--control", default="fp8",
                    help="the control's precisions, e.g. fp8,int8")
    args = ap.parse_args()
    if args.workload:
        _, config, traffic_cfg = harness.cell_spec(harness.bench_spec(),
                                                   args.workload)
        name = args.workload
    else:
        config = harness.load_json(os.path.join(
            harness.HERE, "configs", f"{args.config}.json"))
        traffic_cfg = harness.load_json(os.path.join(
            harness.HERE, "traffic", f"{args.traffic}.json"))
        name = f"{args.config}/{args.traffic}"
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    planted = [f for f in args.faults.split(",") if f]
    for seed in seeds:
        t0 = time.time()
        cell = harness.Cell(name, seed, 0.0, False, 1, config,
                            traffic_cfg, torch.device("cuda", 0), t0)
        extra = {}
        lows = args.control.split(",") if seed in controls else []
        if traffic_cfg["entry"] == "train":
            rows = train_seed(cell, lows, planted)
        else:
            rows, extra = serve_seed(cell, lows, planted)
        for side, numbers in rows:
            print(json.dumps({"workload": name, "seed": seed, "side": side,
                              "numbers": {n: v for n, v, _ in numbers},
                              **extra, "s": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
