"""Entry "serve": zero-shot classification of waves of images through the
port's serving loop, ``medmoe_torch.cli.serve.serve_waves`` with
``medmoe_torch.eval.zero_shot.make_image_embedder``.

Set-up builds the configuration's ``MedMoE`` on the device in eval mode,
fills its weights from the seed, encodes the class prompts
(``encode_class_prompts``), makes the pool of waves in host memory and
serves ``warmup_waves`` waves. The window is a closed loop: the next wave
is handed to ``serve_waves`` as soon as the previous one's records are
written (into memory), until ``--seconds`` have passed. A wave's latency
runs from its hand-off to the flush of its records. ``serve_img_per_s`` is
the images of every wave completed over the window's time. The check
compares the records (and the embeddings behind them) of ``sample_waves``
waves drawn from the seed, and of the last wave, with the reference.
"""

from __future__ import annotations

import gc
import json
import random
import statistics
import time
from typing import Dict, List

import torch

from benchmark import compare, traffic, weights
from benchmark.harness import Cell, Outcome, Spans, overrides
from benchmark.trace import profile

SPANS = ("make_batch", "serve_wave", "write_records")


class Records:
    """The JSON-lines sink ``serve_waves`` writes to: lines kept in memory,
    the time of each wave's flush, and the spans ``serve_wave`` (closed by
    a wave's first write) and ``write_records`` (closed by its flush)."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self.lines: List[str] = []
        self.flushed: List[float] = []
        self._writing = False

    def write(self, text: str) -> None:
        if not self._writing:
            self.spans.switch("write_records")
            self._writing = True
        self.lines.append(text)

    def flush(self) -> None:
        self.flushed.append(time.perf_counter())
        self.spans.switch(None)
        self._writing = False


def waves(pool, count, seconds, spans: Spans, handoffs: List[float],
          keep=None):
    """Hand off the pool's waves in turn, ``count`` of them or until
    ``seconds`` have passed since the first hand-off, noting each hand-off
    time (and into ``keep`` each wave's index in the pool). Paths name the
    served wave and the image: ``w<n>/<i>``."""
    t0 = time.perf_counter()
    n = 0
    while (count is None or n < count) and \
            (seconds is None or time.perf_counter() - t0 < seconds):
        spans.switch("make_batch")
        images = pool[n % len(pool)]
        paths = [f"w{n}/{i}" for i in range(len(images))]
        if keep is not None:
            keep.append(n % len(pool))
        spans.switch(None)
        handoffs.append(time.perf_counter())
        yield paths, images, []
        n += 1


def build(cell: Cell):
    from medmoe_torch.config import compose
    from medmoe_torch.data.tokenizer import WordPieceTokenizer
    from medmoe_torch.eval.zero_shot import (encode_class_prompts,
                                             make_image_embedder)
    from medmoe_torch.utils.instantiate import instantiate

    cfg = compose("train", overrides(cell.config))
    dev = cell.device
    with torch.device(dev):
        model = instantiate(cfg.model.model)
    model.to(dev).eval()
    weights.fill(model.named_parameters(), traffic.sub_seed(cell.seed, 0))
    tok = WordPieceTokenizer.from_vocab_file(traffic.VOCAB)
    t = cell.traffic
    class_emb = encode_class_prompts(
        model, tok, t["class_names"], t["prompt"],
        int(cell.config["model"]["text"]["max_length"])).cpu().numpy()
    return model, make_image_embedder(model), class_emb


def run(cell: Cell) -> Outcome:
    from medmoe_torch.cli.serve import serve_waves

    on_cuda = cell.device.type == "cuda"
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    spans = Spans()
    t = cell.traffic
    temp3 = float(cell.config["loss"]["temp3"])
    model, embed, class_emb = build(cell)
    size = int(cell.config["model"]["vision"]["image_size"])
    pool = traffic.serve_pool(t, size, cell.seed, cell.device)
    wave = int(t["wave"])
    rng = random.Random(traffic.sub_seed(cell.seed, 3))
    sampled = set(rng.sample(range(int(t["sample_from"])),
                             int(t["sample_waves"])))
    kept: Dict[object, torch.Tensor] = {}
    served = [0]

    def spanned(images):
        spans.switch("serve_wave")
        return embed(images)

    def timed_embed(images):
        emb = spanned(images)
        if served[0] in sampled:
            kept[served[0]] = emb
        kept["last"] = emb
        served[0] += 1
        return emb

    warm = Records(spans)
    serve_waves(embed, waves(pool, int(t["warmup_waves"]), None, spans, []),
                "classify", t["class_names"], class_emb, temp3, warm)
    sync()
    setup_s = time.time() - cell.t_start

    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    out = Records(spans)
    handoffs: List[float] = []
    order: List[int] = []
    t0 = time.perf_counter()
    serve_waves(timed_embed, waves(pool, None, cell.seconds, spans, handoffs,
                                   order),
                "classify", t["class_names"], class_emb, temp3, out)
    sync()
    window_s = out.flushed[-1] - t0
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    n_waves = len(out.flushed)
    lat = [(f - h) * 1e3 for h, f in zip(handoffs, out.flushed)]
    p95 = statistics.quantiles(lat, n=100)[94] if len(lat) > 1 else lat[0]
    trace = None
    if cell.trace and on_cuda:
        prof_out = Records(spans)
        n_prof = int(t["traced_waves"])
        trace = profile(lambda: serve_waves(
            spanned, waves(pool, n_prof, None, spans, []), "classify",
            t["class_names"], class_emb, temp3, prof_out), SPANS)
    notes = {"launches": _launches() if on_cuda else {}, "waves": n_waves,
             "window_s": window_s, "p50_ms": statistics.median(lat)}

    # the records and embeddings of the sampled waves and the last one
    last = n_waves - 1
    check = sorted({w for w in sampled if w < n_waves} | {last})
    by_wave: Dict[int, List[dict]] = {w: [] for w in check}
    answered = 0
    for line in out.lines:
        rec = json.loads(line)
        if "error" in rec:
            continue
        answered += 1
        w = int(rec["path"][1:].split("/")[0])
        if w in by_wave:
            by_wave[w].append(rec)
    served_rows = []
    for w in check:
        emb = kept.get(w if w != last else "last")
        recs = {r["path"]: r for r in by_wave[w]}
        emb = None if emb is None else emb.float().cpu()
        for i in range(wave):
            r = recs.get(f"w{w}/{i}")
            e = None if emb is None or i >= emb.shape[0] else emb[i].tolist()
            served_rows.append({"embedding": e,
                                "probs": None if r is None else r["probs"],
                                "label": None if r is None else r["label"]})
    pool_ids = [order[w] for w in check]
    del model, embed, kept, out
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref_rows = reference_rows(cell, [pool[i] for i in pool_ids])
    notes["reference_s"] = time.perf_counter() - t_ref
    notes["route_tied"] = sum(len(c) > 1 for c in ref_rows) / len(ref_rows)
    numbers = compare.serve_numbers(served_rows, ref_rows,
                                    cell.config["compare"]["serve"], temp3)
    work = {"kind": "serve", "model": cell.config["model"], "wave": wave,
            "images_per_s": n_waves * wave / window_s,
            "profiled_images": int(t["traced_waves"]) * wave}
    return Outcome(attempted=n_waves * wave,
                   failed=n_waves * wave - answered,
                   metrics={"serve_img_per_s": (n_waves * wave / window_s,
                                                "img/s"),
                            "serve_wave_p95_ms": (p95, "ms"),
                            "setup_s": (setup_s, "s")},
                   memory_peak_bytes=int(peak), compare=numbers, trace=trace,
                   work=work, notes=notes)


def _launches():
    from medmoe_torch.ops import expert_fusion as ef

    return {"K1": ef.LAUNCHES, "K2": ef.BWD_LAUNCHES}


def reference_rows(cell: Cell, images_list, low=None
                   ) -> List[List[dict]]:
    """Per image of ``images_list`` (host uint8 waves), the reference's
    embedding, class cosines and class distribution under each route it
    takes as tied (its own first)."""
    from benchmark.reference.model import MedMoE
    from benchmark.reference.serve import class_embeddings, image_routes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = cell.device
    t = cell.traffic
    with torch.device(dev):
        model = MedMoE(cell.config["model"], low)
    model.to(dev).eval()
    weights.fill(model.named_parameters(), traffic.sub_seed(cell.seed, 0))
    prompts = [t["prompt"].format(c) for c in t["class_names"]]
    cls = class_embeddings(model, prompts, traffic.read_vocab(),
                           int(cell.config["model"]["text"]["max_length"]),
                           dev)
    temp3 = float(cell.config["loss"]["temp3"])
    tie = float(cell.config["compare"]["serve"]["route_tie"])
    rows = []
    for images in images_list:
        for routes in image_routes(model, torch.as_tensor(images).to(dev),
                                   tie):
            cands = []
            for e in routes:
                sims = (e @ cls.T).cpu()
                probs = torch.softmax(sims * temp3, dim=-1)
                cands.append({"embedding": e.cpu().tolist(),
                              "sims": dict(zip(t["class_names"],
                                               sims.tolist())),
                              "probs": dict(zip(t["class_names"],
                                                probs.tolist()))})
            rows.append(cands)
    return rows
