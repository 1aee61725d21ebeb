"""The cell ``gather6.b256_text`` (``medmoe-gather6-text``: BERT trained end
to end) on the CPU at tiny widths in float32: the port's plain path against
the reference with BERT's leaves in ``grad`` and ``change``, a planted fault
and the float8 control each failing the configuration's limits, and
``dwords_roofline.text`` (K4b's share of its roofline) against a hand
count, and every per-layer metric that lists the cell on its traced
line."""

from __future__ import annotations

import json

import pytest

from benchmark import compare, faults, harness, trace
from benchmark.entries import train
from benchmark.metrics import flops
from benchmark.tests.tiny import tiny_cell

CELL = "gather6.b256_text"
#: the reference following the program's route where its router ties
FOLLOW = {"route_tie": 0.01, "route_miss": 0.0}


def _result(cell, out, capsys) -> dict:
    capsys.readouterr()
    assert harness.finish(harness.bench_spec(), cell, out) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_the_configuration_trains_bert():
    cell = tiny_cell(CELL)
    assert cell.config["model"]["text"]["freeze_bert"] is False
    assert cell.config["reduced"] == []


def test_train_text_matches_reference(capsys):
    cell = tiny_cell(CELL)
    cell.config["compare"]["train"].update(FOLLOW)
    module, state, step, pool = train.build(cell)
    prog = train.first_steps(module, state, step, pool,
                             int(cell.traffic["check_steps"]))
    del module, state, step, pool
    ref = train.reference_readings(cell, routes=prog["routes"])
    bert = [n for n in ref["grad1"] if n.startswith("text_encoder.bert.")]
    # every BERT leaf is compared, and none is frozen
    assert bert and not ref["frozen"]
    assert all(prog["grad1"][n] > 0 for n in bert
               if not n.startswith("text_encoder.bert.pooler."))
    nums = {n: v for n, v, _ in compare.train_numbers(
        prog, ref, cell.config["compare"]["train"])}
    assert nums["route_miss"] == 0.0
    # float32 on both sides, as in test_train_matches_reference: only the
    # order of sums (and the program's bf16 softmax residual in the local
    # loss's backward) differ, BERT's leaves included
    assert nums["loss"] < 1e-5 and nums["grad_median"] < 1e-3
    assert nums["grad"] < 5e-3 and nums["change"] < 2e-2
    assert nums["frozen"] == 0.0
    out = train.run(cell)
    res = _result(cell, out, capsys)
    assert res["correct"] is True
    assert set(res["metrics"]) == {"train_pairs_per_s", "setup_s"}


def test_half_a_batch_is_not_correct(capsys):
    """Half of each micro-batch left out, at the configuration's limits
    (the reference following the program's routes, as on the card)."""
    cell = tiny_cell(CELL)
    with faults.planted("train", "half"):
        out = train.run(cell)
    res = _result(cell, out, capsys)
    assert res["correct"] is False, res["compared"]
    loss = res["compared"]["loss"]
    assert loss["value"] > loss["limit"], res["compared"]


def test_control_is_not_correct():
    """The control, the reference with float8 products in the program's
    place, fails the configuration's limits."""
    cell = tiny_cell(CELL)
    lim = cell.config["compare"]["train"]
    ref = train.reference_readings(cell)
    ctl = train.reference_readings(cell, "fp8")
    numbers = compare.train_numbers(ctl, ref, lim)
    assert not harness.is_correct(numbers), numbers


READ = harness.metric_reader("dwords_roofline.text").read
V = {"image_size": 32, "swin_embed_dim": 4, "swin_depths": [1, 2],
     "swin_num_heads": [1, 2], "swin_window_size": 2, "embed_dim": 8,
     "num_experts": 3, "router_top_k": 1}
WORK = {"kind": "train", "model": {"vision": V, "text": {"max_length": 5}},
        "micro_batch": 2, "profiled_cap_lens": [[3, 4], [5, 1]]}


@pytest.fixture
def counted(monkeypatch):
    from medmoe_torch.utils import trace as program

    got = {"gloria.words": 2}
    monkeypatch.setattr(program, "counters", lambda: dict(got))
    return got


def test_dwords_roofline_reads_nothing_without_k4b(counted):
    none = trace.TraceSummary(1.0, 0.5, {"void_sim_e_kernel_1": 0.1,
                                         "dctx_gemm_kernel_x": 0.2})
    assert READ(none, WORK) is None
    assert READ(None, WORK) is None
    some = trace.TraceSummary(1.0, 0.5, {"void_dwords_gemm_kernel_x": 0.1})
    assert READ(some, dict(WORK, kind="serve")) is None
    counted.clear()                       # a program without the counter
    assert READ(some, WORK) is None
    counted["gloria.words"] = 0
    assert READ(some, WORK) is None


def test_dwords_roofline_by_hand(counted):
    """Stage 0 of the tiny Swin: M = 8 × 8 regions, D = 8. Per micro-batch
    one product 2·M·D·B·Σ len, against ctx and Z in bf16, d_words in bf16
    and the two f32 sums over the captions' own words."""
    m, d, b = 64, 8, 2
    least = 0.0
    for words in (7, 6):
        ops = 2 * m * d * b * words
        nbytes = b * m * d * 2 + b * m * words * 2 + d * words * 2 \
            + d * words * 4 + words * 4
        least += max(ops / flops.PEAK_FLOPS, nbytes / flops.PEAK_BYTES)
    kernels = {"void_dwords_gemm_kernel_x": 3e-6, "dwords_sum_kernel_y": 1e-6,
               "void_dwords_wei_kernel": 1e-6, "void_sim_e_kernel_1": 5.0}
    s = trace.TraceSummary(10.0, 6.0, kernels)
    assert READ(s, WORK) == pytest.approx(100.0 * least / 5e-6)


def test_a_traced_line_reports_every_listed_metric(counted, capsys):
    """Every per-layer metric that lists the cell reads on its traced line:
    the cell's step runs K1 and K2, every GLoRIA kernel with K4b, and its
    prologues run from K3's kept state. A synthetic trace of those kernels
    and the counters stand in for the card's."""
    cell = tiny_cell(CELL)
    out = train.run(cell)
    counted["gloria.kept"] = 2
    kernels = {k: 1e-3 for k in flops.K1_KERNELS + flops.K2_KERNELS
               + flops.GLORIA_KERNELS}
    out.trace = trace.TraceSummary(10.0, 6.0, kernels)
    out.work["peak_bytes"] = 1
    cell.trace = True
    res = _result(cell, out, capsys)
    listed = {m["name"] for m in harness.per_layer_names(
        harness.bench_spec(), CELL)}
    assert {"expert_roofline.train", "gloria_kept.train",
            "dwords_roofline.text"} <= listed
    assert listed <= set(res["metrics"]), res["metrics"]
