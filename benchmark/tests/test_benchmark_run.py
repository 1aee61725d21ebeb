"""The harness end to end on the CPU at tiny widths: the port's plain path
against the reference, and a run with the timed path broken, whose
``correct`` must come out false."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import faults, harness
from benchmark.entries import serve, train
from benchmark.tests.tiny import TOPK, tiny_cell

#: the reference following the program's route where its router ties
FOLLOW = {"route_tie": 0.01, "route_miss": 0.0}


def _result(cell, out, capsys) -> dict:
    capsys.readouterr()
    rc = harness.finish(harness.bench_spec(), cell, out)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("moe,follow", [(None, True), (TOPK, False),
                                        (TOPK, True)],
                         ids=["gather", "topk-own-routes", "topk"])
def test_train_matches_reference(moe, follow, capsys):
    cell = tiny_cell("gather6.b256", moe=moe)
    cell.config["compare"]["train"].update(
        FOLLOW if follow else {"route_tie": None})
    out = train.run(cell)
    nums = {n: v for n, v, _ in out.compare}
    assert ("route_miss" in nums) == follow
    assert nums.get("route_miss", 0.0) == 0.0
    # float32 on both sides: only the order of sums (and the program's
    # bf16 softmax residual in the local loss's backward) differ
    assert nums["loss"] < 1e-5 and nums["grad_median"] < 1e-3
    assert nums["grad"] < 5e-3 and nums["change"] < 2e-2
    assert nums["frozen"] == 0.0
    res = _result(cell, out, capsys)
    assert res["correct"] is True
    assert set(res["metrics"]) == {"train_pairs_per_s", "setup_s"}
    assert list(res)[-1] == "compared"


def test_serve_matches_reference(capsys):
    cell = tiny_cell("gather6.serve_w256")
    out = serve.run(cell)
    nums = {n: v for n, v, _ in out.compare}
    assert nums["embedding"] < 1e-5 and nums["probs"] < 1e-5
    assert nums["label"] == 0.0 and nums["missing"] == 0.0
    res = _result(cell, out, capsys)
    assert res["correct"] is True
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("workload,fault,moe,follow", [
    ("gather6.b256", "unchanged", None, False),
    ("gather6.b256", "half", None, False),
    ("gather6.b256", "unchanged", TOPK, False),
    ("gather6.b256", "half", TOPK, False),
    ("gather6.b256", "route", TOPK, True),
    ("gather6.serve_w256", "half", None, False),
    ("gather6.serve_w256", "answer", None, False),
    ("gather6.serve_w256", "route", None, False)])
def test_fault_is_not_correct(workload, fault, moe, follow, capsys):
    """A run with the timed path broken underneath, at the committed
    limits (a wrong route in training: at ``route_miss`` 0)."""
    cell = tiny_cell(workload, moe=moe)
    if follow:
        cell.config["compare"]["train"].update(FOLLOW)
    kind = "serve" if workload == "gather6.serve_w256" else "train"
    entry = serve if kind == "serve" else train
    with faults.planted(kind, fault):
        out = entry.run(cell)
    res = _result(cell, out, capsys)
    assert res["correct"] is False, res["compared"]


@pytest.mark.parametrize("workload", ["gather6.b256", "gather6.serve_w256"])
def test_control_is_not_correct(workload):
    """The control, the reference with float8 products in the program's
    place, fails the cell's limits."""
    from benchmark import compare

    cell = tiny_cell(workload)
    lim = cell.config["compare"]
    if workload == "gather6.b256":
        ref = train.reference_readings(cell)
        ctl = train.reference_readings(cell, "fp8")
        numbers = compare.train_numbers(ctl, ref, lim["train"])
    else:
        from benchmark import traffic

        pool = traffic.serve_pool(cell.traffic, 64, cell.seed, cell.device)
        ref = serve.reference_rows(cell, pool)
        ctl = serve.reference_rows(cell, pool, "fp8")
        served = [{"embedding": c[0]["embedding"], "probs": c[0]["probs"],
                   "label": max(c[0]["sims"], key=c[0]["sims"].get)}
                  for c in ctl]
        numbers = compare.serve_numbers(served, ref, lim["serve"], 10.0)
    assert not harness.is_correct(numbers), numbers


@pytest.mark.cuda
def test_trace_reads_the_card(cuda_card):
    """The trace of a few products on the card: busy time within the
    window, the products by name."""
    from benchmark.trace import profile

    x = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)

    def work():
        with torch.profiler.record_function("make_batch"):
            for _ in range(8):
                x @ x

    s = profile(work, ("make_batch",))
    assert 0 < s.busy_s <= s.window_s
    assert s.kernels and s.breakdown()["device_ops"]


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
