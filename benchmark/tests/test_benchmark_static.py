"""What the benchmark's files promise, checked without a card: no module
of it imports JAX or the JAX package, the reference imports nothing of the
program, every name in BENCHMARK.json keeps to the contract's characters,
cells, traffic and metrics are found by name alone, and the operation and
byte counts match hand counts."""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.metrics import flops

BENCH_DIR = harness.HERE
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _imports(path: str):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub: str = ""):
    for root, _, files in os.walk(os.path.join(BENCH_DIR, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_no_jax_anywhere():
    for path in _sources():
        found = set(_imports(path)) & set(harness.FORBIDDEN)
        assert not found, f"{path} imports {found}"


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        found = set(_imports(path)) & {harness.PROGRAM, "benchmark"}
        assert not found, f"{path} imports {found}"


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "medmoe_tpu_like", sys)
    assert "medmoe_tpu_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "medmoe_tpu.x", sys)
    assert "medmoe_tpu.x" in harness.forbidden_modules()


def test_benchmark_json_keeps_to_the_contract():
    b = harness.bench_spec()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]] + \
        [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]] + \
        [w["traffic"] for w in b["workloads"]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(names) - {w["traffic"] for w in b["workloads"]}) == \
        len(names) - len(b["workloads"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert os.path.exists(os.path.join(BENCH_DIR, "metrics",
                                           f"{m['name']}.py"))
    for w in b["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert w["traffic"] in harness.traffic_names()
        moved = [m for m in b["per_layer"]
                 if w["name"] in m.get("workloads", [w["name"]])]
        assert moved, w["name"]
    assert len(json.dumps(b)) < 64 << 10


def test_a_new_traffic_mix_and_metric_need_no_edit(tmp_path):
    """A copy of the benchmark with one more traffic file and one more
    metric file lists and loads them by name, with no file edited."""
    copy = tmp_path / "benchmark"
    shutil.copytree(BENCH_DIR, copy, ignore=shutil.ignore_patterns(
        "out", "__pycache__", "data"))
    (copy / "traffic" / "train_b128.json").write_text(json.dumps(
        {"entry": "train", "micro_batch": 128}))
    (copy / "metrics" / "new_share.train.py").write_text(
        "def read(trace, work):\n    return 42.0\n")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from benchmark import harness; "
            "print(harness.traffic_names()); "
            "print(harness.metric_reader('new_share.train').read(None, {}))")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, check=True).stdout
    assert "train_b128" in out and "42.0" in out


def test_the_run_refuses_without_a_card_or_without_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files,
    or on a machine without a card, a run prints no result and fails."""
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    args = [sys.executable, "benchmark/run.py", "--workload", "gather6.b256",
            "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"]
    for cwd in (tmp_path, harness.ROOT):
        p = subprocess.run(args, cwd=cwd, capture_output=True, text=True,
                           env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert p.returncode != 0 and p.stdout.strip() == ""


TINY_V = {"image_size": 32, "swin_embed_dim": 4, "swin_depths": [1, 2],
          "swin_num_heads": [1, 2], "swin_window_size": 2, "embed_dim": 8,
          "num_experts": 3, "router_top_k": 1}


def test_swin_flops_by_hand():
    # stage 0: N = 64 tokens, C = 4, one block; stage 1: N = 16, C = 8, two
    embed = 2 * 64 * 48 * 4
    s0 = 24 * 64 * 16 + 4 * 64 * 4 * 4
    merge = 4 * 64 * 16
    s1 = 2 * (24 * 16 * 64 + 4 * 16 * 4 * 8)
    assert flops.swin_forward(TINY_V) == embed + s0 + merge + s1
    assert flops.swin_train(TINY_V) == 3 * (embed + s0 + merge + s1) \
        - 2 * embed


def test_expert_flops_and_bytes_by_hand():
    # pyramid (64, 4) and (16, 8); E = 8, H = 4; P = 64, two scales
    proj = 2 * 64 * 4 * 8 + 2 * 16 * 8 * 8
    mlp = 2 * (2 * 64 * 8 * 4 + 2 * 64 * 4)
    assert flops.expert_forward(TINY_V) == proj + mlp
    x = 5 * (64 * 4 + 16 * 8) * 2
    bank = 3 * ((4 * 8 + 8) + (8 * 8 + 8) + 8 * 4 + 8 + 4 + 1) * 4
    out = 5 * 64 * 8 * 4
    assert flops.expert_bytes(TINY_V, 5, False) == x + bank + out
    assert flops.expert_bytes(TINY_V, 5, True) == 2 * x + 2 * bank + out


def test_bert_and_local_loss_by_hand():
    t = {"hidden_size": 4, "intermediate_size": 8, "num_layers": 2}
    assert flops.bert_forward(t, [3, 5]) == sum(
        2 * (2 * n * (4 * 16 + 2 * 4 * 8) + 4 * n * n * 4) for n in (3, 5))
    m = 9
    assert flops.local_products(2, [3, 4], 8, m) == 2 * m * 8 * 2 * 7
    one = 2 * m * 8 * 2 * 7
    fwd_b = 2 * m * 8 * 2 + 2 * 8 * 5 * 2 + 4 * 2 + 4 * 4
    assert flops.local_least_s(2, [3, 4], 8, 5, m, False) == pytest.approx(
        max(2 * one / flops.PEAK_FLOPS, fwd_b / flops.PEAK_BYTES)
        + max(3 * one / flops.PEAK_FLOPS,
              (fwd_b + 2 * m * 8 * 2) / flops.PEAK_BYTES))


def test_a_cell_reports_its_own_end_to_end_names():
    """``topk4.b64`` reports the entry's ``train_pairs_per_s`` under
    ``train_pairs_per_s.topk``, the name BENCHMARK.json gives it there."""
    bench = harness.bench_spec()
    out = harness.Outcome(1, 0, {"train_pairs_per_s": (2.0, "pairs/s"),
                                 "setup_s": (3.0, "s")}, 0, [])
    for cell, rate in (("topk4.b64", "train_pairs_per_s.topk"),
                       ("gather6.b256", "train_pairs_per_s")):
        c = harness.Cell(cell, 1, 1.0, False, 1, {}, {}, None, 0.0)
        res = harness.result_line(c, out, {}, {},
                                  harness.end_to_end_names(bench, cell))
        assert res["metrics"] == {rate: {"value": 2.0, "unit": "pairs/s"},
                                  "setup_s": {"value": 3.0, "unit": "s"}}
