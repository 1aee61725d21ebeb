"""``gloria_kept.train`` reads the share of GLoRIA kernel backwards that took
the forward's kept state, from the program's host counters, and nothing where
no GLoRIA kernel backward was counted or outside a training trace."""

from __future__ import annotations

import pytest

from benchmark import harness, trace


def test_gloria_kept_reads_nothing_without_a_gloria_backward():
    read = harness.metric_reader("gloria_kept.train").read
    some = trace.TraceSummary(1.0, 0.5, {})
    assert read(None, {"kind": "train"}) is None
    assert read(some, {"kind": "serve"}) is None


@pytest.mark.parametrize("got,want", [
    ({"gloria.kept": 20}, 100.0),
    ({"gloria.kept": 15, "gloria.recomputed": 5}, 75.0),
    ({"gloria.kept": 0, "gloria.recomputed": 20}, 0.0),
    ({"gloria.recomputed": 4}, 0.0),
    ({"launches.K3": 20}, None),         # a program without the counters
    ({}, None),
])
def test_gloria_kept_reads_the_program_counters(monkeypatch, got, want):
    from medmoe_torch.utils import trace as program

    monkeypatch.setattr(program, "counters", lambda: dict(got))
    read = harness.metric_reader("gloria_kept.train").read
    assert read(trace.TraceSummary(1.0, 0.5, {}), {"kind": "train"}) == want
