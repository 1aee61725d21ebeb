"""The program's spans in the device trace, checked without a card: the
readings of ``trace.reduce`` are the same with and without ``medmoe#``
host ranges and their device annotations; ``spans.attribute`` puts device
time and idle gaps down to the program's spans, the backward's through the
sequence number of its forward op; ``slot_use.topk`` reads nothing outside
a top-k training trace."""

from __future__ import annotations

from dataclasses import dataclass

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import harness, spans, trace

STEP = ("make_batch", "train_step")


@dataclass
class Range:
    start: float
    end: float


class Ev:
    """The fields of a profiler event that the reductions read."""

    def __init__(self, name, start, end, device=False, thread=1, id=0,
                 link=None, seq=-1, fwd_thread=0):
        self.name = name
        self.time_range = Range(start, end)
        self.device_type = DeviceType.CUDA if device else DeviceType.CPU
        self.thread, self.id = thread, id
        if link is not None:
            self.linked_correlation_id = link
        self.sequence_nr, self.fwd_thread = seq, fwd_thread
        self.is_async = False


#: how a device event finds its launching op: its own
#: ``linked_correlation_id`` (newer profilers), the runtime call with its
#: correlation id, or ``links`` from the profiler's results
MODES = ("linked", "runtime", "links")


def _launch(name, start, end, op_id, cuda_id, mode, thread=1):
    """A host op, the runtime call inside it (not in ``links`` mode), and
    the device operation the call starts."""
    linked = mode == "linked"
    ev = [Ev(f"aten::{name}", start, start + 10, thread=thread, id=op_id,
             link=0 if linked else None),
          Ev(f"{name}_kernel", *end, device=True, id=cuda_id,
             link=op_id if linked else None)]
    if mode != "links":
        ev.insert(1, Ev("cudaLaunchKernel", start + 2, start + 4,
                        thread=thread, id=cuda_id,
                        link=op_id if linked else None))
    return ev


#: ``links`` mode's map, device correlation id → op id
LINKS = {1: 5, 2: 9, 3: 11}


def _events(program_spans: bool, mode: str = "linked"):
    """A traced window (µs): a forward op in ``medmoe#swin`` and its
    kernel, the op's backward on the autograd thread (2) and its kernel,
    then an optimizer op and its kernel; with ``program_spans`` the
    program's host ranges and their device annotations too. The runtime
    calls' correlation ids (1, 2, 3) collide with the ops' (5, 9, 11) only
    in another id space."""
    ev = [Ev(trace.WINDOW, 0, 1000),
          Ev("train_step", 10, 900), Ev("train_step", 10, 900, device=True),
          Ev(spans.BACKWARD + "AddmmBackward0", 500, 520, thread=2, seq=7,
             fwd_thread=1)]
    ev += _launch("addmm", 40, (100, 300), 5, 1, mode)
    next(e for e in ev if e.name == "aten::addmm").sequence_nr = 7
    ev += _launch("mm", 505, (600, 700), 9, 2, mode, thread=2)
    ev += _launch("add_", 881, (890, 950), 11, 3, mode)
    ev += [Ev("aten::zero_", 60, 62, id=1), Ev("aten::zero_", 62, 64, id=2)]
    if program_spans:
        ev += [Ev("medmoe#step.forward", 20, 400),
               Ev("medmoe#swin", 30, 200),
               Ev("medmoe#swin", 100, 300, device=True),
               Ev("medmoe#step.backward", 450, 880),
               Ev("medmoe#step.backward", 590, 710, device=True),
               Ev("medmoe#step.optimizer", 880, 895),
               Ev("medmoe#step.optimizer", 889, 951, device=True)]
    return sorted(ev, key=lambda e: (e.time_range.start, -e.time_range.end))


def test_reduce_reads_the_same_with_the_program_spans():
    without = trace.reduce(_events(False), STEP)
    with_spans = trace.reduce(_events(True), STEP)
    for name in ("busy_s", "window_s", "kernels", "gaps"):
        assert getattr(with_spans, name) == getattr(without, name), name
    assert with_spans.busy_s == pytest.approx(360e-6)
    assert set(with_spans.kernels) == {"addmm_kernel", "mm_kernel",
                                       "add__kernel"}


@pytest.mark.parametrize("mode", MODES)
def test_attribute_puts_the_backward_down_to_its_forward_span(mode):
    s = spans.attribute(_events(True, mode), STEP,
                        LINKS if mode == "links" else None)
    assert s.by_span == pytest.approx({"medmoe#swin": 200e-6,
                                       "medmoe#swin.bwd": 100e-6,
                                       "medmoe#step.optimizer": 60e-6})
    assert s.busy_s == pytest.approx(360e-6)
    assert s.labeled_s == pytest.approx(s.busy_s) and s.unlinked_s == 0
    # each gap by the label its next op's launching thread had at its start
    assert s.span_gaps == pytest.approx([
        ("none", 100e-6), ("none", 300e-6),
        ("medmoe#step.backward", 190e-6), ("none", 50e-6)])
    assert s.gap_ends == ["addmm_kernel", "mm_kernel", "add__kernel", ""]
    assert s.gap_hosts == ["", "", "medmoe#step.backward", ""]
    assert s.idle_by_span() == pytest.approx(
        {"none": (450e-6, 3), "medmoe#step.backward": (190e-6, 1)})
    br = s.breakdown()
    assert br["device_spans"][0] == ["medmoe#swin", pytest.approx(200e-6)]
    assert br["idle_gaps_program"][0] == ["none", pytest.approx(300e-6)]


def test_the_op_that_made_the_node_owns_its_backward():
    """An op that makes no autograd node records the number the next node
    takes: one in ``medmoe#step.forward`` before ``medmoe#swin``'s addmm
    (both number 7) leaves the backward to ``medmoe#swin``."""
    ev = _events(True) + [Ev("aten::to", 22, 24, id=21, link=0, seq=7)]
    s = spans.attribute(sorted(ev, key=lambda e: e.time_range.start), STEP)
    assert s.by_span["medmoe#swin.bwd"] == pytest.approx(100e-6)
    assert "medmoe#step.forward.bwd" not in s.by_span


def test_attribute_without_the_program_spans_labels_nothing():
    s = spans.attribute(_events(False), STEP)
    assert set(s.by_span) == {"none"} and s.labeled_s == 0.0


def test_an_op_with_no_launcher_is_unlinked():
    s = spans.attribute(_events(True, "links"), STEP)
    assert s.by_span == pytest.approx({"none": 360e-6})
    assert s.unlinked_s == pytest.approx(360e-6)


def test_a_span_below_the_backward_function_labels_its_ops():
    """A checkpointed recompute re-enters its own spans inside the
    backward: they label its ops, not the forward's ``.bwd``."""
    ev = _events(True) + [Ev("medmoe#loss.local", 506, 509, thread=2),
                          Ev("aten::bmm", 507, 508, thread=2, id=13, link=0),
                          Ev("recompute_kernel", 710, 720, device=True,
                             link=13)]
    s = spans.attribute(sorted(ev, key=lambda e: e.time_range.start), STEP)
    assert s.by_span["medmoe#loss.local"] == pytest.approx(10e-6)
    assert s.by_span["medmoe#swin.bwd"] == pytest.approx(100e-6)


def test_attribute_reads_a_real_backward_through_the_sequence_number():
    """The host events of a real CPU profile (forward under
    ``medmoe#swin``, backward under ``medmoe#step.backward``), with one
    device op linked to each host op of the backward: each lands on
    ``medmoe#swin.bwd``, none on ``medmoe#step.backward``."""
    m = torch.nn.Sequential(torch.nn.Linear(8, 8), torch.nn.ReLU(),
                            torch.nn.Linear(8, 1))
    x = torch.randn(4, 8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW):
            with record_function("medmoe#step.forward"):
                with record_function("medmoe#swin"):
                    y = m(x)
            with record_function("medmoe#step.backward"):
                y.sum().backward()
    host = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    bwd = [e for e in host
           if e.name in ("aten::mm", "aten::threshold_backward")
           and e.cpu_parent is not None
           and not e.cpu_parent.name.startswith("medmoe#")]
    assert bwd
    fake = [Ev(f"kernel_{i}", e.time_range.start + 1, e.time_range.start + 2,
               device=True, id=10 ** 6 + i, link=e.id)
            for i, e in enumerate(bwd)]
    s = spans.attribute(list(prof.events()) + fake, STEP)
    assert set(s.by_span) == {"medmoe#swin.bwd"}
    assert s.by_span["medmoe#swin.bwd"] == pytest.approx(len(bwd) * 1e-6)


def test_slot_use_reads_nothing_outside_a_topk_train_trace():
    read = harness.metric_reader("slot_use.topk").read
    some = trace.TraceSummary(1.0, 0.5, {})
    assert read(None, {"kind": "train"}) is None
    assert read(some, {"kind": "serve"}) is None
    # no top-k dispatch ran under a profiler: no slot counted
    assert read(some, {"kind": "train"}) is None


def test_slot_use_reads_the_program_counters(monkeypatch):
    from medmoe_torch.utils import trace as program

    monkeypatch.setattr(program, "counters",
                        lambda: {"moe.kept": 96.0, "moe.slots": 192})
    read = harness.metric_reader("slot_use.topk").read
    assert read(trace.TraceSummary(1.0, 0.5, {}), {"kind": "train"}) == 50.0
