"""The port's spans and counters (``medmoe_torch/utils/trace.py``) on the
CPU: the no-op with no profiler, the spans of one optimizer step of a tiny
top-k configuration (BERT frozen, and trained) and of one served wave under
a CPU ``torch.profiler``,
their nesting, the backward's ops put down to the forward's span through
the sequence number, the routing counters against a count by hand, and the
launch counters read through the ops modules' names."""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from medmoe_torch.models import moe as tmoe
from medmoe_torch.ops import expert_fusion as ef
from medmoe_torch.ops import gloria_attention as ga
from medmoe_torch.utils import trace

torch.set_num_threads(1)

B = 4
T = 10
TINY = [
    "experiment=moe_single_modality", "model.model.vision.image_size=56",
    "model.model.vision.swin_embed_dim=8",
    "model.model.vision.swin_depths=[1,1]",
    "model.model.vision.swin_num_heads=[1,2]",
    "model.model.vision.num_experts=3", "model.model.vision.embed_dim=16",
    "model.model.vision.dtype=float32",
    "model.model.vision.capacity_factor=1.0",
    "model.model.text.hidden_size=16", "model.model.text.num_layers=2",
    "model.model.text.num_heads=2", "model.model.text.intermediate_size=32",
    "model.model.text.vocab_size=64", "model.model.text.embed_dim=16",
    f"model.model.text.max_length={T}", "model.model.text.dtype=float32",
    "trainer.accelerator=cpu",
]

#: each span of one training step, and the span it opens inside
TRAIN_PARENTS = {
    "medmoe#step.forward": None, "medmoe#step.backward": None,
    "medmoe#step.optimizer": None,
    "medmoe#bert": "medmoe#step.forward",
    "medmoe#bert.merge": "medmoe#bert",
    "medmoe#swin": "medmoe#step.forward",
    "medmoe#moe.router": "medmoe#step.forward",
    "medmoe#moe.experts": "medmoe#step.forward",
    "medmoe#moe.dispatch": "medmoe#moe.experts",
    "medmoe#moe.grouped": "medmoe#moe.experts",
    "medmoe#moe.combine": "medmoe#moe.experts",
    "medmoe#loss.local": "medmoe#step.forward",
    "medmoe#loss.global": "medmoe#step.forward",
    "medmoe#loss.router": "medmoe#step.forward",
}
SERVE_PARENTS = {"medmoe#serve.h2d": None, "medmoe#swin": None,
                 "medmoe#moe.router": None, "medmoe#moe.experts": None,
                 "medmoe#serve.scores": None}

LAUNCH_NAMES = [(ef, "LAUNCHES", "launches.K1"),
                (ef, "BWD_LAUNCHES", "launches.K2"),
                (ga, "LAUNCHES", "launches.K3"),
                (ga, "PROLOGUE_LAUNCHES", "launches.prologue"),
                (ga, "DCTX_LAUNCHES", "launches.K4a"),
                (ga, "DWORDS_LAUNCHES", "launches.K4b")]


@pytest.fixture(autouse=True)
def _registry():
    """Each test starts from an empty registry; the counts of the rest of
    the process are put back after it."""
    host, device = dict(trace._HOST), dict(trace._DEVICE)
    trace.reset()
    yield
    trace.reset()
    trace._HOST.update(host)
    trace._DEVICE.update(device)


def _micro(rng):
    ids = rng.randint(0, 64, (B, T))
    mask = np.zeros((B, T), np.int64)
    segs = np.full((B, T), -1, np.int64)
    cap = np.zeros(B, np.int64)
    for i in range(B):
        n = 4 + i
        mask[i, :n] = 1
        segs[i, :n] = [0, 1, 2, 2] + list(range(3, n - 1))
        cap[i] = segs[i].max() + 1
    batch = {"image": rng.randn(B, 56, 56, 3).astype(np.float32),
             "input_ids": ids, "attention_mask": mask,
             "token_type_ids": np.zeros((B, T), np.int64),
             "segment_ids": segs, "cap_lens": cap,
             "label": rng.randint(0, 3, B)}
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _module(extra=()):
    from medmoe_torch.config import compose
    from medmoe_torch.models.medmoe import init_weights
    from medmoe_torch.utils.instantiate import instantiate

    cfg = compose("train", TINY + list(extra))
    module = instantiate(cfg.model)
    init_weights(module.model, seed=3)
    return module


def _host(events):
    return [e for e in events if e.device_type.name == "CPU"]


def _owners(host):
    """{id(event): the innermost ``medmoe#`` range open on the event's
    thread around it, the event itself left out (None where none is)}."""
    out, stacks = {}, {}
    for ev in sorted(host, key=lambda e: (e.time_range.start,
                                          -e.time_range.end)):
        stack = stacks.setdefault(ev.thread, [])
        while stack and stack[-1].time_range.end < ev.time_range.end:
            stack.pop()
        out[id(ev)] = next((h for h in reversed(stack)
                            if h.name.startswith("medmoe#")), None)
        stack.append(ev)
    return out


def _inside(host, prefix):
    """ids of the events that are, or lie inside, an event whose name
    starts with ``prefix`` on their thread."""
    out, stacks = set(), {}
    for ev in sorted(host, key=lambda e: (e.time_range.start,
                                          -e.time_range.end)):
        stack = stacks.setdefault(ev.thread, [])
        while stack and stack[-1].time_range.end < ev.time_range.end:
            stack.pop()
        if ev.name.startswith(prefix) or any(id(h) in out for h in stack):
            out.add(id(ev))
        stack.append(ev)
    return out


def _nesting(events):
    """{span name: the span it opens inside (None at the top)} over every
    occurrence of each span; a span found under two parents raises."""
    host = _host(events)
    owners = _owners(host)
    out = {}
    for ev in host:
        if ev.name.startswith("medmoe#"):
            parent = owners[id(ev)]
            name = parent.name if parent is not None else None
            assert out.setdefault(ev.name, name) == name, (ev.name, name)
    return out


def _backward_owners(events):
    """The spans the backward's ``evaluate_function`` events map to: each
    carries its forward op's sequence number and thread, and the innermost
    span of the latest forward op to record that number owns it (an op
    that makes no autograd node records the number the next node takes)."""
    host = _host(events)
    owners = _owners(host)
    backward = _inside(host, "autograd::engine::evaluate_function")
    forward = {}               # the latest forward op to record each number
    for ev in sorted(host, key=lambda e: e.time_range.start):
        if ev.sequence_nr >= 0 and id(ev) not in backward:
            forward[(ev.thread, ev.sequence_nr)] = ev
    mapped = set()
    for ev in host:
        if not ev.name.startswith("autograd::engine::evaluate_function: ") \
                or ev.sequence_nr < 0:
            continue
        op = forward.get((ev.fwd_thread, ev.sequence_nr))
        if op is None or op.time_range.end > ev.time_range.start:
            continue           # a node the checkpointed recompute made
        if owners[id(op)] is not None:
            mapped.add(owners[id(op)].name)
    return mapped


def _step_trace(extra=()):
    """One optimizer step (2 micro-batches) under a CPU profiler: its spans'
    nesting, the spans its backward maps to, and the registry's counters of
    that window."""
    from medmoe_torch.train.state import TrainState
    from medmoe_torch.train.step import build_train_step

    module = _module(extra)
    state = TrainState.create(module.model, module.make_optimizer())
    step = build_train_step(module, 2)
    rng = np.random.RandomState(0)
    micro = [_micro(rng) for _ in range(2)]
    step(state, micro)
    saved = dict(trace._HOST), dict(trace._DEVICE)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, micro)
    counters = trace.counters()
    trace.reset()
    trace._HOST.update(saved[0])
    trace._DEVICE.update(saved[1])
    events = prof.events()
    frozen = not any(p.requires_grad
                     for p in module.model.text_encoder.parameters())
    return {"nesting": _nesting(events), "frozen_bert": frozen,
            "backward": _backward_owners(events), "counters": counters}


@pytest.fixture(scope="module")
def step_trace():
    return _step_trace()


@pytest.fixture(scope="module")
def text_step_trace():
    """The same step with BERT trained, the local loss on the fused
    similarity's path (its plain version here)."""
    return _step_trace(["model.model.text.freeze_bert=false",
                        "model.loss.local_loss.impl=pallas"])


def test_no_profiler_span_is_the_shared_noop():
    assert not trace.enabled()
    off = trace.span("medmoe#swin")
    assert off is trace.span("medmoe#step.forward") is trace._OFF
    with off as entered:
        assert entered is off
    # with no profiler no name is looked at and no device counter moves
    assert trace.span("not a span") is off
    trace.count("moe.kept", torch.ones(()))
    assert trace.counters() == {}


def test_no_profiler_moe_touches_no_device_counter():
    cfg = tmoe.MoEConfig(num_experts=3, hidden_dims=(8, 16), output_dim=16,
                         router_input_dim=16, router_hidden_dim=8,
                         mode="topk", top_k=2, capacity_factor=1.0,
                         dtype=torch.float32)
    m = tmoe.MoE(cfg)
    pyramid = [torch.randn(B, 16, 8), torch.randn(B, 4, 16)]
    m(pyramid, torch.randn(B, 16))
    assert trace.counters() == {}


def test_span_names_hold_hash():
    assert trace.SPANS and all(
        n.startswith("medmoe#") and "#" in n and " " not in n
        for n in trace.SPANS)
    assert set(TRAIN_PARENTS) | set(SERVE_PARENTS) == set(trace.SPANS)


def test_unknown_span_raises_under_the_profiler():
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(KeyError):
            trace.span("medmoe#nowhere")


@pytest.mark.parametrize("name", sorted(TRAIN_PARENTS))
def test_step_span_nests_as_in_the_table(step_trace, name):
    nesting = step_trace["nesting"]
    assert name in nesting
    assert nesting[name] == TRAIN_PARENTS[name]


@pytest.mark.parametrize("span", ["medmoe#swin", "medmoe#moe.combine",
                                  "medmoe#moe.grouped", "medmoe#moe.router",
                                  "medmoe#loss.local", "medmoe#loss.global"])
def test_backward_maps_to_its_forward_span(step_trace, span):
    """The backward's work is put down to the forward's spans, and none of
    it to ``medmoe#step.backward``."""
    mapped = step_trace["backward"]
    assert span in mapped
    assert "medmoe#step.backward" not in mapped


def test_a_frozen_bert_has_no_backward(step_trace):
    assert step_trace["frozen_bert"]
    assert "medmoe#bert" not in step_trace["backward"]
    assert "medmoe#bert.merge" not in step_trace["backward"]


@pytest.mark.parametrize("span", ["medmoe#bert", "medmoe#bert.merge",
                                  "medmoe#loss.local"])
def test_a_trained_bert_backward_maps_to_its_spans(text_step_trace, span):
    """BERT's layers and the word-piece merge each take their backward's
    work; the merge opens inside ``medmoe#bert`` there too."""
    assert not text_step_trace["frozen_bert"]
    assert span in text_step_trace["backward"]
    assert "medmoe#step.backward" not in text_step_trace["backward"]
    assert text_step_trace["nesting"]["medmoe#bert.merge"] == "medmoe#bert"


@pytest.mark.parametrize("words_grad", [True, False],
                         ids=["words-trained", "words-frozen"])
def test_gloria_words_counts_a_backward_that_takes_the_words(words_grad):
    """``gloria.words``: one a GLoRIA similarity backward that takes the
    words' gradient, none where only the image side needs one (a step's
    count: ``tests/test_torch_text_train.py``)."""
    torch.manual_seed(0)
    img = torch.randn(2, 8, 3, 3, requires_grad=True)
    words = torch.randn(3, 8, 5, requires_grad=words_grad)
    sim = ga.gloria_similarity(img, words, torch.tensor([2, 5, 3]))
    assert trace.counters() == {}           # the forward counts nothing
    sim.sum().backward()
    assert trace.counters().get(trace.GLORIA_WORDS, 0) == int(words_grad)
    assert (words.grad is not None) == words_grad


def _hand_count(expert_idx, k, capacity):
    """(assignments, kept) of a [B, k_slots] list of expert ids, counted
    sample-major as GShard does: an assignment is kept while fewer than
    ``capacity`` earlier ones went to its expert."""
    seen = [0] * k
    kept = 0
    for e in expert_idx.reshape(-1).tolist():
        kept += seen[e] < capacity
        seen[e] += 1
    return expert_idx.numel(), kept


@pytest.mark.parametrize("factor", [0.5, 1.0, 2.0])
def test_dispatch_counters_match_a_hand_count(factor):
    k = 3
    cfg = tmoe.MoEConfig(num_experts=k, hidden_dims=(8, 16), output_dim=16,
                         router_input_dim=16, router_hidden_dim=8,
                         mode="topk", top_k=2, capacity_factor=factor,
                         dtype=torch.float32)
    torch.manual_seed(int(factor * 10))
    m = tmoe.MoE(cfg)
    for p in m.parameters():
        torch.nn.init.normal_(p, std=0.5)
    b = 7
    pyramid = [torch.randn(b, 16, 8), torch.randn(b, 4, 16)]
    feat = torch.randn(b, 16)
    with torch.no_grad():
        probs = torch.softmax(m.router_fc2(torch.relu(m.router_fc1(feat))),
                              dim=-1)
    idx, w = tmoe.topk_routing(probs, 2)
    capacity = int(np.ceil(b * 2 * factor / k))
    dispatch, _ = tmoe.make_dispatch_tensors(idx, w, k, capacity)
    assignments, kept = _hand_count(idx, k, capacity)
    assert float(dispatch.sum()) == kept
    with profile(activities=[ProfilerActivity.CPU]):
        m(pyramid, feat)
        m(pyramid, feat)
    got = trace.counters()
    assert got["moe.assignments"] == 2 * assignments
    assert got["moe.slots"] == 2 * k * capacity
    assert got["moe.kept"] == 2 * kept
    assert got["moe.images_per_expert"] == (
        2 * torch.bincount(idx[:, 0].long(), minlength=k)).tolist()
    if factor < 1:
        assert kept < assignments               # capacity drops happened


def test_step_counters_cover_the_profiled_window(step_trace):
    got = step_trace["counters"]
    assert got["moe.assignments"] == 2 * B * 2       # 2 micro-batches, top-2
    assert got["moe.slots"] == 2 * 3 * int(np.ceil(B * 2 * 1.0 / 3))
    assert 0 < got["moe.kept"] <= got["moe.assignments"]
    assert sum(got["moe.images_per_expert"]) == 2 * B
    assert not any(n.startswith("launches.") for n in got)   # CPU: none


@pytest.mark.parametrize("mod,attr,name", LAUNCH_NAMES,
                         ids=[f"{m.__name__.rsplit('.', 1)[1]}.{a}"
                              for m, a, _ in LAUNCH_NAMES])
def test_launch_names_read_the_registry(mod, attr, name):
    assert getattr(mod, attr) == 0
    trace.count(name)
    trace.count(name, 2)
    assert getattr(mod, attr) == 3 == trace.counters()[name]
    trace.reset()
    assert getattr(mod, attr) == 0


def test_other_module_attributes_still_raise():
    with pytest.raises(AttributeError):
        ef.NOT_A_COUNTER
    with pytest.raises(AttributeError):
        ga.NOT_A_COUNTER
    assert not hasattr(ef, "LAUNCHES_X")


def test_serve_wave_spans():
    """One wave through ``serve_waves`` and ``make_image_embedder``: the
    copy, Swin, the router, the expert branch and the scores, each at the
    top."""
    from medmoe_torch.cli.serve import serve_waves
    from medmoe_torch.eval.zero_shot import make_image_embedder

    module = _module()
    model = module.model.eval()
    embed = make_image_embedder(model)
    rng = np.random.RandomState(1)
    images = (rng.rand(3, 56, 56, 3) * 255).astype(np.uint8)
    class_emb = rng.randn(2, 16).astype(np.float32)
    buf = io.StringIO()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        n_ok, n_err = serve_waves(embed, [(["a", "b", "c"], images, [])],
                                  "classify", ["x", "y"], class_emb, 10.0,
                                  buf)
    assert (n_ok, n_err) == (3, 0)
    nesting = _nesting(prof.events())
    assert {n: nesting.get(n, "absent") for n in SERVE_PARENTS} == \
        SERVE_PARENTS
