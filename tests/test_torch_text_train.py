"""The trained text tower on the CPU: the benchmark's configurations
``medmoe-gather6-text`` (``freeze_bert: false``) and ``medmoe-gather6``
(frozen) at tiny widths, composed through ``harness.overrides`` as the
benchmark composes them, one optimizer step each: BERT's parameters train
only where the configuration says so, Adam holds state for them, the
clip's global norm spans both towers, and ``gloria.words`` counts each
GLoRIA similarity backward that takes the words' gradient (the local loss
on its fused path, whose plain version runs here)."""

from __future__ import annotations

import math

import pytest
import torch

from benchmark import harness, traffic
from benchmark.tests.tiny import tiny_cell
from medmoe_torch.utils import trace

torch.set_num_threads(1)

SEED = 2 ** 31 + 29
CELLS = {"trained": "gather6.b256_text", "frozen": "gather6.b256"}


def _build(cell):
    from medmoe_torch.config import compose
    from medmoe_torch.models.layers import set_generator
    from medmoe_torch.models.medmoe import init_weights
    from medmoe_torch.train.state import TrainState
    from medmoe_torch.utils.instantiate import instantiate

    cfg = compose("train", harness.overrides(cell.config)
                  + ["model.loss.local_loss.impl=pallas"])
    module = instantiate(cfg.model)
    init_weights(module.model, seed=5)
    set_generator(module.model, torch.Generator().manual_seed(7))
    tx = module.make_optimizer(
        gradient_clip_val=float(cell.config["optimizer"]["clip"]))
    return module, TrainState.create(module.model, tx)


@pytest.fixture(scope="module", params=sorted(CELLS))
def stepped(request):
    """One optimizer step of the tiny cell: the module, its state, the
    weights before, the step's accumulated (unclipped) gradient and global
    norm as the step handed them to the clip, and the counters of the
    step."""
    from medmoe_torch.train import step as step_mod

    cell = tiny_cell(CELLS[request.param], seed=SEED)
    module, state = _build(cell)
    accum = int(cell.config["accumulate_grad_batches"])
    widths = cell.config["model"]
    pool = traffic.train_pool(cell.traffic, accum,
                              int(widths["text"]["max_length"]),
                              int(widths["vision"]["image_size"]),
                              cell.seed, cell.device)
    before = {n: p.detach().clone()
              for n, p in module.model.named_parameters()}
    seen = {}
    real = step_mod.global_norm

    def global_norm(grads, *args, **kw):
        seen["grads"] = [g.detach().clone() for g in grads]
        seen["norm"] = real(grads, *args, **kw)
        return seen["norm"]

    saved = dict(trace._HOST)
    trace.reset()
    step_mod.global_norm = global_norm
    try:
        step_mod.build_train_step(module, accum)(state, pool[0])
    finally:
        step_mod.global_norm = real
        counters = trace.counters()
        trace.reset()
        trace._HOST.update(saved)
    return {"kind": request.param, "module": module, "state": state,
            "before": before, "accum": accum, "counters": counters,
            "clip": float(cell.config["optimizer"]["clip"]), **seen}


def _bert(module):
    """BERT's parameters by name, the pooler left out: its output feeds no
    loss, so its gradient is zero either way."""
    return {n: p for n, p in module.model.text_encoder.bert.named_parameters()
            if not n.startswith("pooler.")}


def test_bert_trains_as_the_configuration_says(stepped):
    module = stepped["module"]
    trained = stepped["kind"] == "trained"
    assert bool(module.text_cfg.get("freeze_bert", False)) != trained
    moved = {n: not torch.equal(p.detach(),
                                stepped["before"]["text_encoder.bert." + n])
             for n, p in _bert(module).items()}
    assert all(p.requires_grad == trained for p in _bert(module).values())
    if trained:
        assert all(moved.values()), [n for n, m in moved.items() if not m]
    else:
        assert not any(moved.values())
    # the image tower trains in both
    assert any(not torch.equal(p.detach(), stepped["before"][n])
               for n, p in module.model.image_encoder.named_parameters(
                   prefix="image_encoder"))


def test_the_optimizer_holds_state_for_bert(stepped):
    state = stepped["state"]
    params = {id(p) for p in state.params}
    bert = _bert(stepped["module"]).values()
    if stepped["kind"] == "trained":
        assert all(id(p) in params for p in bert)
        assert all(set(state.optimizer.state[p]) >= {"exp_avg",
                                                     "exp_avg_sq"}
                   for p in bert)
    else:
        assert not any(id(p) in params for p in bert)
        assert not any(p in state.optimizer.state for p in bert)


def test_the_clip_spans_both_towers(stepped):
    """The norm the clip divides by is the whole gradient's, BERT's leaves
    and the image tower's together, and BERT's first Adam moment is its
    gradient scaled by that clip."""
    state, module = stepped["state"], stepped["module"]
    grads = dict(zip(map(id, state.params), stepped["grads"]))
    sq = {id(p): float(torch.sum(grads[id(p)].double() ** 2))
          for p in state.params}
    bert = {id(p) for p in module.model.text_encoder.parameters()}
    whole = math.sqrt(sum(sq.values()))
    assert float(stepped["norm"]) == pytest.approx(whole, rel=1e-5)
    text = sum(v for k, v in sq.items() if k in bert)
    image = sum(v for k, v in sq.items() if k not in bert)
    assert image > 0
    if stepped["kind"] == "frozen":
        assert text == 0.0
        return
    assert text > 0 and whole > max(math.sqrt(text), math.sqrt(image))
    scale = min(1.0, stepped["clip"] / whole)
    assert scale < 1.0                  # the step clipped
    b1 = module.make_optimizer().b1
    for p in _bert(module).values():
        got = state.optimizer.state[p]["exp_avg"] / (1 - b1)
        torch.testing.assert_close(got, grads[id(p)] * scale, rtol=1e-4,
                                   atol=1e-9)


def test_gloria_words_counts_the_backwards_that_take_the_words(stepped):
    """One a micro-batch where BERT trains, none where it is frozen; the
    image side's backward runs either way."""
    words = stepped["counters"].get(trace.GLORIA_WORDS, 0)
    assert words == (stepped["accum"] if stepped["kind"] == "trained"
                     else 0)
