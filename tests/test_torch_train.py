"""The port's training step, loop and CLI against the JAX package.

  * trajectory: the same weights (carried JAX → weights.npz → bridge) and
    the same numpy batches through 3 optimizer steps of 2 accumulated
    micro-batches each, clip 0.25 and Adam, on JAX ``build_train_step``
    and the port's ``build_train_step``; per-step loss terms and the
    pre-clip ``grad_norm``, and the parameters at the end;
  * the CLI end to end on the CPU at tiny size, the synthetic data, the
    training-mode generators, the CPU-only guarantees.

Tolerances. float32 checks the algorithm: metrics rtol 1e-5; parameters
within 1e-2 of their own update (max |Δ|) — except the few whose gradient
is zero in exact arithmetic (attention key biases, ``attn_b2``: a constant
added before a softmax), where both sides follow rounding noise through
Adam's normalization, which caps each step at about lr, so 2·steps·lr.
bfloat16 checks the rounding policy: metrics rtol 2e-2 (one bf16 ulp is
2^-8 and flips compound through the towers), and Adam's sign-like update
turns those flips into ±lr moves of single elements, so the parameters are
held by the direction of their whole update (cosine > 0.9) and the 2·steps·lr
bound.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from medmoe_tpu.config import DotDict as JDotDict
from medmoe_tpu.eval.export import _save_weights
from medmoe_tpu.train.module import MedMoEPretrainingModule as JModule
from medmoe_tpu.train.optim import adam as jadam
from medmoe_tpu.train.state import TrainState as JState
from medmoe_tpu.train.step import build_train_step as jax_train_step
from medmoe_torch import bridge
from medmoe_torch.config import DotDict
from medmoe_torch.models.layers import set_generator
from medmoe_torch.models.medmoe import MedMoE
from medmoe_torch.ops import expert_fusion as ef
from medmoe_torch.train import loop
from medmoe_torch.train.module import MedMoEPretrainingModule
from medmoe_torch.train.optim import adam, clip_by_global_norm
from medmoe_torch.train.state import TrainState
from medmoe_torch.train.step import build_eval_step, build_train_step

torch.set_num_threads(1)

LR, B, ACC, STEPS = 1e-3, 4, 2, 3
METRICS = ("loss", "l_loss", "g_loss", "c_loss", "grad_norm")
VISION = dict(model_name="swin", use_moe=True, embed_dim=32, num_experts=3,
              moe_mode="gather", image_size=64, swin_embed_dim=8,
              swin_depths=[1, 1, 1, 1], swin_num_heads=[1, 2, 2, 4],
              swin_window_size=2, drop_path_rate=0.0)
TEXT = dict(last_n_layers=2, aggregate_method="sum", max_length=10,
            embed_dim=32, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, vocab_size=200, freeze_bert=True,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
LOSS = dict(global_loss_weight=0.5, local_loss_weight=0.5,
            classifier_loss_weight=2.0, temp1=4.0, temp2=5.0, temp3=10.0,
            agg="sum", global_negatives=False, block_size=2)
TINY_OVERRIDES = [
    "data=synthetic", "data.batch_size=4", "data.num_samples=16",
    "data.image_size=56", "data.num_classes=3",
    "model.model.vision.image_size=56", "model.model.vision.swin_embed_dim=8",
    "model.model.vision.swin_depths=[1,1]",
    "model.model.vision.swin_num_heads=[1,2]",
    "model.model.vision.num_experts=3", "model.model.vision.embed_dim=16",
    "model.model.vision.dtype=float32", "model.model.text.hidden_size=16",
    "model.model.text.num_layers=2", "model.model.text.num_heads=2",
    "model.model.text.intermediate_size=32", "model.model.text.vocab_size=64",
    "model.model.text.embed_dim=16", "model.model.text.max_length=10",
    "model.model.text.dtype=float32", "trainer.accelerator=cpu",
    "extras.print_config=false",
]


def _micro(rng):
    ids = rng.randint(0, 200, (B, 10)).astype(np.int32)
    mask = np.zeros((B, 10), np.int32)
    segs = np.full((B, 10), -1, np.int32)
    cap = np.zeros(B, np.int32)
    for i in range(B):
        n = 4 + i
        mask[i, :n] = 1
        segs[i, :n] = [0, 1, 2, 2] + list(range(3, n - 1))
        cap[i] = segs[i].max() + 1
    return {"image": rng.randn(B, 64, 64, 3).astype(np.float32),
            "input_ids": ids, "attention_mask": mask,
            "token_type_ids": np.zeros((B, 10), np.int32),
            "segment_ids": segs, "cap_lens": cap,
            "label": rng.randint(0, 3, B).astype(np.int32)}


def _stack(window):
    return {k: np.stack([m[k] for m in window]) for k in window[0]}


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def trajectories(request, tmp_path_factory):
    dt = request.param
    vision, text = dict(VISION, dtype=dt), dict(TEXT, dtype=dt)
    rng = np.random.RandomState(0)
    windows = [[_micro(rng) for _ in range(ACC)] for _ in range(STEPS)]

    jm = JModule(model=JDotDict(vision=JDotDict(vision), text=JDotDict(text)),
                 loss=JDotDict(LOSS), optimizer=functools.partial(jadam, lr=LR))
    params = jax.jit(jm.init_params)(jax.random.PRNGKey(0), windows[0][0])
    path = str(tmp_path_factory.mktemp(dt) / "weights.npz")
    _save_weights(path, params)
    state = JState.create(params, jm.make_optimizer(gradient_clip_val=0.25))
    step = jax_train_step(jm, accum_steps=ACC, donate=False)
    jax_metrics = []
    for w in windows:
        state, m = step(state, _stack(w), jax.random.PRNGKey(1))
        jax_metrics.append({k: float(v) for k, v in m.items()})
    jax_final = bridge.from_jax_params(
        {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(leaf)
         for kp, leaf in jax.tree_util.tree_leaves_with_path(state.params)})

    init = bridge.load_npz(path)
    model = bridge.load_jax_params(MedMoE(DotDict(vision), DotDict(text)), init)
    module = MedMoEPretrainingModule(model=model, loss=DotDict(LOSS),
                                     optimizer=functools.partial(adam, lr=LR))
    ts = TrainState.create(model, module.make_optimizer(0.25))
    tstep = build_train_step(module, ACC)
    launches = (ef.LAUNCHES, ef.BWD_LAUNCHES)
    torch_metrics = []
    for w in windows:
        ts, m = tstep(ts, [{k: torch.from_numpy(v) for k, v in mb.items()}
                           for mb in w])
        torch_metrics.append({k: float(v) for k, v in m.items()})
    assert (ef.LAUNCHES, ef.BWD_LAUNCHES) == launches    # CPU: no kernel
    return (dt, jax_metrics, torch_metrics, bridge.from_jax_params(init),
            jax_final, {k: v.detach() for k, v in model.state_dict().items()},
            module)


ZERO_GRAD = ("key.bias", "attn_b2")


class TestTrajectory:
    @pytest.mark.parametrize("name", METRICS)
    def test_per_step_metrics(self, trajectories, name):
        dt, jm, tm = trajectories[:3]
        rtol = 1e-5 if dt == "float32" else 2e-2
        np.testing.assert_allclose([m[name] for m in tm],
                                   [m[name] for m in jm], rtol=rtol,
                                   atol=1e-6)

    def test_final_parameters(self, trajectories):
        dt, _, _, init, jax_final, torch_final, module = trajectories
        bound = 2 * STEPS * LR
        dots = nj = nt = 0.0
        for k, t in torch_final.items():
            w, t, i = jax_final[k].numpy(), t.numpy(), init[k].numpy()
            err = np.abs(t - w).max()
            if not module.model.get_parameter(k).requires_grad:
                assert np.array_equal(t, i) and np.array_equal(w, i), k
                continue
            assert err <= bound, f"{k}: {err} > {bound}"
            dj, dtt = (w - i).ravel(), (t - i).ravel()
            dots += float(dj @ dtt)
            nj += float(dj @ dj)
            nt += float(dtt @ dtt)
            if dt == "float32" and not k.endswith(ZERO_GRAD):
                assert err <= 1e-2 * np.abs(w - i).max() + 1e-7, k
        assert dots / np.sqrt(nj * nt) > 0.9

    def test_frozen_bert_has_no_optimizer_state(self, trajectories):
        module = trajectories[-1]
        bert = set(map(id, module.model.text_encoder.bert.parameters()))
        ts = TrainState.create(module.model, module.make_optimizer(0.25))
        assert bert and not bert & set(map(id, ts.params))
        assert not any(module.trainable_mask()[n] for n, _ in
                       module.model.text_encoder.bert.named_parameters(
                           prefix="text_encoder.bert"))


class TestOptim:
    def test_clip_is_optax_formula(self):
        g = [torch.tensor([3.0, 4.0]), torch.tensor([0.0])]
        out = clip_by_global_norm(g, 1.0)
        assert torch.equal(out[0], torch.tensor([3.0, 4.0]) / 5.0 * 1.0)
        kept = clip_by_global_norm(g, 10.0)
        assert torch.equal(kept[0], g[0])

    def test_plateau_matches_jax(self):
        from medmoe_tpu.train.optim import reduce_lr_on_plateau as J
        from medmoe_torch.train.optim import reduce_lr_on_plateau as T

        j, t = J(patience=1), T(patience=1)
        lj = lt = 1e-3
        for v in [3.0, 2.0, 2.5, 2.6, 2.7, 1.0, 1.5, 1.6]:
            lj, lt = j.step(v, lj), t.step(v, lt)
            assert lj == lt


class TestData:
    def test_synthetic_batches_equal_jax(self):
        from medmoe_tpu.data.datamodules import SyntheticDataModule as J
        from medmoe_torch.data.datamodules import SyntheticDataModule as T

        kw = dict(batch_size=3, num_samples=7, image_size=8, num_classes=3,
                  seed=5, max_length=10)
        j, t = J(**kw), T(**kw)
        assert t.steps_per_epoch == j.steps_per_epoch == 2
        for lj, lt in [(j.train_dataloader(epoch=1), t.train_dataloader(1)),
                       (j.val_dataloader(), t.val_dataloader())]:
            bj, bt = list(lj), list(lt)
            assert len(bj) == len(bt) == 2
            for a, b in zip(bj, bt):
                assert a.keys() == b.keys()
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])


def _tiny_module(drop: float):
    vision = dict(VISION, dtype="float32", drop_path_rate=drop)
    text = dict(TEXT, dtype="float32", hidden_dropout_prob=drop,
                attention_probs_dropout_prob=drop, freeze_bert=False)
    model = MedMoE(DotDict(vision), DotDict(text))
    module = MedMoEPretrainingModule(model=model, loss=DotDict(LOSS))
    module.init_params(0)
    return module


class TestGenerators:
    def test_seeded_noise_repeats_and_seeds_differ(self):
        module = _tiny_module(0.3)
        module.model.train()
        batch = {k: torch.from_numpy(v)
                 for k, v in _micro(np.random.RandomState(1)).items()}

        def loss(seed):
            set_generator(module.model, torch.Generator().manual_seed(seed))
            with torch.no_grad():
                return module.loss_fn(batch)[0].item()

        assert loss(1) == loss(1)
        assert loss(1) != loss(2)
        module.model.eval()                   # no noise in eval mode
        assert loss(1) == loss(2)

    def test_trainer_generator_depends_on_seed_and_epoch(self):
        a = loop.Trainer(accelerator="cpu", seed=3)
        draws = {(s, e): torch.rand(4, generator=loop.Trainer(
            accelerator="cpu", seed=s).epoch_generator(e)).tolist()
            for s in (3, 4) for e in (0, 1)}
        assert len({tuple(v) for v in draws.values()}) == 4
        assert torch.rand(4, generator=a.epoch_generator(0)).tolist() == \
            draws[(3, 0)]


class TestEntryPoints:
    def test_cli_fdr_end_to_end(self, tmp_path):
        from medmoe_torch.cli.train import main

        metrics = main(["experiment=pretraining_medmoe_ddp", "debug=fdr",
                        f"paths.root_dir={tmp_path}"] + TINY_OVERRIDES)
        assert np.isfinite(metrics["train/loss"])
        assert np.isfinite(metrics["val/loss"])
        assert metrics["train/grad_norm"] > 0 and metrics["pairs_per_sec"] > 0

    @pytest.mark.parametrize("extra,steps", [
        # a window of 3, then the leftover 1 flushed at epoch end
        (["trainer.max_epochs=1", "trainer.accumulate_grad_batches=3",
          "trainer.limit_train_batches=4"], 2),
        # 2 cached device batches, a window of 2 once an epoch
        (["trainer.max_epochs=2", "trainer.accumulate_grad_batches=2",
          "trainer.overfit_batches=2"], 2)])
    def test_accumulation_windows(self, tmp_path, extra, steps):
        from medmoe_torch.cli.train import train
        from medmoe_torch.config import compose

        cfg = compose("train", ["experiment=pretraining_medmoe_ddp",
                                f"paths.root_dir={tmp_path}",
                                "trainer.limit_val_batches=1",
                                "trainer.num_sanity_val_steps=1",
                                "trainer.log_every_n_steps=1"]
                      + TINY_OVERRIDES + extra)
        _, objs = train(cfg)
        trainer = objs["trainer"]
        assert trainer.state.step == steps
        assert all(h["pairs_per_sec"] > 0 and np.isfinite(h["val/loss"])
                   for h in trainer.metrics_history)

    def test_gpu_without_card_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="accelerator=cpu"):
            loop.Trainer(accelerator="gpu")

    @pytest.mark.parametrize("kw", [dict(devices=2), dict(num_nodes=2),
                                    dict(mesh={"expert": 2}),
                                    dict(profiler="simple"),
                                    dict(devices="2")])
    def test_unported_trainer_options_raise(self, kw):
        with pytest.raises(NotImplementedError):
            loop.Trainer(accelerator="cpu", **kw)

    def test_soft_label_and_resume_raise(self):
        with pytest.raises(NotImplementedError, match="soft_label"):
            MedMoEPretrainingModule(
                model=MedMoE(DotDict(dict(VISION, dtype="float32")),
                             DotDict(TEXT)),
                loss=DotDict(LOSS, soft_label=True))
        # resume is ported: a checkpoint that is not there raises before
        # any step
        with pytest.raises(FileNotFoundError):
            loop.Trainer(accelerator="cpu").fit(
                _tiny_module(0.0), None, ckpt_path="no/such/checkpoint")

    def test_unported_messages_name_a_live_roadmap_queue(self):
        """A "not ported yet" message names its ROADMAP.md queue without an
        item number: items are renumbered as they land (the soft-label one
        named an item 14 that no longer existed)."""
        import pathlib
        import re

        with pytest.raises(NotImplementedError) as err:
            MedMoEPretrainingModule(
                model=MedMoE(DotDict(dict(VISION, dtype="float32")),
                             DotDict(TEXT)),
                loss=DotDict(LOSS, soft_label=True))
        assert "(ROADMAP.md Queue 1)" in str(err.value)
        port = pathlib.Path(__file__).resolve().parents[1] / "medmoe_torch"
        stale = [str(f) for f in port.rglob("*.py")
                 if re.search(r"Queue \d+ item", f.read_text())]
        assert not stale

    def test_eval_step_is_deterministic(self):
        module = _tiny_module(0.3)
        batch = {k: torch.from_numpy(v)
                 for k, v in _micro(np.random.RandomState(2)).items()}
        step = build_eval_step(module)
        assert step(batch)["loss"].item() == step(batch)["loss"].item()
