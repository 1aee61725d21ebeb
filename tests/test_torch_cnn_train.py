"""Classification fine-tuning on a CNN tower, and the surfaces that refuse
one, against the JAX package on the CPU.

  * one ``ClassificationModule`` step with resnet_18 + LoRA (the tower
    resizes 32² inputs to 299²), on the same weights (JAX's shapes drawn
    from a numpy seed, so the LoRA factors are live, carried by the strict
    bridge) and the same batch, against JAX's ``ClassificationModule``
    through ``build_train_step``: the loss, ``acc`` and ``grad_norm``, and
    the update by tests/test_torch_train.py's parameter policy, widened
    for ReLU kinks: loss and ``acc`` rtol 1e-5; ``grad_norm`` rtol 2e-4;
    every element within 2·lr of JAX's (the policy's bound for elements
    that rounding steers); each tensor's update at cosine > 0.95 to JAX's
    and the whole update at > 0.999 (the bf16 arm's test, tightened).
    Why: at 299² a ResNet-18 holds ~2.4M pre-ReLU values, and a few lie
    within ~3e-6 of zero, where float32 rounding decides the side (the
    port's float32 run against its float64 run flips 1-3 such elements a
    layer; JAX's float32 its own). A flip reroutes that element's whole
    gradient: ``grad_norm`` parted by 4.2e-5 relative, and Adam's first
    step, which moves an element by ±lr whatever its gradient's size,
    turned the sign of small gradients (the worst tensor: one of 64
    biases, cosine 0.983; the whole update 0.9999+). With LoRA the base
    kernels train too;
  * the linear probe (``freeze_encoder``) takes no gradient into the tower;
  * ``python -m medmoe_torch.cli.train model=classification
    model.vision.model_name=resnet_18 data=synthetic`` at tiny sizes;
  * the refusals, each beside what JAX does: pretraining, zero-shot and
    retrieval eval and classify-mode serving on a tower whose features are
    not the text tower's width (JAX fails inside its first product with a
    shape error; the port raises ValueError first, naming both widths);
    the linear probe and embed-mode serving run; ``norm=batch`` under the
    classification task (JAX's first step fails: no batch_stats
    collection).
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from medmoe_tpu.config import DotDict as JDotDict
from medmoe_tpu.config import compose as jcompose
from medmoe_tpu.eval import zero_shot as jzs
from medmoe_tpu.train.classification import ClassificationModule as JCls
from medmoe_tpu.train.optim import adam as jadam
from medmoe_tpu.train.state import TrainState as JState
from medmoe_tpu.train.step import build_train_step as jax_train_step
from medmoe_torch import bridge
from medmoe_torch.config import DotDict
from medmoe_torch.config import compose as tcompose
from medmoe_torch.eval import zero_shot as tzs
from medmoe_torch.models.medmoe import MedMoE
from medmoe_torch.train.classification import ClassificationModule
from medmoe_torch.train.module import MedMoEPretrainingModule
from medmoe_torch.train.optim import adam
from medmoe_torch.train.state import TrainState
from medmoe_torch.train.step import build_train_step
from tests.test_torch_cnn import drawn, flat

torch.set_num_threads(1)

LR, CLIP = 1e-3, 0.25
CNN = dict(model_name="resnet_18", lora=True, lora_r=4, lora_alpha=8,
           norm="group")


def _batch(seed=0, b=2):
    rng = np.random.RandomState(seed)
    return {"image": rng.randn(b, 32, 32, 3).astype(np.float32),
            "label": rng.randint(0, 3, b).astype(np.int32)}


@pytest.fixture(scope="module")
def one_step():
    batch = _batch()
    jm = JCls(num_classes=3, freeze_encoder=False, vision=JDotDict(CNN),
              optimizer=functools.partial(jadam, lr=LR))
    params = drawn(jax.eval_shape(jm.init_params, jax.random.PRNGKey(0),
                                  batch), 3)
    state = JState.create(params, jm.make_optimizer(gradient_clip_val=CLIP))
    state, jmetrics = jax_train_step(jm, accum_steps=1, donate=False)(
        state, batch, jax.random.PRNGKey(1))
    jax_final = bridge.from_jax_params(flat(jax.device_get(state.params)))

    tm = ClassificationModule(num_classes=3, freeze_encoder=False,
                              vision=DotDict(CNN),
                              optimizer=functools.partial(adam, lr=LR))
    init = bridge.from_jax_params(flat(params), model=tm.model)
    tm.model.load_state_dict(init)
    ts = TrainState.create(tm.model, tm.make_optimizer(CLIP))
    ts, tmetrics = build_train_step(tm, 1)(
        ts, [{k: torch.from_numpy(v) for k, v in batch.items()}])
    return ({k: float(v) for k, v in jmetrics.items()},
            {k: float(v) for k, v in tmetrics.items()}, init, jax_final,
            {k: v.detach() for k, v in tm.model.state_dict().items()}, tm)


class TestStepAgainstJax:
    @pytest.mark.parametrize("name", ["loss", "acc", "c_loss", "grad_norm"])
    def test_metrics(self, one_step, name):
        jm, tm = one_step[:2]
        rtol = 2e-4 if name == "grad_norm" else 1e-5
        np.testing.assert_allclose(tm[name], jm[name], rtol=rtol, atol=1e-6)

    def test_update(self, one_step):
        _, _, init, jax_final, torch_final, module = one_step
        moved = set()
        dots = nj = nt = 0.0
        for k, t in torch_final.items():
            w, t, i = jax_final[k].numpy(), t.numpy(), init[k].numpy()
            err = np.abs(t - w)
            assert err.max() <= 2 * LR, f"{k}: {err.max()}"
            dj, dt = (w - i).ravel(), (t - i).ravel()
            assert dj @ dt > 0.95 * np.sqrt((dj @ dj) * (dt @ dt)), k
            dots, nj, nt = dots + dj @ dt, nj + dj @ dj, nt + dt @ dt
            if np.abs(t - i).max() > 0:
                moved.add(k)
        assert dots / np.sqrt(nj * nt) > 0.999
        # JAX's trainable_mask freezes nothing here: the base kernels move
        # with their adapters, and the head
        for k in ("encoder.resnet.model.conv1.weight",
                  "encoder.resnet.model.conv1.lora_b",
                  "encoder.resnet.model.layer4_block1.conv2.weight",
                  "head.classifier.weight"):
            assert k in moved, k
        assert all(module.trainable_mask().values())

    def test_head_reads_the_backbone_width(self, one_step):
        module = one_step[-1]
        assert module.model.head.classifier.in_features == 512


def test_linear_probe_leaves_the_tower():
    tm = ClassificationModule(num_classes=3, freeze_encoder=True,
                              vision=DotDict(dict(CNN,
                                                  model_name="densenet_121")))
    tm.init_params(0)
    assert tm.model.head.classifier.in_features == 1024
    before = {k: v.clone() for k, v in tm.model.encoder.state_dict().items()}
    ts = TrainState.create(tm.model, tm.make_optimizer(CLIP))
    assert {id(p) for p in ts.params} == {
        id(p) for p in tm.model.head.parameters()}
    ts, m = build_train_step(tm, 1)(
        ts, [{k: torch.from_numpy(v) for k, v in _batch().items()}])
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    after = tm.model.encoder.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)


def test_cli_classification_on_resnet_18(tmp_path):
    from medmoe_torch.cli.train import main

    metrics = main([
        "experiment=pretraining_medmoe_ddp",
        "model=classification", "model.vision.model_name=resnet_18",
        "model.vision.lora=true", "model.vision.lora_r=2",
        "model.freeze_encoder=false", "model.num_classes=3",
        "model.multilabel=false", "data=synthetic", "data.num_samples=8",
        "data.batch_size=2", "data.image_size=32", "data.num_classes=3",
        "trainer.accelerator=cpu", "trainer.max_epochs=1",
        "trainer.limit_train_batches=2", "trainer.limit_val_batches=1",
        "trainer.num_sanity_val_steps=0", "callbacks=none", "logger=csv",
        "extras.print_config=false", f"paths.root_dir={tmp_path}"])
    for k in ("train/loss", "train/grad_norm", "val/loss"):
        assert np.isfinite(metrics[k]), k
    assert metrics["train/grad_norm"] > 0


# the eval surfaces at tiny widths: a 32-wide text tower
TINY = [
    "model.model.vision.model_name=resnet_18",
    "model.model.vision.image_size=32", "model.model.vision.dtype=float32",
    "model.model.text.hidden_size=32", "model.model.text.num_layers=1",
    "model.model.text.num_heads=2", "model.model.text.intermediate_size=64",
    "model.model.text.max_length=10", "model.model.text.dtype=float32",
    "data=synthetic", "data.num_samples=4", "data.image_size=32",
    "data.batch_size=2", "data.num_workers=0",
]


class TestRefusals:
    def test_pretraining(self):
        vision = dict(CNN, dtype="float32")
        text = dict(hidden_size=32, num_layers=1, num_heads=2,
                    intermediate_size=64, vocab_size=64, max_length=10,
                    dtype="float32")
        with pytest.raises(ValueError, match=r"512-wide global .* 256-wide "
                           r"local maps against the text tower's 32"):
            MedMoEPretrainingModule(
                model=MedMoE(DotDict(vision), DotDict(text)),
                loss=DotDict({}))
        # JAX: the local loss's einsum of the 256-wide map and the 32-wide
        # words raises on the first step
        from medmoe_tpu.train.module import MedMoEPretrainingModule as JMod

        jm = JMod(model=JDotDict(vision=JDotDict(vision),
                                 text=JDotDict(text)), loss=JDotDict({}))
        rng = np.random.RandomState(0)
        batch = {"image": rng.randn(2, 32, 32, 3).astype(np.float32),
                 "input_ids": rng.randint(0, 64, (2, 10)).astype(np.int32),
                 "attention_mask": np.ones((2, 10), np.int32),
                 "token_type_ids": np.zeros((2, 10), np.int32),
                 "segment_ids": np.tile(np.arange(10, dtype=np.int32),
                                        (2, 1)),
                 "cap_lens": np.full((2,), 10, np.int32),
                 "label": np.zeros((2,), np.int32)}
        params = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0), batch)
        with pytest.raises((TypeError, ValueError)):
            jax.eval_shape(jm.loss_fn, params, batch)

    @pytest.mark.parametrize("protocol", ["zero_shot", "retrieval"])
    def test_eval_protocols(self, tmp_path, protocol):
        over = TINY + [f"eval.protocol={protocol}",
                       f"paths.root_dir={tmp_path}"]
        with pytest.raises(ValueError, match=r"512-wide global features "
                           r"against the text tower's 32"):
            tzs.run_eval_zs(tcompose("eval_zs", over + ["device=cpu"]))
        # JAX: the image-text product raises a shape error
        with pytest.raises((TypeError, ValueError)):
            jzs.run_eval_zs(jcompose("eval_zs", over))

    def test_linear_probe_runs(self, tmp_path):
        over = TINY + ["eval.protocol=linear_probe",
                       "eval.linear_probe.epochs=1",
                       "eval.linear_probe.fractions=[1.0]",
                       f"paths.root_dir={tmp_path}"]
        got = tzs.run_eval_zs(tcompose("eval_zs", over + ["device=cpu"]))
        want = jzs.run_eval_zs(jcompose("eval_zs", over))
        assert set(got) == set(want) == {"linear_probe/acc@100%"}
        assert 0.0 <= got["linear_probe/acc@100%"] <= 1.0

    def test_serve(self, tmp_path, capsys):
        from PIL import Image

        from medmoe_torch.cli import serve

        scans = tmp_path / "scans"
        scans.mkdir()
        rng = np.random.RandomState(1)
        for i in range(2):
            Image.fromarray(rng.randint(0, 256, (40, 40, 3)).astype(
                np.uint8)).save(scans / f"{i}.png")
        over = TINY + ["device=cpu", f"serve.input={scans}",
                       f"paths.root_dir={tmp_path}"]
        with pytest.raises(ValueError, match="serve.mode=classify"):
            serve.main(over + ["serve.mode=classify"])
        capsys.readouterr()
        assert serve.main(over + ["serve.mode=embed"]) == 0
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("{")]
        assert len(lines) == 2 and all('"embedding"' in ln for ln in lines)
        assert sorted(os.path.basename(eval(ln)["path"]) for ln in lines) \
            == ["0.png", "1.png"]

    def test_batch_norm_classification(self):
        cfg = dict(CNN, norm="batch")
        with pytest.raises(ValueError, match="norm=batch"):
            ClassificationModule(num_classes=3, freeze_encoder=False,
                                 vision=DotDict(cfg))
        # JAX keeps params only: the first step finds no batch_stats
        jm = JCls(num_classes=3, freeze_encoder=False, vision=JDotDict(cfg))
        batch = _batch()
        params = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0), batch)
        with pytest.raises(Exception, match="batch_stats"):
            jax.eval_shape(lambda p: jm.loss_fn(p, batch, False), params)
