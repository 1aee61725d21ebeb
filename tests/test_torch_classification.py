"""The supervised classification task of the port
(medmoe_torch/train/classification.py, models/heads.py) on the CPU:

  * loss and ``acc`` against the JAX package's ``ClassificationModule.
    loss_fn`` on the same weights (JAX init → ``bridge``) and the same
    batch, for multiclass CE and multilabel BCE, with the encoder frozen
    and trained (float32; rtol 1e-5, atol 1e-5);
  * a frozen encoder takes no gradient and is absent from the optimizer;
  * two optimizer steps through the port's Trainer
    (``python -m medmoe_torch.cli.train model=classification``), with the
    encoder fine-tuned, and the eval CLI's test loop on what it trained.
"""

import jax
import numpy as np
import pytest
import torch

from medmoe_tpu.config import DotDict as JDotDict
from medmoe_tpu.train.classification import ClassificationModule as JCls
from medmoe_torch import bridge
from medmoe_torch.config import DotDict, compose
from medmoe_torch.train.classification import ClassificationModule

torch.set_num_threads(1)

VISION = dict(model_name="swin", embed_dim=32, use_moe=True, image_size=32,
              num_experts=3, moe_mode="gather", router_top_k=1,
              dtype="float32", swin_embed_dim=8, swin_depths=[1, 1],
              swin_num_heads=[1, 2], swin_window_size=4, drop_path_rate=0.0)
TOL = dict(rtol=1e-5, atol=1e-5)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _batch(multilabel, seed=0, b=6):
    rng = np.random.RandomState(seed)
    image = rng.randn(b, 32, 32, 3).astype(np.float32)
    label = (rng.rand(b, 4) > 0.5).astype(np.float32) if multilabel \
        else rng.randint(0, 4, b).astype(np.int32)
    return {"image": image, "label": label}


def _pair(multilabel, freeze):
    jmod = JCls(num_classes=4, freeze_encoder=freeze, multilabel=multilabel,
                vision=JDotDict(VISION))
    batch = _batch(multilabel)
    params = jax.jit(jmod.init_params)(jax.random.PRNGKey(0), batch)
    tmod = ClassificationModule(num_classes=4, freeze_encoder=freeze,
                                multilabel=multilabel,
                                vision=DotDict(VISION))
    bridge.load_jax_params(tmod.model, _flat(jax.device_get(params)))
    return jmod, params, tmod, batch


class TestLossAgainstJax:
    @pytest.mark.parametrize("multilabel", [False, True])
    @pytest.mark.parametrize("freeze", [True, False])
    def test_loss_and_acc(self, multilabel, freeze):
        jmod, params, tmod, batch = _pair(multilabel, freeze)
        jloss, jm = jmod.loss_fn(params, batch)
        tmod.model.eval()
        tloss, tm = tmod.loss_fn({k: torch.from_numpy(v)
                                  for k, v in batch.items()})
        np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                                   **TOL)
        for k in ("loss", "acc", "c_loss", "c_acc", "l_loss", "g_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL,
                                       err_msg=k)


class TestFrozenEncoder:
    def test_no_gradient_and_not_in_the_optimizer(self):
        mod = ClassificationModule(num_classes=4, freeze_encoder=True,
                                   vision=DotDict(VISION))
        mod.init_params(0)
        opt = mod.make_optimizer().init(mod.model.parameters())
        held = {id(p) for g in opt.param_groups for p in g["params"]}
        names = {n for n, p in mod.model.named_parameters()
                 if id(p) in held}
        assert names == {"head.classifier.weight", "head.classifier.bias"}
        mask = mod.trainable_mask()
        assert not any(v for k, v in mask.items() if k.startswith("encoder."))
        batch = {k: torch.from_numpy(v) for k, v in _batch(False).items()}
        loss, _ = mod.loss_fn(batch)
        loss.backward()
        assert all(p.grad is None for p in mod.model.encoder.parameters())
        assert mod.model.head.classifier.weight.grad is not None


TRAIN = [
    "experiment=pretraining_medmoe_ddp", "model=classification",
    "model.num_classes=6", "model.multilabel=false",
    "model.freeze_encoder=false", "data=synthetic", "data.num_samples=16",
    "data.batch_size=4", "data.image_size=32",
    "trainer.accelerator=cpu", "trainer.max_epochs=1",
    "trainer.limit_train_batches=4", "trainer.accumulate_grad_batches=2",
    "trainer.limit_val_batches=1", "trainer.num_sanity_val_steps=0",
    "trainer.log_every_n_steps=1", "callbacks=none", "logger=csv",
    "extras.print_config=false",
] + [f"model.model.vision.{k}={v}".replace(" ", "")
     for k, v in VISION.items() if k != "model_name"]


class TestTrainer:
    def test_two_steps_then_eval(self, tmp_path, capsys):
        import json

        from medmoe_torch.cli import eval as teval
        from medmoe_torch.cli.train import train
        from medmoe_torch.models.medmoe import init_weights
        from medmoe_torch.utils.checkpoint import save_checkpoint

        cfg = compose("train", TRAIN + [f"paths.root_dir={tmp_path}"])
        metrics, objs = train(cfg)
        trainer, module = objs["trainer"], objs["module"]
        assert trainer.state.step == 2
        for k in ("train/loss", "train/acc", "val/loss", "val/acc"):
            assert np.isfinite(metrics[k]), k
        assert 0.0 <= metrics["train/acc"] <= 1.0
        init = init_weights(ClassificationModule(
            num_classes=6, freeze_encoder=False,
            vision=DotDict(VISION)).model, cfg.seed).state_dict()
        now = module.model.state_dict()
        for k in ("encoder.swin_moe.swin.patch_embed.proj.weight",
                  "head.classifier.weight"):
            assert not torch.equal(now[k], init[k]), k
        # the eval CLI's test loop on what the trainer holds
        path = str(tmp_path / "ckpt")
        save_checkpoint(path, trainer.state)
        out = teval.main([o for o in TRAIN if not o.startswith(
            ("trainer.", "experiment=", "callbacks="))] + [
            "trainer.accelerator=cpu", "trainer.limit_test_batches=2",
            f"ckpt_path={path}", f"paths.root_dir={tmp_path}"])
        printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert printed == out and np.isfinite(out["test/loss"])
        assert set(out) >= {"test/loss", "test/acc"}

    @pytest.mark.parametrize("cli", ["train", "eval"])
    def test_cuda_default_raises_without_a_card(self, tmp_path, monkeypatch,
                                                cli):
        from medmoe_torch.cli import eval as teval
        from medmoe_torch.cli import train as ttrain

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        over = [o for o in TRAIN if o != "trainer.accelerator=cpu"] + [
            f"paths.root_dir={tmp_path}"]
        with pytest.raises(RuntimeError, match="trainer.accelerator=cpu"):
            if cli == "train":
                ttrain.main(over)
            else:
                teval.main([o for o in over if not o.startswith(
                    ("trainer.", "experiment=", "callbacks="))])
