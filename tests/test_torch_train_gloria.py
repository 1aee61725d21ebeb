"""The slice of experiment=gloria256 against the JAX package: whole-batch
(global negatives) contrastive losses with the local loss through the
fused GLoRIA similarity (``local_loss.impl: pallas``).

  * trajectory: the same weights (carried JAX → weights.npz → bridge) and
    the same numpy batches through 2 optimizer steps of 2 accumulated
    micro-batches, clip 0.25 and Adam, at tiny float32 widths; JAX
    ``build_train_step`` runs its Pallas kernels in interpret mode, the
    port runs their plain versions (the tensors lie on the CPU);
  * the experiment configs compose with the JAX package's values.

Tolerances. The fused similarity rounds its inputs to bf16 on both sides,
and the towers' float32 outputs differ between the frameworks by f32
summation order, so a rare element lands on the other side of a bf16
rounding boundary, as in a bf16 trajectory. The first step starts from the
same weights: metrics rtol 2e-5. Adam's update divides by the root of the
second moment, so a gradient element near zero moves by about ±lr whatever
its size, and the weights after the first step differ by such moves: later
metrics rtol 5e-4 (measured 1.1e-4), every parameter within 2·steps·lr of
JAX's, and the whole update's direction the same (cosine > 0.999; measured
0.99999).
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from medmoe_tpu.config import DotDict as JDotDict
from medmoe_tpu.eval.export import _save_weights
from medmoe_tpu.train.module import MedMoEPretrainingModule as JModule
from medmoe_tpu.train.optim import adam as jadam
from medmoe_tpu.train.state import TrainState as JState
from medmoe_tpu.train.step import build_train_step as jax_train_step
from medmoe_torch import bridge
from medmoe_torch.config import DotDict, compose
from medmoe_torch.models.medmoe import MedMoE
from medmoe_torch.ops import gloria_attention as ga
from medmoe_torch.train.module import MedMoEPretrainingModule
from medmoe_torch.train.optim import adam
from medmoe_torch.train.state import TrainState
from medmoe_torch.train.step import build_train_step

from test_torch_train import METRICS, TEXT, VISION, _micro, _stack

torch.set_num_threads(1)

LR, ACC, STEPS = 1e-3, 2, 2
LOSS = dict(global_loss_weight=0.5, local_loss_weight=0.5,
            classifier_loss_weight=2.0, temp1=4.0, temp2=5.0, temp3=10.0,
            agg="sum", global_negatives=True)


def _local(package):
    return {"_target_": f"{package}.ops.losses.GLORIALocalContrastiveLoss",
            "impl": "pallas"}


@pytest.fixture(scope="module")
def trajectory(tmp_path_factory):
    vision, text = dict(VISION, dtype="float32"), dict(TEXT, dtype="float32")
    rng = np.random.RandomState(0)
    windows = [[_micro(rng) for _ in range(ACC)] for _ in range(STEPS)]

    jm = JModule(model=JDotDict(vision=JDotDict(vision), text=JDotDict(text)),
                 loss=JDotDict(LOSS, local_loss=JDotDict(_local("medmoe_tpu"))),
                 optimizer=functools.partial(jadam, lr=LR))
    params = jax.jit(jm.init_params)(jax.random.PRNGKey(0), windows[0][0])
    path = str(tmp_path_factory.mktemp("gloria") / "weights.npz")
    _save_weights(path, params)
    state = JState.create(params, jm.make_optimizer(gradient_clip_val=0.25))
    step = jax_train_step(jm, accum_steps=ACC, donate=False)
    jax_metrics = []
    with pltpu.force_tpu_interpret_mode():
        for w in windows:
            state, m = step(state, _stack(w), jax.random.PRNGKey(1))
            jax_metrics.append({k: float(v) for k, v in m.items()})
    jax_final = bridge.from_jax_params(
        {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(leaf)
         for kp, leaf in jax.tree_util.tree_leaves_with_path(state.params)})

    init = bridge.load_npz(path)
    model = bridge.load_jax_params(MedMoE(DotDict(vision), DotDict(text)), init)
    module = MedMoEPretrainingModule(
        model=model, loss=DotDict(LOSS, local_loss=_local("medmoe_torch")),
        optimizer=functools.partial(adam, lr=LR))
    ts = TrainState.create(model, module.make_optimizer(0.25))
    tstep = build_train_step(module, ACC)
    launches = (ga.LAUNCHES, ga.DCTX_LAUNCHES, ga.DWORDS_LAUNCHES)
    torch_metrics = []
    for w in windows:
        ts, m = tstep(ts, [{k: torch.from_numpy(v) for k, v in mb.items()}
                           for mb in w])
        torch_metrics.append({k: float(v) for k, v in m.items()})
    assert (ga.LAUNCHES, ga.DCTX_LAUNCHES, ga.DWORDS_LAUNCHES) == launches
    return (jax_metrics, torch_metrics, bridge.from_jax_params(init),
            jax_final, {k: v.detach() for k, v in model.state_dict().items()},
            module)


class TestTrajectory:
    def test_the_fused_path_is_taken(self, trajectory):
        module = trajectory[-1]
        assert module.block_size is None
        assert module.local_loss.impl == "pallas"

    @pytest.mark.parametrize("name", METRICS)
    def test_per_step_metrics(self, trajectory, name):
        jm, tm = trajectory[:2]
        got, want = [m[name] for m in tm], [m[name] for m in jm]
        np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(got[1:], want[1:], rtol=5e-4, atol=1e-6)

    def test_final_parameters(self, trajectory):
        _, _, init, jax_final, torch_final, module = trajectory
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
        assert dots / np.sqrt(nj * nt) > 0.999


class TestConfigs:
    @pytest.mark.parametrize("experiment,accum", [("gloria256", 1),
                                                  ("pretraining_medmoe", 10)])
    def test_experiment_composes(self, experiment, accum):
        from medmoe_tpu.config import compose as jcompose

        cfg = compose("train", [f"experiment={experiment}"])
        ref = jcompose("train", [f"experiment={experiment}"])
        assert cfg.trainer.accelerator == "gpu"
        # the callback stack composes as the JAX package's, port targets
        assert sorted(cfg.callbacks) == sorted(ref.callbacks)
        for name, node in cfg.callbacks.items():
            want = dict(ref.callbacks[name])
            assert node["_target_"] == want.pop("_target_").replace(
                "medmoe_tpu.", "medmoe_torch.")
            assert {k: v for k, v in node.items() if k != "_target_"} == want
        assert cfg.trainer.min_epochs == ref.trainer.min_epochs == 1
        assert cfg.trainer.accumulate_grad_batches == accum \
            == ref.trainer.accumulate_grad_batches
        for key in ("seed", "data.batch_size", "trainer.gradient_clip_val",
                    "model.optimizer.lr", "model.loss.global_negatives"):
            a, b = cfg, ref
            for part in key.split("."):
                a, b = a[part], b[part]
            assert a == b, key
        assert cfg.data.batch_size == 256 and cfg.model.loss.global_negatives
        assert cfg.model.loss.local_loss._target_ == \
            "medmoe_torch.ops.losses.GLORIALocalContrastiveLoss"
