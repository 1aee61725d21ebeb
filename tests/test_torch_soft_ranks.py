"""Soft-label pretraining of the port over ranks and across a resume,
against the JAX package on the same weights (the port's seeded init
carried into JAX's tree; helpers in tests/test_torch_soft.py):

  * two gloo ranks (``trainer=ddp_sim``) against JAX's ``make_mesh(data=2)``
    step and a 1 × 2 expert grid (``trainer=ep``, ``moe_mode=ep``) against
    ``make_mesh(data=1, expert=2)``, the soft global and local losses over
    the global batch, BERT training: the step's metrics and the update;
  * 2 straight steps against 1 + save + resume + 1, bit for bit: the
    resumed run scores with the seed's BERT, and the snapshot is in no
    state.

Tolerances are tests/test_torch_train.py's: float32 metrics rtol 1e-5;
parameters within 1e-2 of their own update.
"""

import csv
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

import medmoe_tpu
from medmoe_tpu.parallel.mesh import make_mesh
from medmoe_tpu.parallel.sharding import param_shardings
from medmoe_tpu.train.state import TrainState as JState
from medmoe_tpu.train.step import build_train_step as jax_train_step
from medmoe_tpu.utils.instantiate import instantiate as jinstantiate
from medmoe_torch import bridge
from medmoe_torch.cli.train import train
from medmoe_torch.config import compose
from medmoe_torch.train.state import param_count
from medmoe_torch.utils.instantiate import instantiate
from tests.test_torch_ep import BASE as EP_BASE
from tests.test_torch_ep import MODES, _global_batches, _grid_trainer
from tests.test_torch_parallel import (METRICS, ROOT, Launch,
                                       _assert_params, _load_state,
                                       _step_rows)
from tests.test_torch_soft import (RESUME, _key, _torch_batch,
                                   jax_params_from, pick_thresholds,
                                   soft_overrides)

torch.set_num_threads(1)


def _seed_module(overrides):
    """The port module as the trainer initializes it (the seed's)."""
    cfg = compose("train", overrides)
    module = instantiate(cfg.model)
    module.init_params(cfg.seed)
    return module


# tests/test_torch_ep.py's gloria256 at a node batch of 8, one step, with
# Adam eps 1e-5. With BERT training at this width some elements' clipped
# gradient is near eps, where the update lr·g/(|g| + eps) follows the
# packages' f32 rounding: the port's two ranks equal its one process on
# the same batches to 2.7e-7 and JAX's mesh step its single device to
# 3.8e-7, the step-1 gradients of the packages agree to 8e-5·max|g| in
# every tensor (as with the hard losses), yet at eps 1e-6 one BERT
# attention_output element moved 1.4% of the update apart after one step,
# and over two steps (eps 1e-5) the second grad_norm parted by 1.0e-5
# relative. The two-step trajectory is held in one process
# (TestOneProcess: eps 1e-6, parameters within 2.3e-3 of their update)
# and across a resume (TestResume).
BASE = EP_BASE + ["model.optimizer.eps=1e-5", "trainer.limit_train_batches=1"]
RANK_STEPS = 1
# name → (extra overrides, data ranks, expert ranks, trainer overrides)
GRIDS = {"ddp": ([], 2, 1, ["trainer=ddp_sim"]),
         "ep": (MODES["ep"], 1, 2, _grid_trainer(2))}


def _workers(tmp, name, overrides, world):
    out = str(tmp / name)
    spec = dict(task="train", overrides=overrides, world=world, out=out,
                init=f"file://{tmp / (name + '.store')}")
    path = tmp / f"{name}.json"
    path.write_text(json.dumps(spec))
    return Launch([[sys.executable, "-m", "tests.torch_rank_worker",
                    str(path), str(r)] for r in range(world)], ROOT)


def _jax_mesh_trajectory(module, overrides, batches, d, e):
    """JAX's train step on make_mesh(d, e) (the bank sharded over
    ``expert`` when e > 1) from the port module's weights, with the tool
    BERT captured from them and replicated over the mesh, as JAX's
    Trainer does; (per-step metrics, final params)."""
    jm = jinstantiate(medmoe_tpu.compose("train", overrides).model)
    template = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0),
                              batches[0])
    params = jax_params_from(module.model, template)
    jm.capture_tool_params(params)
    mesh = make_mesh(data=d, expert=e, devices=jax.devices()[:d * e])
    params = jax.tree_util.tree_map(
        jax.device_put, params, param_shardings(params, mesh, e > 1))
    repl = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    jm.tool_bert_params = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, repl), jm.tool_bert_params)
    state = JState.create(params, jm.make_optimizer(gradient_clip_val=0.25))
    step = jax_train_step(jm, mesh=mesh, accum_steps=1, donate=False)
    metrics = []
    for batch in batches:
        state, m = step(state, batch, jax.random.PRNGKey(1))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, bridge.from_jax_params(
        {_key(kp): np.asarray(v)
         for kp, v in jax.tree_util.tree_leaves_with_path(state.params)})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Starts the two-rank runs, computes JAX's mesh steps while they run,
    and returns both."""
    tmp = tmp_path_factory.mktemp("soft_ranks")
    mods = {n: _seed_module(BASE + g[0] + soft_overrides(
        "medmoe_torch", (0.9, 0.5))) for n, g in GRIDS.items()}
    batches = {n: _global_batches(BASE, g[1])[:RANK_STEPS]
               for n, g in GRIDS.items()}
    mod = mods["ddp"]
    with torch.no_grad():
        mats = [mod.soft_targets(_torch_batch(b))[0]
                for bs in batches.values() for b in bs]
    thr = pick_thresholds(mats)
    launches = {}
    for name, (extra, d, e, trainer) in GRIDS.items():
        launches[name] = _workers(tmp, name, BASE + extra + soft_overrides(
            "medmoe_torch", thr) + trainer + [
            "callbacks=default", "trainer.limit_val_batches=1",
            f"paths.root_dir={tmp / name}"], d * e)
    jax_runs = {}
    for name, (extra, d, e, _) in GRIDS.items():
        jextra = [o.replace("medmoe_torch", "medmoe_tpu") for o in extra]
        jax_runs[name] = _jax_mesh_trajectory(
            mods[name], BASE + jextra + soft_overrides("medmoe_tpu", thr),
            batches[name], d, e)
    for launch in launches.values():
        launch.wait()
    return dict(tmp=tmp, jax=jax_runs, thr=thr, mats=mats,
                init={n: {k: v.detach().clone()
                          for k, v in m.model.state_dict().items()}
                      for n, m in mods.items()},
                trainable={n: {k: p.requires_grad
                               for k, p in m.model.named_parameters()}
                           for n, m in mods.items()})


class TestRanks:
    @pytest.mark.parametrize("grid", list(GRIDS))
    @pytest.mark.parametrize("name", METRICS)
    def test_per_step_metrics(self, ranks, grid, name):
        """Two gloo ranks of data (trainer=ddp_sim) and a 1 × 2 expert
        grid (moe_mode=ep) against JAX's step on the same mesh."""
        rows = _step_rows(str(ranks["tmp"] / grid))
        want = [m[name] for m in ranks["jax"][grid][0]]
        assert len(rows) == len(want) == RANK_STEPS
        np.testing.assert_allclose([r[f"train/{name}"] for r in rows], want,
                                   rtol=1e-5, atol=1e-6)
        if name in ("l_loss", "g_loss"):
            assert all(v != 0.0 for v in want)

    @pytest.mark.parametrize("grid", list(GRIDS))
    def test_final_parameters(self, ranks, grid):
        root = ranks["tmp"] / grid / "logs/train/runs/checkpoints/last"
        got = _load_state(str(root))
        _assert_params(got, ranks["jax"][grid][1], ranks["init"][grid],
                       RANK_STEPS, ranks["trainable"][grid])

    def test_partition_is_not_degenerate(self, ranks):
        thr0, thr1 = ranks["thr"]
        for s in ranks["mats"]:
            s = s.numpy()
            off = ~np.eye(len(s), dtype=bool)
            assert np.any((s > thr0) & off) and np.any(s <= thr1)
            assert np.any((s > thr1) & (s <= thr0))


def _last(root):
    return str(root / "logs/train/runs/checkpoints/last")


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("soft_resume")
    module = _seed_module(RESUME)
    dm = instantiate(compose("train", RESUME).data)
    with torch.no_grad():
        mats = [module.soft_targets(_torch_batch(next(iter(
            dm.train_dataloader(epoch)))))[0] for epoch in (0, 1)]
    soft = RESUME + soft_overrides("medmoe_torch", pick_thresholds(mats))
    straight, first = tmp / "straight", tmp / "first"
    train(compose("train", soft + ["trainer.max_epochs=2",
                                   f"paths.root_dir={straight}"]))
    train(compose("train", soft + ["trainer.max_epochs=1",
                                   f"paths.root_dir={first}"]))
    ckpt = torch.load(_last(first), map_location="cpu", weights_only=False)
    _, objs = train(compose("train", soft + [
        "trainer.max_epochs=2", f"ckpt_path={_last(first)}",
        f"paths.root_dir={first}"]))
    return dict(straight=straight, first=first, ckpt=ckpt, objs=objs,
                seed_bert=module.model.text_encoder.bert.state_dict())


class TestResume:
    def test_resume_is_bit_equal_to_a_straight_run(self, resumed):
        straight = _step_rows(str(resumed["straight"]))
        rows = _step_rows(str(resumed["first"]))
        assert [r["step"] for r in rows] == [1, 2]
        for name in METRICS:
            assert [r[f"train/{name}"] for r in rows] == \
                [r[f"train/{name}"] for r in straight], name
            assert all(r[f"train/{name}"] != 0 for r in rows)
        want = _load_state(_last(resumed["straight"]))
        got = resumed["objs"]["module"].model.state_dict()
        assert all(torch.equal(got[k], v) for k, v in want.items())

    def test_snapshot_is_the_seeds_bert(self, resumed):
        tool = resumed["objs"]["module"].tool_bert.state_dict()
        seed, saved = resumed["seed_bert"], resumed["ckpt"]["model"]
        assert all(torch.equal(tool[k], v) for k, v in seed.items())
        # the checkpoint's BERT moved in the first step
        assert any(not torch.equal(saved[f"text_encoder.bert.{k}"], v)
                   for k, v in seed.items())

    def test_snapshot_outside_every_state(self, resumed):
        objs = resumed["objs"]
        module, trainer = objs["module"], objs["trainer"]
        names = set(module.model.state_dict())
        assert set(resumed["ckpt"]["model"]) == names
        assert not any("tool" in k for k in names)
        tool = set(map(id, module.tool_bert.parameters()))
        assert not tool & set(map(id, trainer.state.params))
        opt = resumed["ckpt"]["optimizer"]["state"]
        assert len(opt) == len(trainer.state.params)
        logged = [float(r["model/params_M"]) for r in csv_rows(
            resumed["first"]) if r.get("model/params_M")]
        assert logged and all(v == pytest.approx(
            param_count(module.model) / 1e6) for v in logged)


def csv_rows(root):
    path = os.path.join(root, "logs", "train", "runs", "csv", "metrics.csv")
    with open(path) as f:
        return list(csv.DictReader(f))
