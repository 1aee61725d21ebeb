"""Data-parallel training of the port on two real CPU processes over gloo,
against the JAX package on ``make_mesh(data=2)`` and against one process.

  * ``gather_tensor`` with each backprop type (GLOBAL, LOCAL, NONE): values
    and input gradients against JAX's ``gather_tensor`` under
    ``jax.shard_map`` on two of the 8 fake devices of tests/conftest.py;
  * ``experiment=gloria256`` (global negatives) through the train CLI's own
    launcher, ``trainer=ddp_sim``: 3 steps of a node batch of 8 (4 a rank),
    held against JAX's train step on ``make_mesh(data=2)`` with the same
    global batches (the ranks' batches in rank order) from the same
    weights: per-step metrics averaged over the ranks, and the parameters
    at the end;
  * ``experiment=pretraining_medmoe_ddp``'s per-rank blocks (``block_size``
    2 of a rank's 4 rows, accumulation 2) on two ranks that this file's
    worker joins over a ``file://`` store, against the same JAX step;
  * a checkpoint written by one process resumed on two ranks, and theirs
    resumed by one process, against one process's straight run on the
    same global batches (two ranks against one process);
  * SIGTERM to rank 1 only: both ranks stop after the same step, and one
    ``last`` checkpoint is written;
  * the refusals: a node batch that does not divide over its ranks, a
    ``block_size`` across ranks, and an expert-parallel mesh that does not
    divide the ranks.

Every rank runs in its own process (``tests/torch_rank_worker.py``, which
imports no JAX); each group's join and collectives have a 60 s deadline
and each launch a 180 s one. Tolerances are those of
tests/test_torch_train.py: float32 metrics rtol 1e-5; parameters within
1e-2 of their own update, and the 2·steps·lr bound for the few whose
gradient is zero in exact arithmetic.
"""

import csv
import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import medmoe_tpu
from medmoe_tpu.eval.export import _save_weights
from medmoe_tpu.parallel.collectives import BackpropType as JBackprop
from medmoe_tpu.parallel.collectives import gather_tensor as jgather
from medmoe_tpu.parallel.mesh import make_mesh
from medmoe_tpu.train.state import TrainState as JState
from medmoe_tpu.train.step import build_train_step as jax_train_step
from medmoe_tpu.utils.instantiate import instantiate as jinstantiate
from medmoe_torch import bridge
from medmoe_torch.cli.train import train
from medmoe_torch.config import compose
from medmoe_torch.data import datamodules as tdm
from medmoe_torch.train.state import TrainState
from medmoe_torch.utils.checkpoint import save_checkpoint
from medmoe_torch.utils.instantiate import instantiate

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
ZERO_GRAD = ("key.bias", "attn_b2")
TINY = [
    "data=synthetic", "data.image_size=56", "data.num_classes=3",
    "model.model.vision.image_size=56", "model.model.vision.swin_embed_dim=8",
    "model.model.vision.swin_depths=[1,1]",
    "model.model.vision.swin_num_heads=[1,2]",
    "model.model.vision.num_experts=3", "model.model.vision.embed_dim=16",
    "model.model.vision.dtype=float32", "model.model.vision.drop_path_rate=0.0",
    "model.model.text.hidden_size=16", "model.model.text.num_layers=2",
    "model.model.text.num_heads=2", "model.model.text.intermediate_size=32",
    "model.model.text.vocab_size=200", "model.model.text.embed_dim=16",
    "model.model.text.max_length=10", "model.model.text.dtype=float32",
    "model.model.text.hidden_dropout_prob=0.0",
    "model.model.text.attention_probs_dropout_prob=0.0",
    f"model.optimizer.lr={LR}", "trainer.accelerator=cpu",
    "extras.print_config=false", "trainer.num_sanity_val_steps=0",
    "trainer.log_every_n_steps=1", "logger=csv",
]
# experiment=gloria256: global negatives, one batch a step
GLOBAL = ["experiment=gloria256", "data.batch_size=8",
          "data.num_samples=24", "trainer.max_epochs=1"] + TINY
# experiment=pretraining_medmoe_ddp: per-rank blocks, accumulation
BLOCKS = ["experiment=pretraining_medmoe_ddp", "data.batch_size=8",
          "data.num_samples=32", "trainer.max_epochs=1",
          "trainer.accumulate_grad_batches=2", "model.loss.block_size=2"] + TINY
# the checkpoint round trip: 2 steps an epoch
CHAIN = ["experiment=gloria256", "data.batch_size=8", "data.num_samples=16",
         "callbacks=default", "trainer.limit_val_batches=1"] + TINY


def _env():
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    return env


class Launch:
    """Processes started together and waited for with one deadline; the
    whole process group is killed past it. The deadline is the rank
    worker's group deadline (10 minutes): under a loaded test run a rank
    can be starved for minutes without being stuck."""

    def __init__(self, cmds, cwd):
        self.procs = [subprocess.Popen(c, cwd=cwd, env=_env(),
                                       start_new_session=True,
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
                      for c in cmds]

    def wait(self, timeout=600):
        for p in self.procs:
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                os.killpg(p.pid, signal.SIGKILL)
                out, _ = p.communicate()
                raise AssertionError(f"timed out:\n{out[-4000:]}")
            assert p.returncode == 0, out[-4000:]


def _workers(tmp, name, spec):
    """Two worker ranks over a file:// store; returns (Launch, out)."""
    out = str(tmp / name)
    spec = dict(spec, init=f"file://{tmp / (name + '.store')}", world=2,
                out=out)
    path = tmp / f"{name}.json"
    path.write_text(json.dumps(spec))
    cmds = [[sys.executable, "-m", "tests.torch_rank_worker", str(path),
             str(r)] for r in range(2)]
    return Launch(cmds, ROOT), out


def _results(out):
    return [json.loads(open(f"{out}.{r}.json").read()) for r in range(2)]


def _step_rows(root):
    """Per-step rows of the run's metrics.csv (those with the lr)."""
    path = os.path.join(root, "logs", "train", "runs", "csv", "metrics.csv")
    with open(path) as f:
        return [{k: float(v) for k, v in row.items() if v != ""}
                for row in csv.DictReader(f) if row.get("lr")]


def _rank_batches(overrides, rank, world=2):
    """The numpy batches rank ``rank`` of ``world`` loads in epoch 0."""
    cfg = compose("train", overrides)
    real = tdm._rank_and_world
    tdm._rank_and_world = lambda: (rank, world)
    try:
        dm = instantiate(cfg.data, ranks_per_node=world)
        return list(dm.train_dataloader(epoch=0))
    finally:
        tdm._rank_and_world = real


def _jax_module(overrides):
    jcfg = medmoe_tpu.compose("train", overrides)
    return jinstantiate(jcfg.model)


def _jax_trajectory(jm, params, overrides, accum, steps):
    """JAX's train step on make_mesh(data=2) over the global batches (the
    ranks' batches in rank order); (per-step metrics, final params)."""
    ranks = [_rank_batches(overrides, r) for r in range(2)]
    glob = [{k: np.concatenate([ranks[0][i][k], ranks[1][i][k]])
             for k in ranks[0][i]} for i in range(len(ranks[0]))]
    mesh = make_mesh(data=2, devices=jax.devices()[:2])
    state = JState.create(params, jm.make_optimizer(gradient_clip_val=0.25))
    state = jax.device_put(state, jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec()))
    step = jax_train_step(jm, mesh=mesh, accum_steps=accum, donate=False)
    metrics = []
    for s in range(steps):
        window = glob[s * accum:(s + 1) * accum]
        batch = window[0] if accum == 1 else \
            {k: np.stack([b[k] for b in window]) for k in window[0]}
        state, m = step(state, batch, jax.random.PRNGKey(1))
        metrics.append({k: float(v) for k, v in m.items()})
    final = bridge.from_jax_params(
        {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(leaf)
         for kp, leaf in jax.tree_util.tree_leaves_with_path(state.params)})
    return metrics, final


def _assert_params(got, want, init, steps, trainable):
    """tests/test_torch_train.py's float32 parameter policy."""
    bound = 2 * steps * LR
    for k, t in got.items():
        t, w, i = t.numpy(), want[k].numpy(), init[k].numpy()
        err = np.abs(t - w).max()
        if not trainable[k]:
            assert np.array_equal(t, i) and np.array_equal(w, i), k
            continue
        assert err <= bound, f"{k}: {err} > {bound}"
        if not k.endswith(ZERO_GRAD):
            assert err <= 1e-2 * np.abs(w - i).max() + 1e-7, k


def _load_state(path):
    return torch.load(path, map_location="cpu", weights_only=False)["model"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the two-process runs in two waves of at most six processes
    (so that a loaded machine starves no rank past its deadline), computes
    the references while they run, and returns both."""
    tmp = tmp_path_factory.mktemp("parallel")
    # one set of weights from JAX for both JAX comparisons
    jm = _jax_module(GLOBAL)
    batch0 = _rank_batches(GLOBAL, 0)[0]
    params = jax.jit(jm.init_params)(jax.random.PRNGKey(0), batch0)
    npz = str(tmp / "weights.npz")
    _save_weights(npz, params)
    cfg = compose("train", GLOBAL)
    module = instantiate(cfg.model)
    bridge.load_jax_params(module.model, bridge.load_npz(npz))
    init_ckpt = str(tmp / "init.ckpt")
    save_checkpoint(init_ckpt, TrainState.create(
        module.model, module.make_optimizer(0.25)))
    init = {k: v.detach().clone() for k, v in module.model.state_dict().items()}
    trainable = {n: p.requires_grad
                 for n, p in module.model.named_parameters()}

    # the chain's first leg (one process, 1 epoch) before the launches
    straight = tmp / "straight"
    train(compose("train", CHAIN + ["trainer.max_epochs=3",
                                    f"paths.root_dir={straight}"]))
    first = tmp / "first"
    train(compose("train", CHAIN + ["trainer.max_epochs=1",
                                    f"paths.root_dir={first}"]))
    last = lambda root: str(root / "logs/train/runs/checkpoints/last")  # noqa

    cli = Launch([[sys.executable, "-m", "medmoe_torch.cli.train",
                   *GLOBAL, "trainer=ddp_sim", f"ckpt_path={init_ckpt}",
                   f"paths.root_dir={tmp / 'cli'}", "callbacks=default",
                   "trainer.limit_val_batches=1"]], ROOT)
    blocks, blocks_out = _workers(tmp, "blocks", {
        "task": "train", "overrides": BLOCKS + [
            "trainer=ddp_sim", f"ckpt_path={init_ckpt}",
            f"paths.root_dir={tmp / 'blocks_root'}", "callbacks=default",
            "trainer.limit_val_batches=1"]})
    rng = np.random.RandomState(0)
    x, w = rng.randn(4, 3), rng.randn(4, 3)
    gather, gather_out = _workers(tmp, "gather", {
        "task": "gather", "x": x.tolist(), "w": w.tolist()})

    # the references, while the ranks run; the second wave once the first
    # has ended
    jax_global = _jax_trajectory(jm, params, GLOBAL, 1, 3)
    for launch in (gather, cli, blocks):
        launch.wait()
    resumed, resumed_out = _workers(tmp, "resumed", {
        "task": "train", "overrides": CHAIN + [
            "trainer=ddp_sim", "trainer.max_epochs=2", f"ckpt_path={last(first)}",
            f"paths.root_dir={first}"]})
    preempt, preempt_out = _workers(tmp, "preempt", {
        "task": "train", "sigterm_rank": 1, "sigterm_after": 1,
        "overrides": GLOBAL + ["trainer=ddp_sim", "callbacks=default",
                               f"paths.root_dir={tmp / 'preempt_root'}"]})
    jm_blocks = _jax_module(BLOCKS)
    jax_blocks = _jax_trajectory(jm_blocks, params, BLOCKS, 2, 2)

    def jax_gathered(kind):
        mesh = make_mesh(data=2, devices=jax.devices()[:2])
        spec = jax.sharding.PartitionSpec("data")

        def per_device(xs):
            y = jgather(xs, "data", JBackprop(kind))
            r = jax.lax.axis_index("data").astype(jnp.float32)
            return y[None], jnp.sum(y * (jnp.asarray(w, jnp.float32)
                                         + r))[None]

        fn = jax.shard_map(per_device, mesh=mesh, in_specs=spec,
                           out_specs=(spec, spec), check_vma=False)
        xs = jnp.asarray(x, jnp.float32)
        ys, _ = fn(xs)
        grad = jax.grad(lambda v: jnp.sum(fn(v)[1]))(xs)
        return np.asarray(ys), np.asarray(grad)

    jax_gather = {k: jax_gathered(k) for k in ("global", "local", "none")}

    for launch in (resumed, preempt):
        launch.wait()
    # the chain's last leg: one process resumes the two ranks' checkpoint
    back = tmp / "back"
    _, objs = train(compose("train", CHAIN + [
        "trainer.max_epochs=3", f"ckpt_path={last(first)}",
        f"paths.root_dir={back}"]))
    return dict(tmp=tmp, init=init, trainable=trainable,
                jax_global=jax_global, jax_blocks=jax_blocks,
                jax_gather=jax_gather, gather=_results(gather_out),
                cli=tmp / "cli", blocks=_results(blocks_out),
                blocks_root=tmp / "blocks_root",
                resumed=_results(resumed_out), back=objs["trainer"],
                straight=straight, first=first,
                preempt=_results(preempt_out),
                preempt_root=tmp / "preempt_root", last=last)


class TestGather:
    @pytest.mark.parametrize("kind", ["global", "local", "none"])
    def test_values_and_gradients_match_jax(self, runs, kind):
        ys, grad = runs["jax_gather"][kind]
        for rank, res in enumerate(runs["gather"]):
            np.testing.assert_allclose(res[kind]["y"], ys[rank], rtol=1e-6)
            np.testing.assert_allclose(res[kind]["grad"],
                                       grad[2 * rank:2 * rank + 2],
                                       rtol=1e-6, atol=1e-7)

    def test_rank_world_and_reductions(self, runs):
        for rank, res in enumerate(runs["gather"]):
            assert (res["rank"], res["world"]) == (rank, 2)
            assert res["any"] is True and res["mean"] == 0.5

    def test_identity_outside_a_group(self):
        from medmoe_torch.parallel import collectives as C

        x = torch.randn(3, 2, requires_grad=True)
        for kind in C.BackpropType:
            assert C.gather_tensor(x, kind) is x
        assert C.get_rank() == 0 and C.get_world_size() == 1


METRICS = ("loss", "l_loss", "g_loss", "c_loss", "grad_norm")


class TestAgainstJax:
    @pytest.mark.parametrize("name", METRICS)
    def test_global_negatives_per_step(self, runs, name):
        """The CLI's own two ranks (trainer=ddp_sim) against JAX's mesh
        step, gloria256's losses over the global batch."""
        rows = _step_rows(str(runs["cli"]))
        jax_metrics = runs["jax_global"][0]
        assert len(rows) == len(jax_metrics) == 3
        np.testing.assert_allclose([r[f"train/{name}"] for r in rows],
                                   [m[name] for m in jax_metrics],
                                   rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("name", METRICS)
    def test_per_rank_blocks_per_step(self, runs, name):
        rows = _step_rows(str(runs["blocks_root"]))
        jax_metrics = runs["jax_blocks"][0]
        assert len(rows) == len(jax_metrics) == 2
        np.testing.assert_allclose([r[f"train/{name}"] for r in rows],
                                   [m[name] for m in jax_metrics],
                                   rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("which", ["cli", "blocks_root"])
    def test_final_parameters(self, runs, which):
        ref = runs["jax_global" if which == "cli" else "jax_blocks"]
        got = _load_state(runs["last"](runs[which]))
        assert not any(k.startswith("module.") for k in got)
        _assert_params(got, ref[1], runs["init"], len(ref[0]),
                       runs["trainable"])


class TestCheckpointTopology:
    def test_two_ranks_resume_one_process_checkpoint(self, runs):
        """Epoch 1 on two ranks from one process's epoch-0 checkpoint
        equals one process's straight run (the same global batches)."""
        straight = _step_rows(str(runs["straight"]))
        for res in runs["resumed"]:
            assert res["world"] == 2 and res["step"] == 4
        rows = _step_rows(str(runs["first"]))
        assert [r["step"] for r in rows] == [1, 2, 3, 4]
        for name in METRICS:
            np.testing.assert_allclose([r[f"train/{name}"] for r in rows],
                                       [r[f"train/{name}"] for r in
                                        straight[:4]], rtol=1e-5, atol=1e-6)

    def test_one_process_resumes_two_ranks_checkpoint(self, runs):
        back = runs["back"]
        assert back.state.step == 6
        straight = _step_rows(str(runs["straight"]))
        rows = _step_rows(str(runs["tmp"] / "back"))
        assert [r["step"] for r in rows] == [5, 6]
        for name in METRICS:
            np.testing.assert_allclose([r[f"train/{name}"] for r in rows],
                                       [r[f"train/{name}"] for r in
                                        straight[4:]], rtol=1e-5, atol=1e-6)
        want = _load_state(runs["last"](runs["straight"]))
        got = {k: v.detach() for k, v in back.state.model.state_dict().items()}
        fresh = instantiate(compose("train", CHAIN).model)
        fresh.init_params(back.seed)
        init = {k: v.detach() for k, v in fresh.model.state_dict().items()}
        trainable = {n: p.requires_grad
                     for n, p in fresh.model.named_parameters()}
        _assert_params(got, want, init, 6, trainable)


class TestPreemption:
    def test_sigterm_to_one_rank_stops_both(self, runs):
        res = runs["preempt"]
        assert [r["step"] for r in res] == [1, 1]
        assert all(r["interrupted"] for r in res)
        ckpts = runs["preempt_root"] / "logs/train/runs/checkpoints"
        assert sorted(os.listdir(ckpts)) == ["last", "last.meta.json"]
        meta = json.loads((ckpts / "last.meta.json").read_text())
        assert meta["preempted"] is True and meta["epoch"] == -1


class TestRefusals:
    def test_node_batch_must_divide_over_its_ranks(self):
        with pytest.raises(ValueError, match="divide evenly"):
            tdm.SyntheticDataModule(batch_size=6, ranks_per_node=4)
        dm = tdm.SyntheticDataModule(batch_size=8, num_samples=32,
                                     ranks_per_node=2)
        assert (dm.node_batch_size, dm.batch_size) == (8, 4)

    def test_block_across_ranks_raises(self, monkeypatch):
        from medmoe_torch.parallel import collectives as C

        cfg = compose("train", BLOCKS + ["model.loss.block_size=3"])
        module = instantiate(cfg.model)
        monkeypatch.setattr(C, "in_group", lambda: True)
        monkeypatch.setattr(C, "get_world_size", lambda: 2)
        with pytest.raises(ValueError, match="block_size=3"):
            module._gathers(4)
        module.block_size = 2
        assert not module._gathers(4)
        module.block_size = 8            # covers the global batch
        assert module._gathers(4)

    def test_expert_mesh_names_a_live_queue(self):
        """The expert-parallel mesh is ported (this test held its refusal,
        which named a ROADMAP queue): a grid that does not divide the
        ranks raises, here and in the CLI before any rank starts; one that
        does lays the ranks out (tests/test_torch_ep.py trains on it)."""
        from medmoe_torch.cli.train import data_ranks_per_node
        from medmoe_torch.train import loop

        with pytest.raises(ValueError, match="not divisible by expert=2"):
            loop.Trainer(accelerator="cpu", mesh={"expert": 2})
        with pytest.raises(ValueError, match="mesh 2x1 != 1 ranks"):
            loop.Trainer(accelerator="cpu", mesh={"data": 2, "expert": 1})
        with pytest.raises(ValueError, match="not divisible"):
            data_ranks_per_node({"accelerator": "cpu", "devices": 2,
                                 "mesh": {"expert": 4}})
        trainer = loop.Trainer(accelerator="cpu", mesh={"expert": 1})
        assert (trainer.grid.data, trainer.grid.expert) == (1, 1)

    def test_num_nodes_without_a_launch_raises(self):
        from medmoe_torch.parallel.multihost import maybe_initialize

        with pytest.raises(RuntimeError, match="num_nodes=2"):
            maybe_initialize(2, "cpu")
        assert maybe_initialize(1, "cpu") is False

    def test_devices_beyond_the_cards_raise(self, monkeypatch):
        from medmoe_torch.train import loop

        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="1 CUDA device"):
            loop.resolve_devices(2, "gpu")
        assert loop.resolve_devices("auto", "gpu") == 1
        assert loop.resolve_devices("auto", "cpu") == 1


class TestConfigs:
    @pytest.mark.parametrize("name", ["moe_single_modality",
                                      "zero_shot_dense"])
    def test_experiment_trains_on_cpu(self, name, tmp_path):
        """The two experiments copied from the JAX package compose with the
        port's targets and keep their settings; two tiny steps train
        (``topk`` at capacity factor 1.5 with top-2 routing; no MoE)."""
        jcfg = medmoe_tpu.compose("train", [f"experiment={name}"])
        cfg = compose("train", [f"experiment={name}"])
        assert cfg.model._target_.startswith("medmoe_torch.")
        assert cfg.model.model.vision == jcfg.model.model.vision
        assert cfg.data.batch_size == jcfg.data.batch_size
        tiny = [o for o in TINY if "num_experts" not in o]
        _, objs = train(compose("train", [
            f"experiment={name}", "data.batch_size=4", "data.num_samples=8",
            "trainer.accumulate_grad_batches=1", "trainer.max_epochs=1",
            "trainer.limit_val_batches=1", "callbacks=none",
            f"paths.root_dir={tmp_path}"] + tiny))
        trainer = objs["trainer"]
        assert trainer.state.step == 2
        hist = trainer.metrics_history[-1]
        assert np.isfinite(hist["train/loss"]) and hist["train/grad_norm"] > 0
        moe = objs["module"].model.image_encoder.swin_moe.moe
        if name == "zero_shot_dense":
            assert moe is None
        else:
            assert (moe.config.mode, moe.config.top_k, moe.config.num_experts,
                    moe.config.capacity_factor) == ("topk", 2, 4, 1.5)

    @pytest.mark.parametrize("group", ["ddp", "ddp_sim"])
    def test_trainer_groups(self, group):
        """The groups' own settings (gloria256 and the pretraining
        experiments pin trainer.accelerator=gpu over them, as the JAX
        package's pin tpu)."""
        cfg = compose("train", ["experiment=zero_shot_dense",
                                f"trainer={group}"])
        assert cfg.trainer._target_ == "medmoe_torch.train.loop.Trainer"
        want = {"ddp": ("gpu", "auto"), "ddp_sim": ("cpu", 2)}[group]
        assert (cfg.trainer.accelerator, cfg.trainer.devices) == want
