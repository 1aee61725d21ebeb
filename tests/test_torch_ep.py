"""Expert parallelism of the port on real CPU processes over gloo, against
the JAX package on ``make_mesh(data, expert)`` with the bank sharded
(``param_shardings(..., expert_parallel=True)``) and against one process.

  * top-k capacity dispatch across two data-parallel ranks (``topk``,
    top-2, a router biased to expert 0 so that it overflows): the
    capacity and the positions are the global batch's, as JAX computes
    them on ``make_mesh(data=2)``;
  * ``experiment=gloria256`` with the MoE in modes ``ep`` (top-2, the same
    overflow), ``gather`` (K1's plain version on the all-gathered bank)
    and ``dense`` (top-2), on two ranks (data 1 × expert 2) and four
    (data 2 × expert 2): per-step metrics against JAX's step on the same
    mesh and against the port's one process on the same global batches,
    the parameters at the end, and the replicated parameters bit-equal
    across the ranks;
  * the expert-region functions against the one-process computation;
  * a checkpoint moved e = 2 → one process → e = 2 against a straight run,
    and a checkpoint written by two expert ranks served by ``cli.serve``;
  * the refusals, the configs, and two steps of ``experiment=ep_full_mix``.

Every rank runs in its own process (``tests/torch_rank_worker.py``);
tolerances are tests/test_torch_train.py's: float32 metrics rtol 1e-5;
parameters within 1e-2 of their own update, and the 2·steps·lr bound for
the few whose gradient is zero in exact arithmetic.
"""

import json
import sys

import jax
import numpy as np
import pytest
import torch

import medmoe_tpu
from medmoe_tpu.eval.export import _save_weights
from medmoe_tpu.parallel.mesh import make_mesh
from medmoe_tpu.parallel.sharding import param_shardings
from medmoe_tpu.train.state import TrainState as JState
from medmoe_tpu.train.step import build_train_step as jax_train_step
from medmoe_torch import bridge
from medmoe_torch.cli.train import train
from medmoe_torch.config import compose
from medmoe_torch.data import datamodules as tdm
from medmoe_torch.parallel import sharding
from medmoe_torch.train.state import TrainState
from medmoe_torch.train.step import build_train_step
from medmoe_torch.utils.checkpoint import save_checkpoint
from medmoe_torch.utils.instantiate import instantiate
from tests.test_torch_parallel import (METRICS, ROOT, TINY, Launch,
                                       _assert_params, _jax_module,
                                       _load_state, _step_rows)

torch.set_num_threads(1)

TINY_EP = [o for o in TINY if "num_experts" not in o] + [
    "model.model.vision.num_experts=4"]
# gloria256 (global negatives) at a node batch of 8, 2 steps. Adam's eps
# is 1e-6: with the clip at 0.25 some elements' gradients are ~1e-9, and at
# eps 1e-8 rounding noise decides their update (lr·g/(|g|+eps)), so two
# runs that differ in f32 summation order part by more than the
# parameter policy's 1% after the second step (the JAX package and the
# port's one process too, without expert parallelism)
BASE = ["experiment=gloria256", "data.batch_size=8", "data.num_samples=16",
        "trainer.max_epochs=1", "model.optimizer.eps=1e-6"] + TINY_EP
V = "model.model.vision."
MODES = {"ep": [f"{V}moe_mode=ep", f"{V}router_top_k=2",
                f"{V}capacity_factor=1.0"],
         "gather": [f"{V}moe_mode=gather"],
         "dense": [f"{V}moe_mode=dense", f"{V}router_top_k=2"]}
TOPK = [f"{V}moe_mode=topk", f"{V}router_top_k=2", f"{V}capacity_factor=1.0"]
GRIDS = {2: (1, 2), 4: (2, 2)}           # ranks → (data, expert)
# the checkpoint chain: 2 steps an epoch, moe_mode=ep
CHAIN = ["experiment=gloria256", "data.batch_size=8", "data.num_samples=16",
         "callbacks=default", "trainer.limit_val_batches=1"] + TINY_EP \
    + MODES["ep"]
STEPS = 2
ROUTER_BIAS = "image_encoder/swin_moe/moe/router_fc2/bias"


def _grid_trainer(world):
    d, e = GRIDS[world]
    return ["trainer=ep", "trainer.accelerator=cpu", f"trainer.devices={world}",
            f"trainer.mesh.expert={e}"]


def _workers(tmp, name, spec, world):
    """``world`` worker ranks over a file:// store; (Launch, out)."""
    out = str(tmp / name)
    spec = dict(spec, init=f"file://{tmp / (name + '.store')}", world=world,
                out=out)
    path = tmp / f"{name}.json"
    path.write_text(json.dumps(spec))
    cmds = [[sys.executable, "-m", "tests.torch_rank_worker", str(path),
             str(r)] for r in range(world)]
    return Launch(cmds, ROOT), out


def _results(out, world):
    return [json.loads(open(f"{out}.{r}.json").read()) for r in range(world)]


def _rank_dumps(out, world, run):
    return [torch.load(f"{out}.{r}.{run}.pt", map_location="cpu")
            for r in range(world)]


def _global_batches(overrides, d):
    """Epoch 0's global batches of a grid with d data ranks: each data
    rank's batch, in rank order."""
    cfg = compose("train", overrides)
    real = tdm._rank_and_world
    ranks = []
    try:
        for r in range(d):
            tdm._rank_and_world = lambda r=r: (r, d)
            dm = instantiate(cfg.data, ranks_per_node=d)
            ranks.append(list(dm.train_dataloader(epoch=0)))
    finally:
        tdm._rank_and_world = real
    return [{k: np.concatenate([rb[i][k] for rb in ranks]) for k in ranks[0][i]}
            for i in range(len(ranks[0]))]


def _jax_trajectory(params, overrides, d, e, steps):
    """JAX's train step on make_mesh(d, e), the bank sharded over
    ``expert`` when e > 1; (per-step metrics, final params)."""
    jm = _jax_module(overrides)
    mesh = make_mesh(data=d, expert=e, devices=jax.devices()[:d * e])
    params = jax.tree_util.tree_map(
        jax.device_put, params, param_shardings(params, mesh, e > 1))
    state = JState.create(params, jm.make_optimizer(gradient_clip_val=0.25))
    step = jax_train_step(jm, mesh=mesh, accum_steps=1, donate=False)
    metrics = []
    for batch in _global_batches(overrides, d)[:steps]:
        state, m = step(state, batch, jax.random.PRNGKey(1))
        metrics.append({k: float(v) for k, v in m.items()})
    final = bridge.from_jax_params(
        {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(leaf)
         for kp, leaf in jax.tree_util.tree_leaves_with_path(state.params)})
    return metrics, final


def _one_process(npz, overrides, d, steps):
    """The port's train step in one process on the same global batches;
    (per-step metrics, final state_dict)."""
    module = instantiate(compose("train", overrides).model)
    bridge.load_jax_params(module.model, bridge.load_npz(npz))
    state = TrainState.create(module.model, module.make_optimizer(0.25))
    step = build_train_step(module, 1)
    metrics = []
    for batch in _global_batches(overrides, d)[:steps]:
        state, m = step(state, [{k: torch.as_tensor(v)
                                 for k, v in batch.items()}])
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, {k: v.detach().clone()
                     for k, v in module.model.state_dict().items()}


def _last(root):
    return str(root / "logs/train/runs/checkpoints/last")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the multi-process runs in two waves of at most six ranks
    (so that a loaded machine starves no rank past its deadline), computes
    the references while they run, and returns both."""
    tmp = tmp_path_factory.mktemp("ep")
    # one set of weights from JAX, the router biased to expert 0 so that
    # top-2 capacity dispatch overflows
    jm = _jax_module(BASE + MODES["ep"])
    batch0 = _global_batches(BASE, 1)[0]
    params = jax.jit(jm.init_params)(jax.random.PRNGKey(0), batch0)
    flat = {"/".join(str(getattr(k, "key", k)) for k in kp)
            for kp, _ in jax.tree_util.tree_leaves_with_path(params)}
    assert ROUTER_BIAS in flat
    params = jax.tree_util.tree_map_with_path(
        lambda kp, x: x + np.asarray([4.0, 0, 0, 0], np.float32)
        if "/".join(str(getattr(k, "key", k)) for k in kp) == ROUTER_BIAS
        else x, params)
    npz = str(tmp / "weights.npz")
    _save_weights(npz, params)
    module = instantiate(compose("train", BASE + MODES["ep"]).model)
    bridge.load_jax_params(module.model, bridge.load_npz(npz))
    init_ckpt = str(tmp / "init.ckpt")
    save_checkpoint(init_ckpt, TrainState.create(
        module.model, module.make_optimizer(0.25)))
    init = {k: v.detach().clone() for k, v in module.model.state_dict().items()}
    trainable = {n: p.requires_grad
                 for n, p in module.model.named_parameters()}
    common = [f"ckpt_path={init_ckpt}", "callbacks=default",
              "trainer.limit_val_batches=1"]

    def root(name):
        return tmp / name

    # wave 1: the fix (two data ranks of topk) and the chain's first leg (e
    # = 2), the 1 × 2 grid and the regions, six ranks
    first = root("first")
    fix, fix_out = _workers(tmp, "fix", {"task": "train_runs", "runs": [
        BASE + TOPK + common + [
            "trainer=ddp_sim", f"paths.root_dir={root('fix')}"],
        CHAIN + _grid_trainer(2) + ["trainer.max_epochs=1",
                                    f"paths.root_dir={first}"]]}, 2)

    def grid(world):
        run_list = [BASE + MODES[m] + common + _grid_trainer(world)
                    + [f"paths.root_dir={root(f'{m}{world}')}"]
                    for m in MODES]
        if world == 2:
            run_list.append([
                "experiment=ep_full_mix", "data=synthetic",
                "data.batch_size=4", "data.num_samples=8",
                "trainer.accumulate_grad_batches=1", "trainer.max_epochs=1",
                "trainer.limit_val_batches=1", "callbacks=none",
                "trainer.devices=2", f"paths.root_dir={root('full_mix')}"]
                + [o for o in TINY if "num_experts" not in o])
        return _workers(tmp, f"grid{world}", {
            "task": "train_runs", "runs": run_list}, world)

    grids = {2: grid(2)}
    rng = np.random.RandomState(0)
    x, w = rng.randn(4, 3), rng.randn(4, 3)
    regions, regions_out = _workers(tmp, "regions", {
        "task": "regions", "x": x.tolist(), "w": w.tolist()}, 2)

    # the references, while the ranks run
    jax_ref, one_ref = {}, {}
    jax_ref["fix"] = _jax_trajectory(params, BASE + TOPK, 2, 1, STEPS)
    one_ref["fix"] = _one_process(npz, BASE + TOPK, 2, STEPS)

    def references(world):
        d, e = GRIDS[world]
        for m in MODES:
            jax_ref[m, world] = _jax_trajectory(params, BASE + MODES[m], d, e,
                                                STEPS)
            one_ref[m, world] = _one_process(npz, BASE + MODES[m], d, STEPS)

    references(2)
    # wave 2, once wave 1 has ended: the 2 × 2 grid, then the chain's last
    # leg, six ranks
    for launch in (fix, grids[2][0], regions):
        launch.wait()
    grids[4] = grid(4)
    references(4)
    straight = root("straight")
    train(compose("train", CHAIN + ["trainer.max_epochs=3",
                                    f"paths.root_dir={straight}"]))

    # the chain: one process resumes the two expert ranks' checkpoint, and
    # two expert ranks resume its
    train(compose("train", CHAIN + ["trainer.max_epochs=2",
                                    f"ckpt_path={_last(first)}",
                                    f"paths.root_dir={first}"]))
    third, third_out = _workers(tmp, "third", {
        "task": "train_runs", "runs": [CHAIN + _grid_trainer(2) + [
            "trainer.max_epochs=3", f"ckpt_path={_last(first)}",
            f"paths.root_dir={first}"]]}, 2)
    grids[4][0].wait()
    third.wait()
    return dict(tmp=tmp, root=root, init=init, trainable=trainable,
                jax=jax_ref, one=one_ref, npz=npz, x=x, w=w,
                fix=_results(fix_out, 2), fix_out=fix_out,
                grids={world: (_results(out, world), out)
                       for world, (_, out) in grids.items()},
                regions=_results(regions_out, 2),
                third=_results(third_out, 2), straight=straight, first=first)


def _hold_metrics(rows, want, label):
    assert len(rows) == len(want) == STEPS, label
    for name in METRICS:
        np.testing.assert_allclose([r[f"train/{name}"] for r in rows],
                                   [m[name] for m in want], rtol=1e-5,
                                   atol=1e-6, err_msg=f"{label}: {name}")


class TestTopkAcrossDataRanks:
    """Two data ranks of topk keep the assignments that JAX keeps on the
    global batch (C from the global batch, positions offset by the earlier
    rank's counts)."""

    def test_router_overflows(self, runs):
        """The biased router sends more than C = ceil(8·2·1.0/4) = 4
        assignments to expert 0: capacity drops happen."""
        from medmoe_torch.models import moe as tmoe

        module = instantiate(compose("train", BASE + TOPK).model)
        bridge.load_jax_params(module.model, bridge.load_npz(runs["npz"]))
        seen = []
        real = tmoe.make_dispatch_tensors

        def record(idx, w, k, cap, offsets=None):
            seen.append((idx.clone(), cap))
            return real(idx, w, k, cap, offsets)

        tmoe.make_dispatch_tensors = record
        try:
            batch = _global_batches(BASE + TOPK, 2)[0]
            with torch.no_grad():
                module.model({k: torch.as_tensor(v)
                              for k, v in batch.items()})
        finally:
            tmoe.make_dispatch_tensors = real
        idx, cap = seen[0]
        assert cap == 4 and int((idx == 0).sum()) > cap

    @pytest.mark.parametrize("k_slots", [1, 2])
    def test_offsets_give_the_global_slots(self, k_slots):
        """Each data rank's dispatch and combine, its positions offset by
        the earlier ranks' counts and C from the global batch, are the
        columns of JAX's make_dispatch_tensors on the global batch."""
        import jax.numpy as jnp

        from medmoe_torch.models import moe as tmoe
        from medmoe_tpu.models import moe as jmoe

        rng = np.random.RandomState(5)
        k, b, d = 4, 12, 3
        idx = np.stack([rng.choice([0, 0, 0, 1, 2, 3], k_slots,
                                   replace=False) for _ in range(b)])
        idx = idx.astype(np.int32)
        w = rng.rand(b, k_slots).astype(np.float32)
        cap = int(np.ceil(b * k_slots * 1.0 / k))
        jd, jc = jmoe.make_dispatch_tensors(jnp.asarray(idx), jnp.asarray(w),
                                            k, cap)
        n = b // d
        counts = np.stack([np.bincount(idx[r * n:(r + 1) * n].ravel(),
                                       minlength=k) for r in range(d)])
        assert int(np.asarray(jd)[0].sum()) < int((idx == 0).sum())
        for r in range(d):
            rows = slice(r * n, (r + 1) * n)
            td, tc = tmoe.make_dispatch_tensors(
                torch.from_numpy(idx[rows]), torch.from_numpy(w[rows]), k,
                cap, torch.from_numpy(counts[:r].sum(0)))
            np.testing.assert_array_equal(td.numpy(),
                                          np.asarray(jd)[:, :, rows])
            np.testing.assert_allclose(tc.numpy(), np.asarray(jc)[:, :, rows],
                                       rtol=1e-6)

    @pytest.mark.parametrize("ref", ["jax", "one"])
    def test_per_step_metrics(self, runs, ref):
        rows = _step_rows(str(runs["root"]("fix")))
        _hold_metrics(rows, runs[ref]["fix"][0], f"topk vs {ref}")

    def test_final_parameters(self, runs):
        got = _load_state(_last(runs["root"]("fix")))
        _assert_params(got, runs["jax"]["fix"][1], runs["init"], STEPS,
                       runs["trainable"])


class TestExpertParallel:
    @pytest.mark.parametrize("world", sorted(GRIDS))
    @pytest.mark.parametrize("mode", list(MODES))
    @pytest.mark.parametrize("ref", ["jax", "one"])
    def test_per_step_metrics(self, runs, mode, world, ref):
        rows = _step_rows(str(runs["root"](f"{mode}{world}")))
        _hold_metrics(rows, runs[ref][mode, world][0],
                      f"{mode} on {GRIDS[world]} vs {ref}")

    @pytest.mark.parametrize("world", sorted(GRIDS))
    @pytest.mark.parametrize("mode", list(MODES))
    def test_final_parameters(self, runs, mode, world):
        got = _load_state(_last(runs["root"](f"{mode}{world}")))
        for ref in ("jax", "one"):
            _assert_params(got, runs[ref][mode, world][1], runs["init"],
                           STEPS, runs["trainable"])

    @pytest.mark.parametrize("world", sorted(GRIDS))
    def test_replicated_parameters_bit_equal(self, runs, world):
        """Every rank holds the same replicated parameters, bit for bit,
        and the expert ranks' slices are the checkpoint's whole bank."""
        results, out = runs["grids"][world]
        d, e = GRIDS[world]
        for i, mode in enumerate(MODES):
            dumps = _rank_dumps(out, world, i)
            whole = _load_state(_last(runs["root"](f"{mode}{world}")))
            for k, v in dumps[0].items():
                if sharding.is_expert_param(k):
                    for j in range(d):
                        got = torch.cat([dumps[j * e + c][k]
                                         for c in range(e)])
                        assert torch.equal(got, whole[k]), (mode, k)
                    assert v.shape[0] == whole[k].shape[0] // e
                else:
                    for r in range(1, world):
                        assert torch.equal(dumps[r][k], v), (mode, k, r)
        for res in results:
            assert [r["world"] for r in res] == [world] * len(res)
            assert all(r["step"] == STEPS for r in res[:len(MODES)])


class TestShards:
    @pytest.mark.parametrize("e", [2, 4])
    def test_shard_is_jax_expert_parallel_placement(self, runs, e):
        """bridge.from_jax_params(expert_shard=(c, e)) is what JAX's
        param_shardings(..., expert_parallel=True) places on device c of
        make_mesh(data=1, expert=e), and it loads strictly into a model
        whose banks ExpertBank.shard cut to rank c's experts."""
        from medmoe_torch.parallel.mesh import Grid

        flat = bridge.load_npz(runs["npz"])
        mesh = make_mesh(data=1, expert=e, devices=jax.devices()[:e])
        tree = _unflatten(flat)
        params = jax.tree_util.tree_map(jax.device_put, tree,
                                        param_shardings(tree, mesh, True))
        placed = {"/".join(str(getattr(k, "key", k)) for k in kp): leaf
                  for kp, leaf in jax.tree_util.tree_leaves_with_path(params)}
        for c in range(e):
            device = mesh.devices[0, c]
            on_c = {key: next(np.asarray(s.data)
                              for s in leaf.addressable_shards
                              if s.device == device)
                    for key, leaf in placed.items()}
            want = bridge.from_jax_params(on_c)
            got = bridge.from_jax_params(flat, expert_shard=(c, e))
            assert set(got) == set(want)
            for name, v in got.items():
                assert torch.equal(v, want[name]), name
                if sharding.is_expert_param(name):
                    assert v.shape[0] == 4 // e, name
            model = instantiate(compose("train", BASE + MODES["ep"]).model)
            sharding.shard_model(model.model, Grid(data=1, expert=e, rank=c))
            model.model.load_state_dict(got, strict=True)


def _unflatten(flat):
    """The flat npz of JAX parameters as their nested tree."""
    tree = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jax.numpy.asarray(value)
    return tree


class TestRegions:
    @pytest.mark.parametrize("name", ["enter", "leave", "gather"])
    def test_values_and_gradients(self, runs, name):
        """enter: identity forward, the cotangent summed over the group;
        leave: the ranks' inputs summed, the cotangent unchanged; gather:
        the slices concatenated, the rank's slice of its own cotangent."""
        x, w = runs["x"].astype(np.float32), runs["w"].astype(np.float32)
        for rank, res in enumerate(runs["regions"]):
            y, grad = np.asarray(res[name]["y"]), np.asarray(res[name]["grad"])
            if name == "enter":
                np.testing.assert_array_equal(y, x)
                np.testing.assert_allclose(grad, 2 * w + 1, rtol=1e-6)
            elif name == "leave":
                np.testing.assert_allclose(y, 3 * x, rtol=1e-6)
                np.testing.assert_allclose(grad, w + rank, rtol=1e-6)
            else:
                np.testing.assert_array_equal(y, x)
                np.testing.assert_array_equal(grad, w[2 * rank:2 * rank + 2])


class TestCheckpointTopology:
    def test_expert_ranks_one_process_expert_ranks(self, runs):
        """Epoch 0 on two expert ranks, epoch 1 in one process from their
        checkpoint, epoch 2 on two expert ranks from its: the straight
        one-process run's metrics, and its parameters at the end."""
        straight = _step_rows(str(runs["straight"]))
        rows = _step_rows(str(runs["first"]))
        assert [r["step"] for r in rows] == [1, 2, 3, 4, 5, 6]
        for name in METRICS:
            np.testing.assert_allclose([r[f"train/{name}"] for r in rows],
                                       [r[f"train/{name}"] for r in straight],
                                       rtol=1e-5, atol=1e-6, err_msg=name)
        assert [r[0]["step"] for r in runs["third"]] == [6, 6]
        got = _load_state(_last(runs["first"]))
        want = _load_state(_last(runs["straight"]))
        fresh = instantiate(compose("train", CHAIN).model)
        fresh.init_params(12345)
        init = {k: v.detach() for k, v in fresh.model.state_dict().items()}
        trainable = {n: p.requires_grad
                     for n, p in fresh.model.named_parameters()}
        _assert_params(got, want, init, 6, trainable)

    def test_serve_an_expert_parallel_checkpoint(self, runs, tmp_path,
                                                 capsys):
        """cli.serve on the checkpoint two expert ranks wrote (through
        load_for_eval, one process, the whole bank): the embeddings of the
        model the ranks' slices make up."""
        from PIL import Image

        from medmoe_torch.cli import serve
        from medmoe_torch.data.transforms import ImageTransform, decode_image
        from medmoe_torch.eval.zero_shot import make_image_embedder

        results, out = runs["grids"][2]
        dumps = _rank_dumps(out, 2, 0)
        state = {k: torch.cat([dumps[0][k], dumps[1][k]])
                 if sharding.is_expert_param(k) else v
                 for k, v in dumps[0].items()}
        model = instantiate(compose("train", BASE + MODES["ep"]).model).model
        model.load_state_dict(state)
        model.eval()
        rng = np.random.RandomState(3)
        images = tmp_path / "images"
        images.mkdir()
        for i in range(3):
            Image.fromarray(rng.randint(0, 255, (60, 70, 3), np.uint8)).save(
                images / f"{i}.png")
        paths = sorted(images.glob("*.png"))
        transform = ImageTransform(56, train=False)
        batch = np.stack([transform(decode_image(p.read_bytes()))
                          for p in paths])
        want = make_image_embedder(model)(batch).numpy()
        capsys.readouterr()
        rc = serve.main([o for o in TINY_EP + MODES["ep"]
                         if o.startswith("model.")] + [
            "data=synthetic", "device=cpu",
            f"ckpt_path={_last(runs['root']('ep2'))}", "serve.mode=embed",
            f"serve.input={images}", f"serve.batch_size={len(paths)}",
            f"paths.root_dir={tmp_path}"])
        assert rc == 0
        recs = [json.loads(line) for line in
                capsys.readouterr().out.splitlines() if line.startswith("{")]
        got = np.asarray([r["embedding"] for r in recs], np.float32)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


class TestRefusals:
    def test_experts_must_divide_over_the_expert_axis(self):
        from medmoe_torch.parallel.mesh import Grid

        module = instantiate(compose("train", BASE + [
            f"{V}num_experts=3"]).model)
        with pytest.raises(ValueError, match="3 experts do not divide"):
            sharding.shard_model(module.model, Grid(data=1, expert=2))
        with pytest.raises(ValueError, match="do not divide"):
            sharding.shard_tensors({"moe.experts.proj_w0": torch.zeros(3, 2)},
                                   0, 2)

    @pytest.mark.parametrize("mesh,n", [({"expert": 2}, 1), ({"expert": 2}, 3),
                                        ({"data": 3, "expert": 2}, 4)])
    def test_grid_that_does_not_divide_raises(self, mesh, n):
        from medmoe_torch.parallel.mesh import MeshSpec

        with pytest.raises(ValueError):
            MeshSpec.from_config(mesh).resolve(n)
        assert MeshSpec.from_config({"expert": 2}).resolve(4) == (2, 2)

    def test_cli_refuses_before_any_rank_starts(self):
        from medmoe_torch.cli.train import data_ranks_per_node

        with pytest.raises(ValueError, match="not divisible"):
            data_ranks_per_node({"accelerator": "cpu", "devices": 3,
                                 "mesh": {"expert": 2}})
        assert data_ranks_per_node({"accelerator": "cpu", "devices": 4,
                                    "mesh": {"expert": 2}}) == 2
        assert data_ranks_per_node({"accelerator": "cpu", "devices": 1,
                                    "num_nodes": 2,
                                    "mesh": {"expert": 2}}) == 1

    def test_block_across_data_ranks_raises(self, monkeypatch):
        """Under a 2 × 2 grid a block must lie within one data rank's
        rows; the global batch is d ranks' rows, not d·e."""
        from medmoe_torch.parallel import collectives as C
        from medmoe_torch.parallel import mesh

        module = instantiate(compose("train", BASE + [
            "model.loss.global_negatives=false",
            "model.loss.block_size=3"]).model)
        monkeypatch.setattr(C, "in_group", lambda: True)
        monkeypatch.setattr(mesh, "get_grid", lambda: mesh.Grid(2, 2, 0))
        monkeypatch.setattr("medmoe_torch.train.module.get_grid",
                            lambda: mesh.Grid(2, 2, 0))
        with pytest.raises(ValueError, match="block_size=3"):
            module._gathers(4)
        module.block_size = 8            # covers the global batch of 2 × 4
        assert module._gathers(4)
        module.block_size = 2            # within a data rank's 4 rows
        assert not module._gathers(4)


class TestConfigs:
    def test_ep_full_mix_keeps_jax_settings(self):
        jcfg = medmoe_tpu.compose("train", ["experiment=ep_full_mix"])
        cfg = compose("train", ["experiment=ep_full_mix"])
        assert cfg.model._target_.startswith("medmoe_torch.")
        assert cfg.model.model.vision == jcfg.model.model.vision
        assert cfg.model.model.vision.moe_mode == "ep"
        assert dict(cfg.trainer.mesh) == dict(jcfg.trainer.mesh) \
            == {"data": -1, "expert": 2}
        for key in ("batch_size", "train_data_paths", "val_data_paths"):
            assert cfg.data[key] == jcfg.data[key], key
        for key in ("accumulate_grad_batches", "gradient_clip_val",
                    "max_epochs"):
            assert cfg.trainer[key] == jcfg.trainer[key], key
        assert cfg.trainer.accelerator == "gpu"

    def test_ep_full_mix_trains_two_steps(self, runs):
        results, out = runs["grids"][2]
        res = [r[len(MODES)] for r in results]
        assert [r["step"] for r in res] == [2, 2]
        hist = res[0]["history"][-1]
        assert np.isfinite(hist["train/loss"]) and hist["train/grad_norm"] > 0
        dumps = _rank_dumps(out, 2, len(MODES))
        assert dumps[0]["image_encoder.swin_moe.moe.experts.proj_w0"] \
            .shape[0] == 3               # 6 experts over 2 ranks

    @pytest.mark.parametrize("group", ["ep", "ep_sim"])
    def test_trainer_groups(self, group):
        cfg = compose("train", ["experiment=zero_shot_dense",
                                f"trainer={group}"])
        want = {"ep": ("gpu", "auto"), "ep_sim": ("cpu", 4)}[group]
        assert (cfg.trainer.accelerator, cfg.trainer.devices) == want
        assert cfg.trainer.mesh.expert == 2
