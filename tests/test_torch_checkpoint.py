"""The port's checkpoints, callbacks, resume, preemption and serving of what
it trained, on the CPU.

  * ``utils/checkpoint.py``: a save/restore round trip (blocking and
    async) loaded with ``torch.load(weights_only=True)``; a failed
    background write leaves no file, no temporary and no sidecar and
    raises at the next barrier; a mutation after an async save does not
    reach the file; a shape mismatch names its parameter; the frozen BERT
    has no Adam state (as ``tests/test_loop_semantics.py`` holds for JAX);
  * ``ModelCheckpoint``'s kept set and ``EarlyStopping``'s stop epoch
    against the JAX callbacks on the same ``val/loss`` sequences (a stub
    trainer, as ``tests/test_checkpoint.py`` drives them); the top-k set
    rebuilt after a resume; deletion on rank 0 only;
  * a tiny trainer from tar shards on disk: 2 epochs straight against
    1 epoch, save, resume and 1 more — ``torch.equal`` on every parameter
    and Adam moment, the same step and scheduler state, at f32;
    ``request_preemption`` mid-epoch writes ``last`` whose sidecar names
    the previous epoch, and the resumed run continues the step count;
  * ``python -m medmoe_torch.cli.serve`` from the trainer's checkpoint
    returns the module's own embeddings bit for bit; a JAX
    ``weights.npz`` still loads; an orbax directory raises;
  * the CSV logger: a resumed run appends after the old rows, widens the
    header and loses nothing, and a failed rewrite leaves the old file.
"""

import csv
import io
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from medmoe_tpu.train import callbacks as jcb
from medmoe_tpu.train.state import TrainState as JState
from medmoe_torch.config import compose
from medmoe_torch.data.shard_writer import ShardWriter
from medmoe_torch.train import callbacks as tcb
from medmoe_torch.train import loop
from medmoe_torch.train.optim import adam, reduce_lr_on_plateau
from medmoe_torch.train.state import TrainState
from medmoe_torch.utils import checkpoint as ck
from medmoe_torch.utils.loggers import CSVLogger

torch.set_num_threads(1)


def _state(seed=0, width=3):
    torch.manual_seed(seed)
    model = nn.Sequential(nn.Linear(4, width), nn.Tanh(), nn.Linear(width, 2))
    model[2].requires_grad_(False)             # frozen: no Adam state
    state = TrainState.create(model, adam(lr=1e-2))
    x = torch.randn(5, 4)
    for _ in range(2):
        loss = model(x).square().sum()
        state.apply_gradients(list(torch.autograd.grad(loss, state.params)))
    return state


def _flat(sd):
    """name → tensor over a state_dict, the optimizer's nested too."""
    out = {}
    for k, v in sd.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in _flat(v).items()})
        elif isinstance(v, torch.Tensor):
            out[str(k)] = v
    return out


def _assert_states_equal(a, b):
    fa, fb = _flat(a.state_dict()), _flat(b.state_dict())
    assert fa.keys() == fb.keys()
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k
    assert a.step == b.step


class TestCheckpointFile:
    @pytest.mark.parametrize("blocking", [True, False])
    def test_round_trip(self, tmp_path, blocking):
        state = _state()
        sched = reduce_lr_on_plateau()
        sched.step(1.5, 1e-2)
        extra = {"epoch": 4, "val/loss": 1.5, "seed": 12,
                 "scheduler": sched.state_dict()}
        path = str(tmp_path / "ck" / "epoch_004")
        ck.save_checkpoint(path, state, extra=extra, blocking=blocking)
        ck.finalize_saves()
        raw = torch.load(path, weights_only=True)
        assert raw["format"] == ck.FORMAT and raw["seed"] == 12
        assert raw["scheduler"] == {"best": 1.5, "num_bad_epochs": 0}
        assert ck.read_meta(path) == extra
        assert ck.checkpoint_kind(path) == "torch"
        fresh = _state(seed=1)
        payload = ck.restore_checkpoint(path, fresh)
        _assert_states_equal(fresh, state)
        assert payload["step"] == 2 == fresh.step
        assert not os.path.exists(path + ".tmp")

    def test_failed_background_write_leaves_nothing(self, tmp_path,
                                                    monkeypatch):
        real_save = torch.save

        def broken_save(obj, f):
            with open(f, "wb") as out:
                out.write(b"half a checkpoint")
            raise OSError("disk full")

        monkeypatch.setattr(torch, "save", broken_save)
        path = str(tmp_path / "last")
        ck.save_checkpoint(path, _state(), extra={"epoch": 0},
                           blocking=False)
        with pytest.raises(OSError, match="disk full"):
            ck.finalize_saves()
        assert sorted(os.listdir(tmp_path)) == []
        ck.finalize_saves()                   # the error surfaced once
        monkeypatch.setattr(torch, "save", real_save)
        ck.save_checkpoint(path, _state(), extra={"epoch": 1},
                           blocking=False)
        ck.finalize_saves()
        assert ck.read_meta(path) == {"epoch": 1}

    def test_mutation_after_async_save_is_not_saved(self, tmp_path,
                                                    monkeypatch):
        import threading

        gate = threading.Event()
        real_write = ck._write_file

        def held_write(path, payload):
            gate.wait(10)
            real_write(path, payload)

        monkeypatch.setattr(ck, "_write_file", held_write)
        state = _state()
        want = {k: v.clone() for k, v in _flat(state.state_dict()).items()}
        path = str(tmp_path / "snap")
        ck.save_checkpoint(path, state, blocking=False)
        with torch.no_grad():
            for p in state.model.parameters():
                p.add_(1.0)
            for s in state.optimizer.state.values():
                s["exp_avg"].mul_(3.0)
        gate.set()
        ck.finalize_saves()
        got = _flat(torch.load(path, weights_only=True))
        for k, v in want.items():
            assert torch.equal(got[k], v), k

    def test_shape_mismatch_names_the_parameter(self, tmp_path):
        path = str(tmp_path / "c")
        ck.save_checkpoint(path, _state(width=3))
        with pytest.raises(ValueError, match="'0.weight'"):
            ck.restore_checkpoint(path, _state(width=5))

    def test_frozen_bert_has_no_adam_state(self):
        from medmoe_torch.models.medmoe import MedMoE
        from medmoe_torch.config import DotDict
        from medmoe_torch.train.module import MedMoEPretrainingModule

        vision = DotDict(model_name="swin", use_moe=True, embed_dim=16,
                         num_experts=3, moe_mode="gather", image_size=56,
                         swin_embed_dim=8, swin_depths=[1, 1],
                         swin_num_heads=[1, 2], dtype="float32")
        text = DotDict(hidden_size=16, num_layers=2, num_heads=2,
                       intermediate_size=32, vocab_size=64, embed_dim=16,
                       max_length=10, dtype="float32", freeze_bert=True)
        module = MedMoEPretrainingModule(model=MedMoE(vision, text),
                                         loss=DotDict())
        state = TrainState.create(module.model, module.make_optimizer())
        state.apply_gradients([torch.zeros_like(p) for p in state.params])
        moments = state.state_dict()["optimizer"]["state"]
        n_moments = sum(s["exp_avg"].numel() + s["exp_avg_sq"].numel()
                        for s in moments.values())
        n_all = sum(p.numel() for p in module.model.parameters())
        n_frozen = sum(p.numel()
                       for p in module.model.text_encoder.bert.parameters())
        assert n_frozen > 0 and n_moments == 2 * (n_all - n_frozen)


def _stub(state, root):
    return types.SimpleNamespace(state=state, loggers=[],
                                 default_root_dir=str(root),
                                 checkpoint_extra=dict)


def _kept(dirpath):
    """The monitored checkpoints in ``dirpath`` (not ``last``, sidecars or
    an in-flight write's temporary)."""
    return sorted(n for n in os.listdir(dirpath)
                  if not n.endswith((".meta.json", ".tmp")) and n != "last")


def _jax_state():
    params = {"w": jnp.arange(6, dtype=jnp.float32).reshape(3, 2)}
    return JState.create(params, optax.adam(1e-3))


SEQUENCES = [[3.0, 2.0, 2.5, 1.5, 1.7, 1.0],
             [1.0, 2.0, 3.0, 2.5, 4.0],
             [2.0, 2.0, float("nan"), 1.0]]


class TestCallbacksAgainstJax:
    @pytest.mark.parametrize("top_k,mode", [(1, "min"), (2, "min"),
                                            (-1, "min"), (2, "max")])
    def test_model_checkpoint_kept_set(self, tmp_path, top_k, mode):
        values = SEQUENCES[0] if mode == "min" else SEQUENCES[1]
        cbs = []
        for name, mod, state in (("jax", jcb, _jax_state()),
                                 ("torch", tcb, _state())):
            cb = mod.ModelCheckpoint(dirpath=str(tmp_path / name),
                                     save_top_k=top_k, mode=mode,
                                     save_last=True, async_save=False)
            trainer = _stub(state, tmp_path)
            for epoch, v in enumerate(values):
                cb.on_epoch_end(trainer, epoch, {"val/loss": v})
            cbs.append(cb)
        assert _kept(tmp_path / "jax") == _kept(tmp_path / "torch")
        assert os.path.basename(cbs[0].best_path) == \
            os.path.basename(cbs[1].best_path)
        assert os.path.isfile(tmp_path / "torch" / "last")

    @pytest.mark.parametrize("values", SEQUENCES)
    @pytest.mark.parametrize("patience,min_delta,mode", [
        (1, 0.0, "min"), (2, 0.3, "min"), (2, 0.0, "max")])
    def test_early_stopping_epoch(self, values, patience, min_delta, mode):
        def stop_epoch(mod):
            cb = mod.EarlyStopping(patience=patience, min_delta=min_delta,
                                   mode=mode)
            for epoch, v in enumerate(values):
                cb.on_epoch_end(None, epoch, {"val/loss": v})
                if cb.should_stop:
                    return epoch
            return None

        assert stop_epoch(tcb) == stop_epoch(jcb)


class TestTopKAfterResume:
    def test_rebuilt_from_sidecars(self, tmp_path):
        first = tcb.ModelCheckpoint(dirpath=str(tmp_path), save_top_k=2,
                                    async_save=False)
        trainer = _stub(_state(), tmp_path)
        for epoch, v in enumerate([3.0, 2.0, 1.0]):
            first.on_epoch_end(trainer, epoch, {"val/loss": v})
        assert _kept(tmp_path) == ["epoch_001", "epoch_002"]
        resumed = tcb.ModelCheckpoint(dirpath=str(tmp_path), save_top_k=2,
                                      async_save=True)
        trainer.resumed_from = str(tmp_path / "last")
        resumed.on_epoch_end(trainer, 3, {"val/loss": 2.5})   # no save
        assert _kept(tmp_path) == ["epoch_001", "epoch_002"]
        assert resumed.best_path == str(tmp_path / "epoch_002")
        resumed.on_epoch_end(trainer, 4, {"val/loss": 0.5})
        resumed.on_train_end(trainer)
        assert _kept(tmp_path) == ["epoch_002", "epoch_004"]
        assert not os.path.exists(tmp_path / "epoch_001.meta.json")

    def test_fresh_run_keeps_a_fresh_set(self, tmp_path):
        """A second fresh run in the same directory, worse than the first:
        its best is its own file and the first run's file stays, as with
        the JAX callback."""
        bests = []
        for name, mod, make in (("jax", jcb, _jax_state),
                                ("torch", tcb, _state)):
            dirpath = str(tmp_path / name)
            for values in ([2.0, 1.0], [3.0]):
                cb = mod.ModelCheckpoint(dirpath=dirpath, save_top_k=1,
                                         async_save=False)
                trainer = _stub(make(), tmp_path)
                for epoch, v in enumerate(values):
                    cb.on_epoch_end(trainer, epoch, {"val/loss": v})
                cb.on_train_end(trainer)
            bests.append(os.path.basename(cb.best_path))
            assert _kept(dirpath) == ["epoch_000", "epoch_001"]
        assert bests == ["epoch_000", "epoch_000"]
        assert ck.read_meta(str(tmp_path / "torch" / "epoch_000"))[
            "val/loss"] == 3.0

    def test_only_rank_zero_deletes(self, tmp_path, monkeypatch):
        cb = tcb.ModelCheckpoint(dirpath=str(tmp_path), save_top_k=1,
                                 save_last=False, async_save=False)
        trainer = _stub(_state(), tmp_path)
        cb.on_epoch_end(trainer, 0, {"val/loss": 2.0})
        monkeypatch.setattr(tcb, "_process_index", lambda: 1)
        cb.on_epoch_end(trainer, 1, {"val/loss": 1.0})
        assert _kept(tmp_path) == ["epoch_000", "epoch_001"]
        assert [os.path.basename(p) for _, p in cb._kept] == ["epoch_001"]


# --- a tiny trainer from tar shards on disk --------------------------------

TINY = [
    "experiment=pretraining_medmoe_ddp", "data=unimed", "data.batch_size=4",
    "data.image_size=56", "data.num_workers=0", "data.shuffle_buffer=6",
    "model.model.vision.image_size=56", "model.model.vision.swin_embed_dim=8",
    "model.model.vision.swin_depths=[1,1]",
    "model.model.vision.swin_num_heads=[1,2]",
    "model.model.vision.num_experts=3", "model.model.vision.embed_dim=16",
    "model.model.vision.dtype=float32", "model.model.text.hidden_size=16",
    "model.model.text.num_layers=2", "model.model.text.num_heads=2",
    "model.model.text.intermediate_size=32", "model.model.text.vocab_size=64",
    "model.model.text.embed_dim=16", "model.model.text.max_length=10",
    "model.model.text.dtype=float32", "trainer.accelerator=cpu",
    "trainer.accumulate_grad_batches=2", "trainer.limit_train_batches=4",
    "trainer.limit_val_batches=1", "trainer.num_sanity_val_steps=0",
    "trainer.log_every_n_steps=1", "logger=csv", "extras.print_config=false",
]


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("shards")
    rng = np.random.RandomState(0)

    def jpeg(h, w):
        buf = io.BytesIO()
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
            buf, format="JPEG", quality=90)
        return buf.getvalue()

    for name, n in (("train-000001", 12), ("train-000002", 12),
                    ("val-000001", 8)):
        with ShardWriter(str(root / f"{name}.tar")) as w:
            for i in range(n):
                w.write({"__key__": f"{name}_{i:03d}", "jpg": jpeg(60, 72),
                         "txt": f"scan number {i}_radimagenet_image {i}",
                         "cls": i % 3})
    images = root / "serve"
    images.mkdir()
    for i in range(5):
        Image.fromarray((rng.rand(50, 64, 3) * 255).astype(np.uint8)).save(
            images / f"img_{i}.png")
    return root


def _run(shards, root, *extra):
    from medmoe_torch.cli.train import train

    cfg = compose("train", TINY + [
        f"data.train_data_paths={shards}/train-{{000001..000002}}.tar",
        f"data.val_data_paths={shards}/val-000001.tar",
        f"paths.root_dir={root}", *extra])
    _, objs = train(cfg)
    return objs["trainer"], objs["module"], cfg


def _ckpt_dir(root):
    return os.path.join(root, "logs", "train", "runs", "checkpoints")


@pytest.fixture(scope="module")
def resumed(shards, tmp_path_factory):
    straight = _run(shards, tmp_path_factory.mktemp("straight"),
                    "trainer.max_epochs=2")
    root = tmp_path_factory.mktemp("resumed")
    first = _run(shards, root, "trainer.max_epochs=1")
    last = os.path.join(_ckpt_dir(root), "last")
    second = _run(shards, root, "trainer.max_epochs=2", f"ckpt_path={last}")
    return straight, first, second, root


class TestResume:
    def test_bit_equal_to_straight_run(self, resumed):
        (straight, _, _), (first, _, _), (second, _, _), _ = resumed
        assert first.state.step == 2
        assert straight.state.step == second.state.step == 4
        assert straight.resumed_from is None and first.resumed_from is None
        assert second.resumed_from == os.path.join(_ckpt_dir(
            resumed[3]), "last")
        _assert_states_equal(second.state, straight.state)
        assert second.scheduler.state_dict() == \
            straight.scheduler.state_dict()
        assert second.metrics_history[-1]["val/loss"] == \
            straight.metrics_history[-1]["val/loss"]

    def test_checkpoints_and_csv_history(self, resumed):
        (straight, _, _), _, (second, _, _), root = resumed
        ckdir = _ckpt_dir(root)
        assert len(_kept(ckdir)) == 1 and os.path.isfile(
            os.path.join(ckdir, "last"))
        assert ck.read_meta(os.path.join(ckdir, "last"))["epoch"] == 1
        assert second.best_model_path and \
            os.path.basename(second.best_model_path) in _kept(ckdir)
        with open(os.path.join(root, "logs", "train", "runs", "csv",
                               "metrics.csv")) as f:
            rows = list(csv.DictReader(f))
        epochs = [float(r["epoch"]) for r in rows
                  if r.get("train/loss") and r.get("lr")]
        assert epochs == [0.0, 0.0, 1.0, 1.0]    # both runs' steps, in order

    def test_serve_the_checkpoint(self, resumed, shards, capsys):
        from medmoe_torch.cli import serve
        from medmoe_torch.data.transforms import ImageTransform, decode_image
        from medmoe_torch.eval.zero_shot import make_image_embedder

        _, _, (second, module, cfg), root = resumed
        best = second.best_model_path
        module.model.load_state_dict(ck.load_checkpoint(best)["model"])
        module.model.eval()
        paths = sorted((shards / "serve").glob("*.png"))
        transform = ImageTransform(56, train=False)
        batch = np.stack([transform(decode_image(p.read_bytes()))
                          for p in paths])
        want = make_image_embedder(module.model)(batch).numpy()
        capsys.readouterr()
        rc = serve.main([o for o in TINY if o.startswith("model.")] + [
            "data=unimed", "device=cpu", f"ckpt_path={best}",
            "serve.mode=embed", f"serve.input={shards / 'serve'}",
            f"serve.batch_size={len(paths)}", f"paths.root_dir={root}"])
        assert rc == 0
        recs = [json.loads(line) for line in
                capsys.readouterr().out.splitlines() if line.startswith("{")]
        assert [r["path"] for r in recs] == [str(p) for p in paths]
        got = np.asarray([r["embedding"] for r in recs], np.float32)
        assert np.array_equal(got, want)


    def test_cli_tests_the_best_checkpoint(self, shards, tmp_path):
        from medmoe_torch.cli.train import train

        cfg = compose("train", TINY + [
            f"data.train_data_paths={shards}/train-{{000001..000002}}.tar",
            f"data.val_data_paths={shards}/val-000001.tar",
            f"paths.root_dir={tmp_path}", "trainer.max_epochs=2",
            "test=true", "trainer.limit_test_batches=1"])
        metrics, objs = train(cfg)
        best = objs["trainer"].best_model_path
        assert best and np.isfinite(metrics["test/loss"])
        saved = ck.load_checkpoint(best)["model"]
        for k, v in objs["module"].model.state_dict().items():
            assert torch.equal(v, saved[k]), k


class TestPreemption:
    def test_request_preemption_mid_epoch(self, shards, tmp_path,
                                          monkeypatch):
        trainers = []
        real_fit, real_build = loop.Trainer._fit, loop.build_train_step

        def spy_fit(self, *a, **k):
            trainers.append(self)
            return real_fit(self, *a, **k)

        def build(module, accum_steps=1):
            step = real_build(module, accum_steps)

            def preempting(state, window):
                out = step(state, window)
                if state.step == 3:        # the first step of epoch 1
                    trainers[-1].request_preemption()
                return out
            return preempting

        monkeypatch.setattr(loop.Trainer, "_fit", spy_fit)
        monkeypatch.setattr(loop, "build_train_step", build)
        trainer, _, _ = _run(shards, tmp_path, "trainer.max_epochs=3")
        assert trainer.interrupted and trainer.state.step == 3
        assert len(trainer.metrics_history) == 1
        last = os.path.join(_ckpt_dir(tmp_path), "last")
        meta = ck.read_meta(last)
        assert meta["epoch"] == 0 and meta["preempted"] is True
        assert torch.load(last, weights_only=True)["step"] == 3

        monkeypatch.setattr(loop, "build_train_step", real_build)
        resumed, _, _ = _run(shards, tmp_path, "trainer.max_epochs=3",
                             f"ckpt_path={last}")
        # epochs 1 and 2 again from step 3: two steps each
        assert not resumed.interrupted and resumed.state.step == 7
        assert [h["epoch_time_s"] > 0 for h in resumed.metrics_history] == \
            [True, True]

    def test_signal_handlers(self):
        import signal
        import threading

        trainer = loop.Trainer(accelerator="cpu")
        before = signal.getsignal(signal.SIGTERM)
        previous = trainer._install_signal_handlers()
        try:
            if threading.current_thread() is threading.main_thread():
                assert set(previous) >= {signal.SIGTERM}
                signal.getsignal(signal.SIGUSR1)(signal.SIGUSR1, None)
                assert trainer._preempt_requested
            else:                       # signal.signal refuses: no-op
                assert previous == {}
        finally:
            trainer._restore_signal_handlers(previous)
        assert signal.getsignal(signal.SIGTERM) == before
        off = loop.Trainer(accelerator="cpu", checkpoint_on_signal=False)
        assert off._install_signal_handlers() == {}


class TestServeFormats:
    def test_weights_npz_loads_and_others_raise(self, tmp_path):
        import zipfile

        from medmoe_tpu.eval.export import _save_weights
        from medmoe_torch.eval.zero_shot import load_weights

        model = nn.Linear(3, 2)
        npz = str(tmp_path / "weights.npz")
        _save_weights(npz, {"kernel": np.arange(6, dtype=np.float32)
                            .reshape(3, 2), "bias": np.ones(2, np.float32)})
        assert ck.checkpoint_kind(npz) == "npz"
        load_weights(model, npz)
        assert torch.equal(model.weight, torch.arange(6.).reshape(3, 2).T)
        orbax_dir = tmp_path / "epoch_003"
        orbax_dir.mkdir()
        with pytest.raises(ValueError, match="medmoe_tpu.cli.export"):
            load_weights(model, str(orbax_dir))
        other = tmp_path / "other.zip"
        with zipfile.ZipFile(other, "w") as z:
            z.writestr("readme.txt", "hello")
        (tmp_path / "plain.bin").write_bytes(b"\x00" * 64)
        for bad in (other, tmp_path / "plain.bin"):
            with pytest.raises(ValueError, match="neither"):
                load_weights(model, str(bad))


class TestCsvLogger:
    def test_resumed_run_appends(self, tmp_path):
        first = CSVLogger(str(tmp_path))
        for step in range(3):
            first.log_metrics({"train/loss": 1.0 - step / 10}, step)
        first.finalize()
        resumed = CSVLogger(str(tmp_path))
        resumed.log_metrics({"train/loss": 0.5, "val/loss": 0.7}, 3)
        resumed.log_metrics({"epoch_time_s": 2.0}, 4)
        resumed.finalize()
        with open(tmp_path / "csv" / "metrics.csv") as f:
            reader = csv.DictReader(f)
            rows = list(reader)
        assert {"train/loss", "val/loss", "epoch_time_s", "step",
                "time"} <= set(reader.fieldnames)
        assert [int(r["step"]) for r in rows] == [0, 1, 2, 3, 4]
        assert [r["train/loss"] for r in rows[:4]] == \
            ["1.0", "0.9", "0.8", "0.5"]
        assert rows[3]["val/loss"] == "0.7" and rows[0]["val/loss"] == ""
        assert sorted(os.listdir(tmp_path / "csv")) == ["metrics.csv"]

    def test_failed_rewrite_keeps_the_old_file(self, tmp_path, monkeypatch):
        first = CSVLogger(str(tmp_path))
        first.log_metrics({"a": 1.0}, 0)
        first.finalize()
        path = tmp_path / "csv" / "metrics.csv"
        before = path.read_text()

        def crash(src, dst):
            raise OSError("crash mid-rewrite")

        monkeypatch.setattr(os, "replace", crash)
        with pytest.raises(OSError):
            CSVLogger(str(tmp_path)).log_metrics({"a": 2.0, "b": 3.0}, 1)
        assert path.read_text() == before
