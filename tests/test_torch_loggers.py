"""The port's loggers and ModelCheckpoint's hand-off to them, held against
the JAX package's on the same calls: JSONL records (equal apart from
``time``), the external backends and wandb against stub SDK modules (no
SDK ships in this image), their JSONL fallbacks, TensorBoard's event
files, and ModelCheckpoint's blocking decision and announcements for the
same logger sets."""

from __future__ import annotations

import glob
import json
import os
import sys
import types

import numpy as np
import pytest

import medmoe_torch.train.callbacks as tcb
import medmoe_torch.utils.loggers as tlog
import medmoe_tpu.train.callbacks as jcb
import medmoe_tpu.utils.checkpoint as jckpt
import medmoe_tpu.utils.loggers as jlog

PACKAGES = {"port": tlog, "jax": jlog}
METRICS = [({"train/loss": 1.5, "val/acc": np.float32(0.25)}, 3),
           ({"train/loss": 1.25, "lr": 5e-5}, 4)]


def _records(path, root):
    """The JSONL file's records with ``time`` dropped and ``root`` made
    relative."""
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    for r in recs:
        r.pop("time", None)
        if isinstance(r.get("path"), str):
            r["path"] = os.path.relpath(r["path"], root)
    return recs


def _both(tmp_path, build):
    """``build(module, save_dir)`` once for each package, in its own
    directory; returns {name: (result, save_dir)}."""
    out = {}
    for name, mod in PACKAGES.items():
        d = tmp_path / name
        d.mkdir()
        out[name] = (build(mod, str(d)), str(d))
    return out


class TestJsonl:
    def test_records_equal_jax(self, tmp_path):
        runs = _both(tmp_path, lambda m, d: m.JSONLLogger(d))
        for lg, _ in runs.values():
            for metrics, step in METRICS:
                lg.log_metrics(metrics, step)
        port, jax = ({k: _records(lg.path, d) for k, (lg, d) in runs.items()}
                     [n] for n in ("port", "jax"))
        assert port == jax and len(port) == 2
        assert port[0] == {"step": 3, "train/loss": 1.5, "val/acc": 0.25}


class TestTensorBoard:
    def test_event_files_hold_the_tags(self, tmp_path):
        runs = _both(tmp_path, lambda m, d: m.TensorBoardLogger(d, "tb"))
        tags = {}
        for name, (lg, d) in runs.items():
            for metrics, step in METRICS:
                lg.log_metrics(metrics, step)
            lg.finalize()
            files = glob.glob(os.path.join(d, "tb", "events.out.tfevents.*"))
            assert len(files) == 1, name
            data = open(files[0], "rb").read()
            tags[name] = {t for t in ("train/loss", "val/acc", "lr")
                          if t.encode() in data}
        assert tags["port"] == tags["jax"] == {"train/loss", "val/acc", "lr"}


# --- the external backends against stub SDKs ------------------------------

def _stub_mlflow(calls):
    m = types.ModuleType("mlflow")
    m.set_tracking_uri = lambda uri: calls.append(("uri", uri))
    m.start_run = lambda run_name=None: calls.append(("start", run_name))
    m.log_metrics = lambda metrics, step=None: calls.append(
        ("metrics", dict(metrics), step))
    m.log_params = lambda p: calls.append(("params", dict(p)))
    m.end_run = lambda: calls.append(("end",))
    return m


def _stub_comet(calls):
    m = types.ModuleType("comet_ml")

    class Experiment:
        def __init__(self, **kw):
            calls.append(("init", kw))

        def log_metrics(self, metrics, step=None):
            calls.append(("metrics", dict(metrics), step))

        def log_parameters(self, p):
            calls.append(("params", dict(p)))

        def end(self):
            calls.append(("end",))

    m.Experiment = Experiment
    return m


def _stub_neptune(calls):
    m = types.ModuleType("neptune")

    class Series:
        def __init__(self, key):
            self.key = key

        def append(self, value, step=None):
            calls.append(("append", self.key, value, step))

    class Run:
        def __getitem__(self, key):
            return Series(key)

        def __setitem__(self, key, value):
            calls.append(("set", key, value))

        def stop(self):
            calls.append(("end",))

    m.init_run = lambda **kw: (calls.append(("init", kw)), Run())[1]
    return m


def _stub_aim(calls):
    m = types.ModuleType("aim")

    class Run:
        def __init__(self, repo=None):
            calls.append(("init", repo))

        def track(self, value, name=None, step=None):
            calls.append(("track", name, value, step))

        def __setitem__(self, key, value):
            calls.append(("set", key, value))

        def close(self):
            calls.append(("end",))

    m.Run = Run
    return m


STUBS = {"mlflow": ("MLFlowLogger", _stub_mlflow, {"run_name": "r1"}),
         "comet_ml": ("CometLogger", _stub_comet, {"project_name": "p"}),
         "neptune": ("NeptuneLogger", _stub_neptune, {"project": "p"}),
         "aim": ("AimLogger", _stub_aim, {})}


@pytest.mark.parametrize("sdk", sorted(STUBS))
def test_external_backend_calls_equal_jax(sdk, tmp_path, monkeypatch):
    """Each backend makes the same SDK calls as JAX's: mlflow's tracking
    URI and '/'-free keys, comet's experiment, neptune's per-key append,
    aim's track; then the hyperparameters and the run's end."""
    ctor, stub, kw = STUBS[sdk]
    calls = {}
    for name, mod in PACKAGES.items():
        calls[name] = rec = []
        monkeypatch.setitem(sys.modules, sdk, stub(rec))
        d = tmp_path / name
        lg = getattr(mod, ctor)(save_dir=str(d), **kw)
        for metrics, step in METRICS:
            lg.log_metrics(metrics, step)
        lg.log_hyperparams({"seed": 1, "model": {"lr": 5e-5}})
        lg.finalize()
        lg.log_metrics({"after": 1.0}, 9)        # a finished run: fallback
        rec[:] = [tuple(x.replace(str(d), "<dir>") if isinstance(x, str)
                        else x for x in c) for c in rec]
        rec.append(_records(lg._fallback.path, str(d)))
    assert calls["port"] == calls["jax"]
    assert ("end",) in calls["port"]
    assert calls["port"][-1] == [{"step": 9, "after": 1.0}]


@pytest.mark.parametrize("ctor", ["CometLogger", "MLFlowLogger",
                                  "NeptuneLogger", "AimLogger"])
def test_missing_sdk_falls_back_like_jax(ctor, tmp_path):
    """No SDK in this image: the records land in
    ``<backend>_fallback.jsonl``, as JAX's do."""
    for sdk in ("comet_ml", "mlflow", "neptune", "aim"):
        assert sdk not in sys.modules
    runs = _both(tmp_path, lambda m, d: getattr(m, ctor)(save_dir=d))
    recs = {}
    for name, (lg, d) in runs.items():
        assert lg._impl is None
        for metrics, step in METRICS:
            lg.log_metrics(metrics, step)
        recs[name] = _records(lg._fallback.path, d)
        assert os.path.basename(lg._fallback.path) == \
            f"{lg.backend}_fallback.jsonl"
    assert recs["port"] == recs["jax"] and len(recs["port"]) == 2


def test_raising_backend_falls_back_like_jax(tmp_path, monkeypatch):
    def stub(rec):
        m = _stub_aim(rec)

        class Run(m.Run):
            def track(self, *a, **k):
                raise RuntimeError("backend down")

        m.Run = Run
        return m

    recs = {}
    for name, mod in PACKAGES.items():
        monkeypatch.setitem(sys.modules, "aim", stub([]))
        d = tmp_path / name
        lg = mod.AimLogger(save_dir=str(d))
        lg.log_metrics({"train/loss": 6.0}, 1)          # must not raise
        recs[name] = _records(lg._fallback.path, str(d))
    assert recs["port"] == recs["jax"] == [{"step": 1, "train/loss": 6.0}]


# --- wandb ------------------------------------------------------------------

class _Artifact:
    def __init__(self, name, type, metadata=None):
        self.desc = {"name": name, "type": type, "metadata": metadata,
                     "dirs": [], "files": []}

    def add_dir(self, path):
        self.desc["dirs"].append(os.path.basename(path))

    def add_file(self, path):
        self.desc["files"].append(os.path.basename(path))


def _stub_wandb(calls):
    m = types.ModuleType("wandb")

    class Run:
        id = "run-1"

        def __init__(self):
            self.config = types.SimpleNamespace(
                update=lambda p, allow_val_change=False: calls.append(
                    ("config", dict(p), allow_val_change)))

        def log(self, metrics, step=None):
            calls.append(("log", dict(metrics), step))

        def log_artifact(self, artifact, aliases=None):
            calls.append(("artifact", artifact.desc, list(aliases or [])))

        def finish(self):
            calls.append(("finish",))

    def init(**kw):
        kw["dir"] = os.path.basename(kw["dir"])
        calls.append(("init", kw))
        return Run()

    m.init = init
    m.Artifact = _Artifact
    return m


@pytest.mark.parametrize("kw", [
    {"offline": True, "id": "run-42", "prefix": "pre/", "name": "n",
     "job_type": "train", "log_model": True},
    {"log_model": False, "tags": ["a"], "group": "g"},
])
def test_wandb_calls_equal_jax(kw, tmp_path, monkeypatch):
    """The same wandb.init arguments (offline, id resume, prefix, ...),
    metrics, config and artifacts (log_model) as JAX's logger; after
    finalize the logs go to the fallback file."""
    calls = {}
    for name, mod in PACKAGES.items():
        calls[name] = rec = []
        monkeypatch.setitem(sys.modules, "wandb", _stub_wandb(rec))
        d = tmp_path / name / "run"
        d.mkdir(parents=True)
        ckpt = d / "epoch_000"
        ckpt.write_bytes(b"x")
        lg = mod.WandbLogger(save_dir=str(d), project="p", **kw)
        for metrics, step in METRICS:
            lg.log_metrics(metrics, step)
        lg.log_hyperparams({"seed": 1})
        lg.log_checkpoint(str(ckpt), alias="best", metadata={"epoch": 0})
        lg.finalize()
        lg.log_metrics({"after": 1.0}, 9)
        calls[name].append(_records(d / "wandb_fallback.jsonl", str(d)))
    assert calls["port"] == calls["jax"]
    kinds = [c[0] for c in calls["port"][:-1]]
    assert kinds.count("artifact") == int(kw["log_model"])
    assert calls["port"][-1] == [{"step": 9, "after": 1.0}]


def test_wandb_fallback_records_equal_jax(tmp_path):
    """Without wandb: metrics and the checkpoint events in
    wandb_fallback.jsonl, the same records as JAX's."""
    assert "wandb" not in sys.modules
    runs = _both(tmp_path, lambda m, d: m.WandbLogger(d, log_model=True))
    recs = {}
    for name, (lg, d) in runs.items():
        assert lg._run is None
        lg.log_metrics(*METRICS[0])
        lg.log_checkpoint(os.path.join(d, "ck", "last"), alias="last",
                          metadata={"epoch": 1, "val/loss": np.float32(2)})
        recs[name] = _records(lg._fallback.path, d)
    assert recs["port"] == recs["jax"]
    assert recs["port"][1] == {"event": "checkpoint", "path": "ck/last",
                               "alias": "last", "epoch": 1, "val/loss": 2.0}


# --- ModelCheckpoint: the blocking decision and the hand-off ---------------

class _Duck:
    """An artifact logger that is no BaseLogger."""

    def __init__(self):
        self.calls = []

    def log_checkpoint(self, path, alias="last", metadata=None):
        self.calls.append((os.path.basename(path), alias,
                           dict(metadata or {})))


LOGGER_SETS = {
    "none": lambda m, d: [],
    "csv": lambda m, d: [m.CSVLogger(d)],
    "jsonl+tensorboard": lambda m, d: [m.JSONLLogger(d),
                                       m.TensorBoardLogger(d)],
    "wandb_log_model": lambda m, d: [m.CSVLogger(d),
                                     m.WandbLogger(d, log_model=True)],
    "wandb_no_log_model": lambda m, d: [m.WandbLogger(d, log_model=False)],
    "external": lambda m, d: [m.MLFlowLogger(d), m.AimLogger(d)],
    "duck": lambda m, d: [_Duck()],
    "plain_object": lambda m, d: [object()],
}


@pytest.mark.parametrize("async_save", [True, False])
@pytest.mark.parametrize("loggers", sorted(LOGGER_SETS))
def test_model_checkpoint_equals_jax(loggers, async_save, tmp_path,
                                     monkeypatch):
    """For the same loggers, the port's ModelCheckpoint saves blocking or
    not as JAX's does (blocking only for a logger that reads the files),
    and announces the same checkpoints, aliases and metadata: best and
    last on an improvement, last alone otherwise."""
    seen = {}
    for name, mod, module in (("port", tlog, tcb), ("jax", jlog, jckpt)):
        saves = []
        monkeypatch.setattr(
            module, "save_checkpoint",
            lambda path, state, extra=None, blocking=True, saves=saves:
                saves.append((os.path.basename(path), blocking)))
        d = tmp_path / name
        d.mkdir()
        lgs = LOGGER_SETS[loggers](mod, str(d))
        trainer = types.SimpleNamespace(state=None, loggers=lgs,
                                        default_root_dir=str(d))
        cbmod = tcb if name == "port" else jcb
        reads = [cbmod._reads_checkpoint_files(lg) for lg in lgs]
        cb = cbmod.ModelCheckpoint(dirpath=str(d / "ck"),
                                   async_save=async_save)
        for epoch, loss in enumerate((1.0, 2.0, 0.5)):
            cb.on_epoch_end(trainer, epoch, {"val/loss": loss})
        announced = [c for lg in lgs if isinstance(lg, _Duck)
                     for c in lg.calls]
        fallback = [_records(lg._fallback.path, str(d)) for lg in lgs
                    if isinstance(lg, mod.WandbLogger) and lg.log_model]
        seen[name] = (saves, reads, announced, fallback)
    assert seen["port"] == seen["jax"]
    saves, reads, announced, fallback = seen["port"]
    assert [s for s, _ in saves] == ["epoch_000", "last", "last",
                                     "epoch_002", "last"]
    assert {b for _, b in saves} == {(not async_save) or any(reads)}
    if loggers == "duck":
        assert announced == [
            ("epoch_000", "best", {"epoch": 0, "val/loss": 1.0}),
            ("last", "last", {"epoch": 0}), ("last", "last", {"epoch": 1}),
            ("epoch_002", "best", {"epoch": 2, "val/loss": 0.5}),
            ("last", "last", {"epoch": 2})]
    if loggers == "wandb_log_model":
        assert [r["alias"] for r in fallback[0]] == [
            "best", "last", "last", "best", "last"]


def test_saves_with_a_reading_logger_are_files_when_announced(tmp_path):
    """Through the real save: with wandb's log_model on, each announced
    checkpoint is a whole file with its sidecar when the logger reads it
    (the save ran blocking)."""
    import torch

    from medmoe_torch.train.state import TrainState

    class Reader(tlog.BaseLogger):
        log_model = True

        def __init__(self):
            self.sizes = []

        def log_checkpoint(self, path, alias="last", metadata=None):
            self.sizes.append((alias, os.path.getsize(path) > 0,
                               os.path.isfile(path + ".meta.json")))

    from medmoe_torch.train.optim import adam

    state = TrainState.create(torch.nn.Linear(4, 3), adam())
    reader = Reader()
    trainer = types.SimpleNamespace(state=state, loggers=[reader],
                                    default_root_dir=str(tmp_path))
    cb = tcb.ModelCheckpoint(dirpath=str(tmp_path / "ck"), async_save=True)
    cb.on_epoch_end(trainer, 0, {"val/loss": 1.0})
    cb.on_train_end(trainer)
    assert reader.sizes == [("best", True, True), ("last", True, True)]
