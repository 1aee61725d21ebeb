"""The port's CLI and host surface against the JAX package's: the sweep
samplers (draw for draw), ``--multirun`` expansion and jobs, the
``MEDMOE_METRICS_OUT`` contract, ``--help``, the console scripts, the
trainer's profiler, and the composed ``train`` config of every experiment
and debug mode (equal to JAX's apart from the names listed in
``DELIBERATE``)."""

import json
import math
import os
import random
import tomllib

import numpy as np
import pytest
import torch

import medmoe_tpu
from medmoe_torch.cli import _help, _script
from medmoe_torch.cli import train as tcli
from medmoe_torch.config import compose, to_dict
from medmoe_torch.config.loader import DEFAULT_CONFIG_DIR
from medmoe_torch.train import sweep as tsweep
from medmoe_tpu.cli import train as jcli
from medmoe_tpu.config import to_dict as jto_dict
from medmoe_tpu.train import sweep as jsweep
from tests.test_torch_train import TINY_OVERRIDES

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a space with every kind of dimension
SPACE = {
    "lr": {"low": 1e-6, "high": 1e-2, "log": True},
    "x": {"low": -2.0, "high": 3.0},
    "n": {"low": 1, "high": 64, "int": True},
    "c": {"choices": ["a", "b", "c"]},
    "l": [8, 16, 32],
    "fixed": 7,
}

# the tiny pretraining run every CLI test here trains (f32 towers)
TINY = TINY_OVERRIDES + ["debug=fdr", "trainer.accumulate_grad_batches=1",
                         "logger=csv", "callbacks=none"]
SWEEP = ["experiment=pretraining_medmoe", "hparams_search=medmoe_tpe",
         "hparams_search.n_trials=2", "hparams_search.n_startup_trials=2",
         "~hparams_search.params.data.batch_size",
         "~hparams_search.params.model.loss.classifier_loss_weight",
         "optimized_metric=train/loss"]


def _score(draw):
    """A deterministic objective over SPACE's draws."""
    return (abs(math.log10(draw["lr"]) + 4.0) + (draw["x"] - 0.5) ** 2
            + abs(draw["n"] - 20) / 10 + {"a": 1.0, "b": 0.0, "c": 2.0}[
                draw["c"]] + draw["l"] / 32)


class TestSamplers:
    @pytest.mark.parametrize("seed", [0, 1234])
    def test_random_draws_equal_jax(self, seed):
        a, b = random.Random(seed), random.Random(seed)
        for _ in range(8):
            assert tsweep._sample(SPACE, a) == jsweep._sample(SPACE, b)

    @pytest.mark.parametrize("seed", [0, 1234])
    def test_tpe_draws_equal_jax(self, seed):
        """Startup draws, then the Parzen fits (bandwidths, candidates
        from l, categorical ratios) over a growing history: the same
        values, exactly (both draw from random.Random and RandomState)."""
        t = tsweep.TPESampler(SPACE, seed=seed, n_startup_trials=3,
                              n_candidates=16)
        j = jsweep.TPESampler(SPACE, seed=seed, n_startup_trials=3,
                              n_candidates=16)
        th, jh = [], []
        for i in range(12):
            dt, dj = t.suggest(th), j.suggest(jh)
            assert dt == dj, i
            th.append((dt, _score(dt)))
            jh.append((dj, _score(dj)))
        # a failed trial (+inf) is left out of the fit on both sides
        th.append((dt, float("inf")))
        jh.append((dj, float("inf")))
        assert t.suggest(th) == j.suggest(jh)

    def test_parzen_bandwidths_equal_jax(self):
        vals = [0.1, 0.15, 0.7, 0.72, 0.95]
        for args in ((vals, 0.0, 1.0), (vals[:1], 0.0, 1.0)):
            for a, b in zip(tsweep.TPESampler._parzen(*args),
                            jsweep.TPESampler._parzen(*args)):
                np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("sampler", ["tpe", "random"])
    def test_sweep_trials_equal_jax(self, sampler, monkeypatch):
        """run_sweep over the shipped search space with a stand-in trial:
        the same trial overrides in the same order, the same best value
        and draws, a failed trial skipped on both sides."""
        over = ["experiment=pretraining_medmoe", "hparams_search=medmoe_tpe",
                f"hparams_search.sampler={sampler}",
                "hparams_search.n_trials=7",
                "hparams_search.n_startup_trials=3",
                "hparams_search.launcher=subprocess"]
        runs = {}
        for name, mod, comp in (("port", tsweep, compose),
                                ("jax", jsweep, medmoe_tpu.compose)):
            calls = []

            def trial(overrides, metric, calls=calls):
                calls.append(list(overrides))
                if len(calls) == 2:
                    raise RuntimeError("trial subprocess exited 1")
                kv = dict(o.split("=", 1) for o in overrides if "=" in o)
                return (abs(math.log10(float(kv["model.optimizer.lr"])) + 4)
                        + int(kv["data.batch_size"]) / 256
                        + float(kv["model.loss.classifier_loss_weight"]))

            monkeypatch.setattr(mod, "_run_trial_subprocess", trial)
            out = mod.run_sweep(comp("train", over), over)
            runs[name] = (calls, out)
        assert runs["port"] == runs["jax"]
        calls, out = runs["port"]
        assert len(calls) == 7
        assert not any(o.startswith("hparams_search") for c in calls
                       for o in c)
        assert {"val/loss", "best/model.optimizer.lr", "best/data.batch_size",
                "best/model.loss.classifier_loss_weight"} == set(out)

    def test_shipped_search_spaces_equal_jax(self):
        for name in ("medmoe_random", "medmoe_tpe"):
            over = ["experiment=pretraining_medmoe", f"hparams_search={name}"]
            assert to_dict(compose("train", over).hparams_search) == \
                jto_dict(medmoe_tpu.compose("train", over).hparams_search)

    def test_unknown_launcher_raises(self):
        cfg = compose("train", ["hparams_search=medmoe_tpe",
                                "hparams_search.launcher=slurm"])
        with pytest.raises(ValueError, match="launcher='slurm'"):
            tsweep.run_sweep(cfg, [])


class TestMultirunExpansion:
    @pytest.mark.parametrize("overrides", [
        ["experiment=x", "seed=1,2", "model.lr=0.1,0.2"],
        ["model.depths=[1,1]", "seed=1,2"],
        ["a=1", "b=2"],
        ["+x=1,2,3", "~y", "z=[a,b]"],
        [],
    ])
    def test_equal_jax(self, overrides):
        assert tcli._expand_multirun(overrides) == \
            jcli._expand_multirun(overrides)


class TestMetricsOut:
    def test_write_metrics_out_equals_jax(self, tmp_path, monkeypatch):
        metrics = {"train/loss": 1.5, "n": 3, "note": "skipped",
                   "best/c": "a"}
        for name, fn in (("port", tcli._write_metrics_out),
                         ("jax", jcli._write_metrics_out)):
            monkeypatch.setenv("MEDMOE_METRICS_OUT", str(tmp_path / name))
            assert fn(metrics) is metrics
        assert (tmp_path / "port").read_text() == \
            (tmp_path / "jax").read_text()
        assert json.loads((tmp_path / "port").read_text()) == \
            {"train/loss": 1.5, "n": 3.0}

    def test_round_trip_through_main(self, tmp_path, monkeypatch):
        """The train CLI writes its final metrics where MEDMOE_METRICS_OUT
        says; the subprocess launcher reads them back with the same
        strict lookup."""
        out = tmp_path / "metrics.json"
        monkeypatch.setenv("MEDMOE_METRICS_OUT", str(out))
        metrics = tcli.main(["experiment=pretraining_medmoe"] + TINY + [
            f"paths.root_dir={tmp_path}"])
        written = json.loads(out.read_text())
        assert written == {k: float(v) for k, v in metrics.items()}
        assert math.isfinite(written["train/loss"])
        from medmoe_torch.utils.task import get_metric_value

        assert get_metric_value(written, "train/loss") == \
            metrics["train/loss"]

    def test_not_written_without_the_variable(self, tmp_path, monkeypatch):
        monkeypatch.delenv("MEDMOE_METRICS_OUT", raising=False)
        monkeypatch.chdir(tmp_path)
        tcli._write_metrics_out({"a": 1.0})
        assert os.listdir(tmp_path) == []


class TestSweepRuns:
    def test_in_process_sweep(self, tmp_path):
        """Two TPE trials of the tiny pretraining run in this process."""
        metrics = tcli.main(SWEEP + TINY + [f"paths.root_dir={tmp_path}"])
        assert math.isfinite(metrics["train/loss"])
        lr = metrics["best/model.optimizer.lr"]
        assert 1e-6 <= lr <= 1e-3
        # the best trial's lr is one of the two seed-1234 startup draws
        draws = [jsweep._sample({"lr": {"low": 1e-6, "high": 1e-3,
                                        "log": True}}, rng)["lr"]
                 for rng in [random.Random(1234)] for _ in range(2)]
        assert lr in draws

    def test_subprocess_sweep(self, tmp_path, monkeypatch):
        """One trial as its own `python -m medmoe_torch.cli.train`
        process, its metrics back through MEDMOE_METRICS_OUT."""
        monkeypatch.setenv("PYTHONPATH", ROOT + os.pathsep
                           + os.environ.get("PYTHONPATH", ""))
        monkeypatch.setenv("OMP_NUM_THREADS", "1")
        metrics = tcli.main(SWEEP + TINY + [
            f"paths.root_dir={tmp_path}",
            "hparams_search.launcher=subprocess",
            "hparams_search.n_trials=1"])
        assert math.isfinite(metrics["train/loss"])
        assert "best/model.optimizer.lr" in metrics

    def test_multirun_survives_one_failed_job(self, tmp_path):
        """--multirun runs each job as one run; the second job's expert
        count of 0 fails it, and the multirun goes on."""
        metrics = tcli.main(["-m", "experiment=pretraining_medmoe"] + TINY + [
            f"paths.root_dir={tmp_path}",
            "model.model.vision.num_experts=3,0"])
        assert metrics["multirun/n_jobs"] == 2.0
        assert metrics["multirun/n_failed"] == 1.0
        assert math.isfinite(metrics["job0/train/loss"])
        assert not any(k.startswith("job1/") for k in metrics)


class TestHelp:
    def test_render_help_lists_every_group(self):
        text = _help.render_help("python -m medmoe_torch.cli.train", "d",
                                 ["e"])
        groups = [g for g in sorted(os.listdir(DEFAULT_CONFIG_DIR))
                  if os.path.isdir(os.path.join(DEFAULT_CONFIG_DIR, g))]
        assert len(groups) >= 11
        for group in groups:
            options = sorted(f[:-5] for f in os.listdir(
                os.path.join(DEFAULT_CONFIG_DIR, group)) if f.endswith(".yaml"))
            assert f"  {group}={', '.join(options)}" in text.splitlines()
        assert "~key.path" in text and "examples:\n  e" in text

    @pytest.mark.parametrize("name", ["train", "evaluate", "eval_zs",
                                      "serve", "export"])
    def test_every_cli_help_exits_zero(self, name, monkeypatch, capsys):
        monkeypatch.setattr("sys.argv", ["medmoe-torch", "--help"])
        assert getattr(_script, name)() == 0
        out = capsys.readouterr().out
        assert "config groups:" in out and "hparams_search=" in out
        assert "python -m medmoe_torch.cli." in out
        assert "medmoe_tpu" not in out


class TestScripts:
    def test_as_status(self):
        for ret, status in (({}, 0), ({"a": 1.0}, 0), (None, 0), (0, 0),
                            (3, 3), (1.5, 0)):
            assert _script._as_status(ret) == status

    def test_entry_points_resolve(self):
        import importlib

        with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
            scripts = tomllib.load(f)["project"]["scripts"]
        port = {k: v for k, v in scripts.items()
                if k.startswith("medmoe-torch-")}
        assert sorted(port) == sorted(
            f"medmoe-torch-{n}" for n in ("train", "eval", "eval-zs",
                                          "serve", "export"))
        for name, target in port.items():
            mod, _, fn = target.partition(":")
            assert mod == "medmoe_torch.cli._script", name
            assert callable(getattr(importlib.import_module(mod), fn)), name
            jax_target = scripts[name.replace("medmoe-torch-", "medmoe-")]
            assert jax_target == target.replace("medmoe_torch", "medmoe_tpu")


class TestProfiler:
    def test_fit_writes_a_trace(self, tmp_path):
        metrics = tcli.main(["experiment=pretraining_medmoe"] + TINY + [
            f"paths.root_dir={tmp_path}", "trainer.profiler=torch"])
        assert math.isfinite(metrics["train/loss"])
        out = compose("train", TINY + [f"paths.root_dir={tmp_path}"])
        trace = os.path.join(out.trainer.default_root_dir, "profile",
                             "trace_rank0.json")
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        names = {e.get("name", "") for e in events}
        # the step's own operators are in it
        assert any(n.startswith("aten::") for n in names)
        assert any("linear" in n or "matmul" in n or "mm" in n
                   for n in names)


# what the two config trees may not share: the package of every target,
# the device each package trains on, the XLA-only keys, and these values
DELIBERATE = {
    # the port's trace is torch.profiler's (a Chrome trace)
    "trainer.profiler": ("jax", "torch"),
    # the port's wandb runs go to their own project
    "logger.wandb.project": ("medmoe_tpu", "medmoe_torch"),
}
XLA_ONLY = ("extras.compile_cache", "extras.compile_cache_dir",
            "model.compile")


def _flat(node, prefix=""):
    out = {}
    for k, v in node.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif k == "_target_":
            out[prefix + k] = v.replace("medmoe_tpu.", "medmoe_torch.", 1)
        else:
            out[prefix + k] = v
    return out


def _groups(name):
    return sorted(f[:-5] for f in os.listdir(os.path.join(
        DEFAULT_CONFIG_DIR, name)) if f.endswith(".yaml"))


@pytest.mark.parametrize("overrides", [[]] + [
    [f"experiment={e}"] for e in _groups("experiment")] + [
    ["model=classification"]] + [[f"debug={d}"] for d in _groups("debug")] + [
    [f"hparams_search={h}"] for h in _groups("hparams_search")] + [
    [f"logger={lg}"] for lg in _groups("logger")],
    ids=lambda o: o[0] if o else "default")
def test_train_config_equals_jax(overrides):
    """``train`` composed in both packages is the same run: every value
    equal apart from target packages, ``accelerator``, ``paths``, the
    XLA-only keys and DELIBERATE (ROADMAP.md Queue 3)."""
    port = _flat(to_dict(compose("train", overrides)))
    jax = _flat(jto_dict(medmoe_tpu.compose("train", overrides)))
    skip = lambda k: (k.startswith("paths.") or k.endswith(".accelerator")
                      or k in XLA_ONLY)
    diff = {k: (jax.get(k, "<absent>"), port.get(k, "<absent>"))
            for k in sorted(set(port) | set(jax))
            if not skip(k) and port.get(k, "<absent>") != jax.get(
                k, "<absent>")}
    expected = {k: v for k, v in DELIBERATE.items() if k in diff}
    assert diff == expected
    assert set(jax) - set(port) <= set(XLA_ONLY) | {
        k for k in jax if k.startswith("paths.")}


def test_every_jax_module_and_config_has_a_counterpart():
    """Every .py and .yaml file of medmoe_tpu/ has one in medmoe_torch/,
    apart from the three that need none: the shard_map wrapper of the
    Pallas calls, the TPU trainer group and the Pallas kernels (csrc/)."""
    jroot = os.path.join(ROOT, "medmoe_tpu")
    troot = os.path.join(ROOT, "medmoe_torch")
    missing = []
    for base, _, names in os.walk(jroot):
        for n in names:
            if not n.endswith((".py", ".yaml")):
                continue
            rel = os.path.relpath(os.path.join(base, n), jroot)
            if rel in ("parallel/spmd.py", "configs/trainer/tpu.yaml") \
                    or rel.startswith("ops/pallas/"):
                continue
            if not os.path.exists(os.path.join(troot, rel)):
                missing.append(rel)
    assert not missing
