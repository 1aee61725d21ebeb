"""Train CLI of the PyTorch port (counterpart of medmoe_tpu/cli/train.py;
reference ``python src/train.py experiment=...``). Overrides are
hydra-style ``key=value`` arguments.

    python -m medmoe_torch.cli.train experiment=pretraining_medmoe \\
        data=synthetic
    python -m medmoe_torch.cli.train experiment=pretraining_medmoe_ddp \\
        data=synthetic debug=fdr trainer.accelerator=cpu
    python -m medmoe_torch.cli.train experiment=pretraining_medmoe_ddp \\
        ckpt_path=logs/train/runs/checkpoints/last      # resume

Training runs on the CUDA card; ``trainer.accelerator=cpu`` asks for the
CPU. With no ``experiment=`` the run is ``pretraining_medmoe``, as in the
JAX package.

Sweeps: ``hparams_search=medmoe_tpe`` (or ``medmoe_random``) runs
``hparams_search.n_trials`` trials drawn by ``train/sweep.py``, in this
process or one process a trial (``hparams_search.launcher=subprocess``),
and returns the best ``optimized_metric`` with its ``best/<key>`` draws.
``--multirun`` (``-m``) runs the cartesian product of comma-separated
values (``model.loss.temp3=5,10``) one job after another, each as one run;
a failed job is counted in ``multirun/n_failed`` and the rest go on. When
``MEDMOE_METRICS_OUT`` names a file, the final metrics are written there
as JSON (the subprocess launcher reads them back).

Data-parallel training (the reference's ``trainer=ddp trainer.devices=8``):

    python -m medmoe_torch.cli.train experiment=gloria256 data=synthetic \
        trainer=ddp trainer.devices=2                # this CLI starts rank 1
    torchrun --nproc_per_node=2 -m medmoe_torch.cli.train \
        experiment=gloria256 data=synthetic trainer=ddp trainer.devices=2
    python -m medmoe_torch.cli.train ... trainer=ddp_sim   # 2 CPU ranks, gloo

Without a launch environment and with ``trainer.devices > 1`` the CLI
starts ``devices - 1`` more processes of itself with torchrun's variables
set (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``) and becomes rank 0; it stops the others when one fails.
Under torchrun or Slurm it only joins the group. ``data.batch_size`` is
one node's batch, split over its ranks.

Expert parallelism (the JAX package's ``trainer=ep``): ``trainer.mesh``
lays the ``devices × num_nodes`` ranks out as a data × expert grid, each
expert bank sharded over the expert axis (``parallel/mesh.py``):

    python -m medmoe_torch.cli.train experiment=ep_full_mix data=synthetic \
        trainer.devices=4                    # 2 data x 2 expert ranks
    python -m medmoe_torch.cli.train experiment=gloria256 data=synthetic \
        trainer=ep_sim trainer.accelerator=cpu   # 4 CPU ranks, gloo

``trainer.devices`` counts ranks; a grid that does not divide them raises
before any rank starts. ``data.batch_size`` is then split over a node's
data ranks: the e ranks of an expert group read the same rows.
"""

from __future__ import annotations

import os
import random
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from medmoe_torch.config import compose, to_dict
from medmoe_torch.parallel.mesh import MeshSpec, init_grid
from medmoe_torch.parallel.multihost import cluster_env, maybe_initialize
from medmoe_torch.train.loop import resolve_devices
from medmoe_torch.utils.instantiate import instantiate
from medmoe_torch.utils.logging import get_logger
from medmoe_torch.utils.task import extras, get_metric_value, task_wrapper

log = get_logger(__name__)


def seed_everything(seed: Optional[int]) -> None:
    if seed is None:
        return
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def _instantiate_group(node) -> List:
    """A config group of named ``_target_`` entries (callbacks, logger) →
    the objects, in order."""
    if not node:
        return []
    return [instantiate(v) for v in node.values()
            if isinstance(v, dict) and "_target_" in v]


def data_ranks_per_node(tcfg) -> int:
    """The ranks of one node that read different rows: ``trainer.devices``
    over the grid's expert axis. Raises ValueError when the grid
    (``trainer.mesh``) does not divide the ``devices × num_nodes`` ranks,
    or when an expert group neither fits in a node nor spans whole
    nodes."""
    devices = resolve_devices(tcfg.get("devices", 1),
                              tcfg.get("accelerator", "gpu"))
    nodes = int(tcfg.get("num_nodes", 1) or 1)
    _, e = MeshSpec.from_config(tcfg.get("mesh")).resolve(devices * nodes)
    if devices % e and e % devices:
        raise ValueError(f"trainer.mesh.expert={e} neither divides nor is a "
                         f"multiple of trainer.devices={devices}: an expert "
                         f"group must fit in a node or span whole nodes")
    return max(1, devices // e)


def fit_vocab(cfg, datamodule) -> None:
    """Widen ``model.model.text.vocab_size`` to the datamodule tokenizer's
    vocabulary (a corpus-built vocab can exceed the configured size, and a
    config without one takes the tokenizer's). The model is built with its
    final shape, so this is settled before the module exists."""
    tokenizer = getattr(datamodule, "tokenizer", None)
    if tokenizer is not None:
        text = cfg.model.model.text
        text["vocab_size"] = max(int(text.get("vocab_size", 0)),
                                 tokenizer.vocab_size)


@task_wrapper
def train(cfg) -> Tuple[Dict[str, float], Dict]:
    """Instantiate everything from the config, fit (resuming from
    ``ckpt_path`` when set), optionally test with the best checkpoint
    (reference src/train.py:42-108)."""
    seed_everything(cfg.get("seed"))
    tcfg = cfg.get("trainer") or {}
    accelerator = tcfg.get("accelerator", "gpu")
    # the group and the grid come first: the data split reads the rank's
    # data coordinate
    ranks_per_node = data_ranks_per_node(tcfg)
    maybe_initialize(tcfg.get("num_nodes", 1), accelerator)
    init_grid(tcfg.get("mesh"))

    log.info(f"instantiating datamodule <{cfg.data._target_}>")
    datamodule = instantiate(cfg.data, ranks_per_node=ranks_per_node)
    fit_vocab(cfg, datamodule)

    log.info(f"instantiating module <{cfg.model._target_}>")
    module = instantiate(cfg.model)
    callbacks = _instantiate_group(cfg.get("callbacks"))
    loggers = _instantiate_group(cfg.get("logger"))

    log.info("instantiating trainer")
    trainer = instantiate(cfg.trainer, callbacks=callbacks, loggers=loggers,
                          seed=cfg.get("seed") or 0)
    for logger in loggers:
        logger.log_hyperparams(to_dict(cfg))

    metrics: Dict[str, float] = {}
    if cfg.get("train", True):
        trainer.fit(module, datamodule, ckpt_path=cfg.get("ckpt_path"))
        if trainer.metrics_history:
            metrics.update(trainer.metrics_history[-1])
    if cfg.get("test", False):
        ckpt = trainer.best_model_path
        if not ckpt:
            log.warning("best ckpt not found — testing with current weights")
        metrics.update(trainer.test(module, datamodule, ckpt_path=ckpt))
    return metrics, {"trainer": trainer, "module": module,
                     "datamodule": datamodule}


def _run_one(cfg, overrides: List[str]) -> Dict[str, float]:
    tcfg = cfg.get("trainer") or {}
    # the group before extras: only rank 0 writes the config tree
    maybe_initialize(tcfg.get("num_nodes", 1), tcfg.get("accelerator", "gpu"))
    extras(cfg)
    if cfg.get("hparams_search"):
        from medmoe_torch.train.sweep import run_sweep

        return run_sweep(cfg, overrides)
    metrics, _ = train(cfg)
    metric_name = cfg.get("optimized_metric")
    if metric_name:
        get_metric_value(metrics, metric_name)
    return metrics


#: marks a rank that this CLI started, with its launcher's pid
_LAUNCHER_ENV = "MEDMOE_LAUNCHER_PID"
_GROUP_ENV = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _watch(check, what: str) -> None:
    """A daemon thread that ends this process when ``check()`` returns a
    message: a rank that died leaves the others waiting in a collective
    until its timeout."""
    def run():
        while True:
            msg = check()
            if msg:
                log.error(f"{what}: {msg}; stopping")
                sys.stdout.flush()
                os._exit(1)
            time.sleep(1.0)

    threading.Thread(target=run, daemon=True, name=f"medmoe-{what}").start()


def _launch_node(cfg, overrides: List[str]) -> List[subprocess.Popen]:
    """Start this node's ranks 1 … devices-1 when no launch environment
    exists and ``trainer.devices > 1``; this process becomes rank 0 (its
    environment is set here). Returns the started processes."""
    launcher = os.environ.get(_LAUNCHER_ENV)
    if launcher:                      # a rank this CLI started: watch it
        _watch(lambda: "the launching rank exited"
               if os.getppid() != int(launcher) else None, "launcher")
    tcfg = cfg.get("trainer") or {}
    accelerator = tcfg.get("accelerator", "gpu")
    devices = resolve_devices(tcfg.get("devices", 1), accelerator)
    data_ranks_per_node(tcfg)         # a grid that does not divide raises
    if devices <= 1 or cluster_env() is not None or dist.is_initialized():
        return []
    if int(tcfg.get("num_nodes", 1) or 1) > 1:
        return []                     # maybe_initialize raises for this
    env = {"WORLD_SIZE": str(devices), "LOCAL_WORLD_SIZE": str(devices),
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()),
           _LAUNCHER_ENV: str(os.getpid())}
    if "OMP_NUM_THREADS" not in os.environ:
        # one intra-op thread a rank unless asked otherwise, as torchrun
        # sets for several processes a node
        env["OMP_NUM_THREADS"] = "1"
        torch.set_num_threads(1)
    children = []
    for rank in range(1, devices):
        children.append(subprocess.Popen(
            [sys.executable, "-m", "medmoe_torch.cli.train", *overrides],
            env={**os.environ, **env, "RANK": str(rank),
                 "LOCAL_RANK": str(rank)}))
    os.environ.update({k: v for k, v in env.items()
                       if k in _GROUP_ENV})
    os.environ.update({"RANK": "0", "LOCAL_RANK": "0"})

    def failed():
        for rank, child in enumerate(children, 1):
            if child.poll() not in (None, 0):
                return f"rank {rank} exited with code {child.returncode}"
        return None

    _watch(failed, "rank watch")
    log.info(f"started ranks 1-{devices - 1} of {devices}")
    return children


def run_job(overrides: List[str]) -> Dict[str, float]:
    """One run of ``overrides``: compose, start the node's other ranks
    (``_launch_node``; a sweep's parent starts none: its trials do), run,
    close the process group this run opened and wait for the ranks."""
    cfg = compose("train", overrides)
    saved = {k: os.environ.get(k) for k in _GROUP_ENV}
    owns_group = not (dist.is_available() and dist.is_initialized())
    children = [] if cfg.get("hparams_search") \
        else _launch_node(cfg, overrides)
    try:
        metrics = _run_one(cfg, overrides)
    except BaseException:
        for child in children:
            child.terminate()
        raise
    finally:
        if owns_group and dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    for rank, child in enumerate(children, 1):
        if child.wait() != 0:
            raise RuntimeError(f"rank {rank} exited with code "
                               f"{child.returncode}")
    return metrics


def _expand_multirun(overrides: List[str]) -> List[List[str]]:
    """Hydra ``--multirun`` comma-sweep syntax: ``key=a,b,c`` values fan out
    into the cartesian product of jobs. Bracketed list values
    (``depths=[1,1]``) are single values, not sweeps."""
    import itertools

    fixed: List[str] = []
    swept: List[List[Tuple[str, str]]] = []
    for o in overrides:
        key, sep, val = o.partition("=")
        if sep and "," in val and not val.lstrip("+~").startswith("["):
            swept.append([(key, v) for v in val.split(",")])
        else:
            fixed.append(o)
    if not swept:
        return [fixed]
    return [fixed + [f"{k}={v}" for k, v in combo]
            for combo in itertools.product(*swept)]


def _write_metrics_out(metrics: Dict[str, float]) -> Dict[str, float]:
    """The final-metrics contract with a parent process: when
    ``MEDMOE_METRICS_OUT`` names a path, write the run's numeric metrics
    there as JSON (the sweep's subprocess launcher and external schedulers
    read it). Rank 0 writes: the ranks this CLI or torchrun started have
    ``RANK`` set, and their group is closed by now."""
    import json

    out_path = os.environ.get("MEDMOE_METRICS_OUT")
    if out_path and int(os.environ.get("RANK", "0")) == 0:
        with open(out_path, "w") as f:
            json.dump({k: float(v) for k, v in metrics.items()
                       if isinstance(v, (int, float))}, f)
    return metrics


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    overrides = list(argv if argv is not None else sys.argv[1:])
    from medmoe_torch.cli._help import maybe_print_help

    if maybe_print_help(
            overrides, "python -m medmoe_torch.cli.train",
            "Train MedMoE (pretraining or classification).",
            ["python -m medmoe_torch.cli.train experiment=pretraining_medmoe",
             "python -m medmoe_torch.cli.train experiment=pretraining_medmoe "
             "data=synthetic debug=fdr trainer.accelerator=cpu",
             "python -m medmoe_torch.cli.train --multirun "
             "experiment=pretraining_medmoe model.loss.temp3=5,10"]):
        return {}
    multirun = False
    for flag in ("-m", "--multirun"):
        while flag in overrides:
            overrides.remove(flag)
            multirun = True
    if not multirun:
        return _write_metrics_out(run_job(overrides))

    # one process runs the jobs in turn; a failed job is logged and
    # counted, and the others run (the reference gets this from
    # @task_wrapper + submitit, utils.py:147-175)
    jobs = _expand_multirun(overrides)
    log.info(f"multirun: {len(jobs)} jobs")
    out: Dict[str, float] = {"multirun/n_jobs": float(len(jobs)),
                             "multirun/n_failed": 0.0}
    for i, job in enumerate(jobs):
        log.info(f"multirun job {i}: {job}")
        try:
            metrics = run_job(job)
        except Exception as e:
            log.warning(f"multirun job {i} FAILED: {e!r}")
            out["multirun/n_failed"] += 1.0
            continue
        for k, v in metrics.items():
            if isinstance(v, (int, float)):
                out[f"job{i}/{k}"] = float(v)
    return _write_metrics_out(out)


if __name__ == "__main__":
    main()
