"""Hyperparameter search (counterpart of medmoe_tpu/train/sweep.py;
reference configs/hparams_search/mnist_optuna.yaml — Optuna TPE there).

Two built-in samplers behind the same config surface (a search space of
overrides, ``optimized_metric``, direction, ``n_trials``):

  * ``tpe`` (default) — a dependency-free univariate Tree-structured Parzen
    Estimator (Bergstra et al. 2011), the algorithm behind Optuna's default
    ``TPESampler``: after ``n_startup_trials`` random draws, completed
    trials are split into the best γ-fraction ("good") and the rest
    ("bad"); numeric dimensions fit Parzen (Gaussian-kernel) densities
    l(x)/g(x) over the two sets and the next point maximizes l/g over
    sampled candidates; categorical dimensions use smoothed category
    frequencies the same way. Log-scaled dimensions are estimated in
    log-space.
  * ``random`` — uniform/log-uniform/choice sampling.

Both draw from ``random.Random`` and ``numpy.random.RandomState`` as the
JAX package's do, so a seed gives the same draws there and here. Two
launchers run a trial: ``in_process`` (the train CLI's path for one run,
``cli.train.run_job``, which starts a node's ranks when the trial asks for
several devices) and ``subprocess`` (``python -m medmoe_torch.cli.train``
a trial, reporting through ``MEDMOE_METRICS_OUT``). The sampler and its
history stay in this process either way. A failed trial scores +inf and
the sweep goes on.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from medmoe_torch.config import DotDict
from medmoe_torch.utils.logging import get_logger
from medmoe_torch.utils.task import get_metric_value

log = get_logger(__name__)


def _sample(space: Dict[str, Any], rng: random.Random) -> Dict[str, Any]:
    """One random draw from the search space. Entries are either
    {low, high[, log][, int]} intervals or {choices: [...]}."""
    draw = {}
    for key, spec in space.items():
        if isinstance(spec, dict) and "choices" in spec:
            draw[key] = rng.choice(list(spec["choices"]))
        elif isinstance(spec, dict) and "low" in spec:
            lo, hi = float(spec["low"]), float(spec["high"])
            if spec.get("log"):
                draw[key] = math.exp(rng.uniform(math.log(lo), math.log(hi)))
            else:
                draw[key] = rng.uniform(lo, hi)
            if spec.get("int"):
                draw[key] = int(round(draw[key]))
        elif isinstance(spec, list):
            draw[key] = rng.choice(spec)
        else:
            draw[key] = spec
    return draw


class TPESampler:
    """Univariate TPE over independent dimensions (Optuna-default shape)."""

    def __init__(self, space: Dict[str, Any], seed: int = 0,
                 n_startup_trials: int = 5, gamma: float = 0.25,
                 n_candidates: int = 24):
        self.space = space
        self.rng = random.Random(seed)
        self.np_rng = np.random.RandomState(seed)
        self.n_startup = n_startup_trials
        self.gamma = gamma
        self.n_candidates = n_candidates

    # -- numeric Parzen estimator -------------------------------------
    @staticmethod
    def _parzen(vals: Sequence[float], lo: float, hi: float
                ) -> Tuple[np.ndarray, np.ndarray]:
        """Component means + the classic TPE adjacent-gap bandwidths."""
        mus = np.sort(np.asarray(vals, np.float64))
        span = hi - lo
        if len(mus) == 1:
            sigmas = np.asarray([span])
        else:
            padded = np.concatenate([[lo], mus, [hi]])
            left = padded[1:-1] - padded[:-2]
            right = padded[2:] - padded[1:-1]
            sigmas = np.maximum(left, right)
        sigmas = np.clip(sigmas, span / max(100, len(mus) * 10), span)
        return mus, sigmas

    @staticmethod
    def _log_mixture_pdf(x: np.ndarray, mus: np.ndarray, sigmas: np.ndarray
                         ) -> np.ndarray:
        z = (x[:, None] - mus[None, :]) / sigmas[None, :]
        comp = (-0.5 * z * z - np.log(sigmas[None, :])
                - 0.5 * math.log(2 * math.pi))
        m = comp.max(axis=1, keepdims=True)
        return (m[:, 0] + np.log(np.mean(np.exp(comp - m), axis=1) + 1e-300))

    def _suggest_numeric(self, spec: Dict[str, Any], good: List[float],
                         bad: List[float]) -> float:
        lo, hi = float(spec["low"]), float(spec["high"])
        use_log = bool(spec.get("log"))
        tf = math.log if use_log else (lambda v: float(v))
        t_lo, t_hi = tf(lo), tf(hi)
        g_mus, g_sig = self._parzen([tf(v) for v in good], t_lo, t_hi)
        b_mus, b_sig = self._parzen([tf(v) for v in bad] or [0.5 * (t_lo + t_hi)],
                                    t_lo, t_hi)
        # candidates drawn from l (the good-trial density)
        comp = self.np_rng.randint(0, len(g_mus), size=self.n_candidates)
        cands = self.np_rng.normal(g_mus[comp], g_sig[comp])
        cands = np.clip(cands, t_lo, t_hi)
        score = (self._log_mixture_pdf(cands, g_mus, g_sig)
                 - self._log_mixture_pdf(cands, b_mus, b_sig))
        best = float(cands[int(np.argmax(score))])
        value = math.exp(best) if use_log else best
        return int(round(value)) if spec.get("int") else value

    def _suggest_categorical(self, choices: List[Any], good: List[Any],
                             bad: List[Any]) -> Any:
        def probs(vals):
            counts = np.asarray([1.0 + sum(v == c for v in vals)
                                 for c in choices])
            return counts / counts.sum()

        ratio = probs(good) / probs(bad)
        return choices[int(np.argmax(ratio))]

    def suggest(self, history: List[Tuple[Dict[str, Any], float]]
                ) -> Dict[str, Any]:
        """history: (draw, value) with LOWER value = better (callers flip
        the sign for maximize)."""
        finite = [(d, v) for d, v in history if math.isfinite(v)]
        if len(finite) < self.n_startup:
            return _sample(self.space, self.rng)
        finite.sort(key=lambda dv: dv[1])
        n_good = max(1, int(math.ceil(self.gamma * len(finite))))
        good = [d for d, _ in finite[:n_good]]
        bad = [d for d, _ in finite[n_good:]] or good
        draw = {}
        for key, spec in self.space.items():
            g = [d[key] for d in good if key in d]
            b = [d[key] for d in bad if key in d]
            if isinstance(spec, dict) and "low" in spec and g:
                draw[key] = self._suggest_numeric(spec, g, b)
            elif ((isinstance(spec, dict) and "choices" in spec)
                  or isinstance(spec, list)):
                choices = list(spec["choices"]) if isinstance(spec, dict) \
                    else list(spec)
                draw[key] = self._suggest_categorical(choices, g, b) \
                    if g else self.rng.choice(choices)
            else:
                draw[key] = _sample({key: spec}, self.rng)[key]
        return draw


def _run_trial_subprocess(trial_overrides: List[str], metric: str) -> float:
    """Run one trial as ``python -m medmoe_torch.cli.train ...`` in its own
    process (the reference's submitit launcher runs one SLURM job a trial):
    a fresh process releases the card's memory between trials. The child
    writes its final metrics to the json file ``MEDMOE_METRICS_OUT`` names
    (``cli.train._write_metrics_out``)."""
    import json
    import os
    import subprocess
    import sys
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        out_path = os.path.join(td, "metrics.json")
        env = dict(os.environ, MEDMOE_METRICS_OUT=out_path)
        cmd = [sys.executable, "-m", "medmoe_torch.cli.train",
               *trial_overrides, "hparams_search=null"]
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"trial subprocess exited {proc.returncode}: "
                f"{proc.stderr[-2000:]}")
        with open(out_path) as f:
            metrics = json.load(f)
    return get_metric_value(metrics, metric)


def _run_trial_in_process(trial_overrides: List[str], metric: str) -> float:
    from medmoe_torch.cli.train import run_job

    metrics = run_job(trial_overrides + ["hparams_search=null"])
    return get_metric_value(metrics, metric)


def run_sweep(cfg: DotDict, base_overrides: List[str]) -> Dict[str, float]:
    hs = cfg.hparams_search
    metric = hs.get("optimized_metric", cfg.get("optimized_metric",
                                                "val/loss"))
    direction = hs.get("direction", "minimize")
    sign = 1.0 if direction == "minimize" else -1.0
    n_trials = int(hs.get("n_trials", 10))
    space = hs.get("params", {})
    seed = int(hs.get("seed", cfg.get("seed") or 0))
    sampler_name = str(hs.get("sampler", "tpe"))
    launcher = str(hs.get("launcher", "in_process"))
    run_trial = {"subprocess": _run_trial_subprocess,
                 "in_process": _run_trial_in_process}.get(launcher)
    if run_trial is None:
        raise ValueError(f"hparams_search.launcher={launcher!r}: expected "
                         f"in_process or subprocess")
    rng = random.Random(seed)
    tpe = TPESampler(space, seed=seed,
                     n_startup_trials=int(hs.get("n_startup_trials", 5)),
                     gamma=float(hs.get("gamma", 0.25)),
                     n_candidates=int(hs.get("n_candidates", 24))) \
        if sampler_name == "tpe" else None

    history: List[Tuple[Dict[str, Any], float]] = []
    best_value = None
    best_params: Dict[str, Any] = {}
    for trial in range(n_trials):
        # the sampler and its history live in this process whatever the
        # launcher, so TPE state carries across trials
        draw = tpe.suggest(history) if tpe is not None \
            else _sample(space, rng)
        trial_overrides = [o for o in base_overrides
                           if not o.lstrip("~+").startswith("hparams_search")]
        trial_overrides += [f"{k}={v}" for k, v in draw.items()]
        log.info(f"trial {trial} [{sampler_name}/{launcher}]: {draw}")
        try:
            value = run_trial(trial_overrides, metric)
        except Exception as e:      # a failed trial must not kill the sweep
            log.warning(f"trial {trial} failed: {e!r}")
            history.append((draw, float("inf")))
            continue
        history.append((draw, sign * value))
        better = (best_value is None
                  or (direction == "minimize" and value < best_value)
                  or (direction == "maximize" and value > best_value))
        if better:
            best_value, best_params = value, draw
        log.info(f"trial {trial}: {metric}={value} (best={best_value})")

    log.info(f"sweep done: best {metric}={best_value} with {best_params}")
    return {metric: best_value, **{f"best/{k}": v
                                   for k, v in best_params.items()}}
