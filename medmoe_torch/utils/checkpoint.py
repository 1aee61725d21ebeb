"""Checkpoints of the train state (counterpart of
medmoe_tpu/utils/checkpoint.py, on ``torch.save`` instead of orbax).

One file per checkpoint, loadable with ``torch.load(weights_only=True)``
(tensors and plain containers only):
    {"format": FORMAT, "model": state_dict, "optimizer": Adam state_dict,
     "step": int, "scheduler": state_dict or None, "seed": int or None}
and a ``<path>.meta.json`` sidecar with the loop's state (the epoch, the
scheduler, the monitored value). The file is written to ``<path>.tmp``
and moved into place with ``os.replace``; the sidecar is written only
after its file is in place, so a sidecar never names a checkpoint that is
not there.

``blocking=False`` copies every tensor to the host on the caller (copies,
not views: ``Adam.step`` updates the parameters in place) and writes on
one background thread; the next save and ``finalize_saves`` wait for it.
A background write that fails leaves no file, no temporary and no
sidecar, and its error is raised at that next barrier.

Only rank 0 of a ``torch.distributed`` group writes. Under expert
parallelism every rank calls ``save_checkpoint``: the bank and its Adam
moments are all-gathered over each expert group first, so the file holds
the whole bank in the format of one process, and a load cuts it to the
loading rank's experts (``parallel/sharding.py``) on any expert count.
Orbax directories
(the JAX package's checkpoints) are refused: their weights reach the port
as the ``weights.npz`` that ``python -m medmoe_tpu.cli.export`` writes.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import copy
import json
import os
import zipfile
from typing import Any, Dict, Optional

import torch

from medmoe_torch.parallel import collectives as C
from medmoe_torch.parallel import sharding
from medmoe_torch.utils.logging import _process_index

FORMAT = "medmoe_torch.checkpoint/1"
#: loop state that rides in the checkpoint file as well as the sidecar
FILE_EXTRAS = ("scheduler", "seed")

_EXECUTOR = None
#: the in-flight background save: (future, path, sidecar contents)
_PENDING: Optional[tuple] = None


def _to_host(obj: Any) -> Any:
    """A copy of ``obj`` with every tensor copied to host memory."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        out = collections.OrderedDict() \
            if isinstance(obj, collections.OrderedDict) else {}
        for k, v in obj.items():
            out[k] = _to_host(v)
        meta = getattr(obj, "_metadata", None)
        if meta is not None:
            out._metadata = copy.deepcopy(meta)
        return out
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _replace_atomically(path: str, write) -> None:
    """``write(tmp)``, then move ``tmp`` over ``path``; no temporary is
    left behind when ``write`` fails."""
    tmp = path + ".tmp"
    try:
        write(tmp)
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise


def _write_file(path: str, payload: Dict[str, Any]) -> None:
    _replace_atomically(path, lambda tmp: torch.save(payload, tmp))


def _write_meta(path: str, extra: Dict[str, Any]) -> None:
    def write(tmp):
        with open(tmp, "w") as f:
            json.dump({k: (float(v) if hasattr(v, "item") else v)
                       for k, v in extra.items()}, f)

    _replace_atomically(path + ".meta.json", write)


def finalize_saves() -> None:
    """Wait for the in-flight background save, then write its sidecar.
    Raises the background write's error (its sidecar is then never
    written)."""
    global _PENDING
    pending, _PENDING = _PENDING, None
    if pending is None:
        return
    future, path, extra = pending
    future.result()
    if extra:
        _write_meta(path, extra)


def _whole_state(state) -> Dict[str, Any]:
    """``state.state_dict()`` with every sharded bank parameter and its
    Adam moments all-gathered over the expert group (collective)."""
    sd = state.state_dict()
    grid = sharding.bank_grid(state.model)
    if grid is None:
        return sd
    group = grid.expert_group
    sd["model"] = sharding.full_state(state.model, sd["model"], group)
    opt = sd["optimizer"]
    states = dict(opt["state"])
    for i, banked in enumerate(sharding.expert_flags(state.model,
                                                     state.params)):
        if banked and i in states:
            states[i] = {k: C.all_gather_stack(v, group).flatten(
                0, 1) if k in ("exp_avg", "exp_avg_sq") else v
                for k, v in states[i].items()}
    sd["optimizer"] = dict(opt, state=states)
    return sd


def _rank_state(payload: Dict[str, Any], model: torch.nn.Module,
                bank_flags: Optional[list] = None) -> Dict[str, Any]:
    """A file's contents cut to this rank's experts when ``model``'s banks
    are sharded: the model's bank parameters and, with ``bank_flags``
    (``sharding.expert_flags``), their Adam moments."""
    grid = sharding.bank_grid(model)
    if grid is None:
        return payload
    index, size = grid.expert_index, grid.expert
    out = dict(payload, model=sharding.shard_tensors(payload["model"], index,
                                                     size))
    if bank_flags is not None and "optimizer" in payload:
        opt = payload["optimizer"]
        states = dict(opt["state"])
        for i, banked in enumerate(bank_flags):
            if banked and i in states:
                states[i] = {
                    k: v[sharding.expert_slice(v.shape[0], index, size)]
                    .clone() if k in ("exp_avg", "exp_avg_sq") else v
                    for k, v in states[i].items()}
        out["optimizer"] = dict(opt, state=states)
    return out


def save_checkpoint(path: str, state, extra: Optional[Dict[str, Any]] = None,
                    blocking: bool = True) -> None:
    """Save ``state`` (a ``TrainState``) to the file ``path``; ``extra``
    goes to the sidecar, and its ``scheduler`` and ``seed`` into the file
    too. Every rank calls it (the expert bank is gathered first); rank 0
    writes."""
    global _EXECUTOR, _PENDING
    path = os.path.abspath(path)
    finalize_saves()        # one save in flight; "last" may be its path
    whole = _whole_state(state)
    if _process_index() != 0:
        return
    extra = dict(extra or {})
    payload = {"format": FORMAT, **_to_host(whole),
               **{k: copy.deepcopy(extra.get(k)) for k in FILE_EXTRAS}}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if blocking:
        _write_file(path, payload)
        if extra:
            _write_meta(path, extra)
        return
    if _EXECUTOR is None:
        from concurrent.futures import ThreadPoolExecutor

        _EXECUTOR = ThreadPoolExecutor(max_workers=1,
                                       thread_name_prefix="medmoe-ckpt")
        # a process that exits mid-write would leave only the temporary
        atexit.register(finalize_saves)
    _PENDING = (_EXECUTOR.submit(_write_file, path, payload), path, extra)


def _check_file(path: str) -> None:
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint of the JAX "
            f"package?); medmoe_torch reads its own checkpoint files, and "
            f"JAX weights as the weights.npz that `python -m "
            f"medmoe_tpu.cli.export` writes (pass it to the serve CLI's "
            f"ckpt_path)")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint file at {path}")


def checkpoint_kind(path: str) -> str:
    """"torch" for a checkpoint this module wrote, "npz" for a
    ``weights.npz``; raises for anything else. Both are zip archives, so
    this reads the archive's member names."""
    _check_file(path)
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as z:
            names = z.namelist()
        if any(n == "data.pkl" or n.endswith("/data.pkl") for n in names):
            return "torch"
        if names and all(n.endswith(".npy") for n in names):
            return "npz"
    raise ValueError(f"{path} is neither a medmoe_torch checkpoint nor a "
                     f"weights.npz")


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The contents of a checkpoint file (tensors on the CPU)."""
    path = os.path.abspath(path)
    finalize_saves()        # the path may be the in-flight save
    _check_file(path)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or payload.get("format") != FORMAT:
        raise ValueError(f"{path} is not a medmoe_torch checkpoint")
    return payload


def check_model_state(saved: Dict[str, torch.Tensor], model: torch.nn.Module,
                      path: str = "checkpoint") -> None:
    """Raise ValueError naming the first parameter whose name or shape
    differs between ``saved`` and ``model``."""
    live = model.state_dict()
    for name, value in live.items():
        if name not in saved:
            raise ValueError(f"{path} has no parameter {name!r}: wrong "
                             f"checkpoint for this model configuration")
        if tuple(saved[name].shape) != tuple(value.shape):
            raise ValueError(
                f"{path}: parameter {name!r} has shape "
                f"{tuple(saved[name].shape)}, the model {tuple(value.shape)}"
                f" — wrong checkpoint for this model configuration")
    for name in saved:
        if name not in live:
            raise ValueError(f"{path} has parameter {name!r}, which the "
                             f"model does not")


def load_model_weights(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Fill ``model`` from the model ``state_dict`` of the checkpoint file
    ``path`` after checking every parameter's shape (a sharded bank takes
    its experts of the file's whole bank)."""
    saved = _rank_state(load_checkpoint(path), model)["model"]
    check_model_state(saved, model, path)
    model.load_state_dict(saved, strict=True)
    return model


def restore_checkpoint(path: str, state) -> Dict[str, Any]:
    """Load the file ``path`` into ``state`` in place (model, Adam state,
    step) after checking every parameter's shape; returns the file's
    contents (its ``scheduler`` and ``seed`` among them)."""
    payload = _rank_state(load_checkpoint(path), state.model,
                          sharding.expert_flags(state.model, state.params))
    check_model_state(payload["model"], state.model, path)
    state.load_state_dict(payload)
    return payload


def read_meta(path: str) -> Optional[Dict[str, Any]]:
    """The sidecar of the checkpoint ``path``, or None without one."""
    meta = os.path.abspath(path) + ".meta.json"
    if not os.path.exists(meta):
        return None
    with open(meta) as f:
        return json.load(f)
