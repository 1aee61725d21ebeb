"""Joining the process group of a multi-process launch (counterpart of
medmoe_tpu/parallel/multihost.py).

The reference trains data-parallel through Lightning's DDP launcher: one
process a card, ``trainer=ddp trainer.devices=8`` (``num_nodes`` nodes of
``devices`` cards). Here each process joins one ``torch.distributed``
group, from the environment that torchrun sets (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) or that Slurm sets
(``SLURM_PROCID``, ``SLURM_NTASKS``, ``SLURM_LOCALID``, with
``MASTER_ADDR``/``MASTER_PORT`` given by the job script). The train CLI's
own launcher (``medmoe_torch.cli.train``) sets the torchrun variables for
the processes it starts.

The backend is NCCL for the card and gloo for ``accelerator=cpu``.
``maybe_initialize`` is idempotent: a group that is already initialized is
used as it is, whatever its backend (two gloo ranks can share one card
this way; NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

from medmoe_torch.utils.logging import get_logger

log = get_logger(__name__)

#: how long a rank waits for the others to join, and in any collective
TIMEOUT = datetime.timedelta(minutes=10)


def cluster_env() -> Optional[Dict[str, object]]:
    """(rank, world_size, local_rank, master addr/port) of a torchrun or
    Slurm launch, or None when the environment names none. A Slurm job of
    one task is not a cluster."""
    env = os.environ
    if env.get("RANK") not in (None, "") and env.get("WORLD_SIZE"):
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        local = int(env.get("LOCAL_RANK", rank))
    elif env.get("SLURM_PROCID") not in (None, "") \
            and int(env.get("SLURM_NTASKS", "1") or 1) > 1:
        rank, world = int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"])
        local = int(env.get("SLURM_LOCALID", 0))
    else:
        return None
    return {"rank": rank, "world_size": world, "local_rank": local,
            "addr": env.get("MASTER_ADDR", "localhost"),
            "port": env.get("MASTER_PORT")}


def local_rank() -> int:
    """This process's index among its node's ranks (0 without a launch)."""
    spec = cluster_env()
    return int(spec["local_rank"]) if spec else 0


def maybe_initialize(num_nodes: Optional[int] = None,
                     accelerator: str = "gpu") -> bool:
    """Join the launch's process group when the environment names one.

    Without one, and with ``num_nodes`` in (None, 0, 1), it is a no-op and
    returns False. With ``num_nodes > 1`` the environment is required:
    finding none raises rather than training one node's share alone.
    Returns True when a group is up (joined now or before)."""
    if dist.is_initialized():
        return True
    want = bool(num_nodes and int(num_nodes) > 1)
    spec = cluster_env()
    if spec is None:
        if want:
            raise RuntimeError(
                f"trainer.num_nodes={num_nodes} needs a multi-process launch "
                f"(torchrun, or Slurm with MASTER_ADDR/MASTER_PORT set): no "
                f"RANK/WORLD_SIZE or SLURM_PROCID/SLURM_NTASKS in the "
                f"environment")
        return False
    if not spec["port"]:
        raise RuntimeError("a multi-process launch needs MASTER_PORT (and "
                           "MASTER_ADDR) in the environment")
    backend = "gloo" if accelerator == "cpu" else "nccl"
    extra = {}
    if backend == "nccl":
        device = torch.device("cuda", int(spec["local_rank"]))
        torch.cuda.set_device(device)
        extra["device_id"] = device     # binds the communicator to the card
    dist.init_process_group(
        backend, init_method=f"tcp://{spec['addr']}:{spec['port']}",
        world_size=int(spec["world_size"]), rank=int(spec["rank"]),
        timeout=TIMEOUT, **extra)
    log.info(f"joined a {backend} group: rank {spec['rank']} of "
             f"{spec['world_size']} (local rank {spec['local_rank']})")
    return True
