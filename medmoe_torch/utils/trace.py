"""The port's spans and counters.

Spans: ``span(name)`` opens a ``torch.profiler.record_function`` range
while a ``torch.profiler`` records, and is one shared no-op otherwise (one
check of ``torch.autograd._profiler_enabled``). A range sits on the
profiler's own clock, the clock of the device events, so nothing here
times anything. Every name is ``medmoe#<layer>[.<part>]`` (``SPANS``): the
profiler also emits each range as a device-side annotation, and readers of
the device trace drop device events whose name holds ``#``, so the spans
add nothing to the device's busy time. A backward op carries the sequence
number of the forward op that made it (``sequence_nr`` of the
``autograd::engine::evaluate_function`` event), so the device time of the
backward is put down to the forward's span without a span of its own.

Counters, one registry:

- host integers (``count(name, n)``, ``n`` an int) always count: the
  hand-written kernels' launches (``launches.<kernel>``), and the GLoRIA
  kernel backward's prologues by their source, ``gloria.kept`` (from K3's
  kept state) or ``gloria.recomputed`` (F1 and F2 run again;
  ``ops/gloria_attention.py`` ``pair_cotangents``), and ``gloria.words``,
  one a GLoRIA similarity backward that takes the words' gradient (on a
  card its prologue sums K4b's terms and K4b runs; on the CPU the plain
  version computes it);
- device tensors (``count(name, t)``, ``t`` a tensor) are added to on the
  device only while the profiler records, with no host sync:
  ``moe.images_per_expert`` (top-1 ids, [K]) and ``moe.kept`` (top-k
  assignments under an expert's capacity). Beside them ``models/moe.py``
  counts ``moe.assignments`` (B·k) and ``moe.slots`` (K·C) as host
  integers, and only while the profiler records, so that all four cover
  the same profiled window.

``counters()`` gives a snapshot as plain numbers (the one read of the
device counters) and ``reset()`` clears both kinds.
"""

from __future__ import annotations

from typing import Dict, Union

import torch

#: every span the port opens: its layer and part
SPANS = frozenset({
    "medmoe#step.forward", "medmoe#step.backward", "medmoe#step.optimizer",
    "medmoe#bert", "medmoe#bert.merge", "medmoe#swin",
    "medmoe#moe.router", "medmoe#moe.experts", "medmoe#moe.dispatch",
    "medmoe#moe.grouped", "medmoe#moe.combine",
    "medmoe#loss.local", "medmoe#loss.global", "medmoe#loss.router",
    "medmoe#serve.h2d", "medmoe#serve.scores",
})

#: the launch counters' registry names, by the module attribute that reads
#: each (``ops/expert_fusion.py``, ``ops/gloria_attention.py``)
LAUNCH_COUNTERS = {
    "expert_fusion": {"LAUNCHES": "launches.K1",
                      "BWD_LAUNCHES": "launches.K2"},
    "gloria_attention": {"LAUNCHES": "launches.K3",
                         "PROLOGUE_LAUNCHES": "launches.prologue",
                         "DCTX_LAUNCHES": "launches.K4a",
                         "DWORDS_LAUNCHES": "launches.K4b"},
}

#: the GLoRIA prologue's two sources (``ops/gloria_attention.py``)
GLORIA_KEPT = "gloria.kept"
GLORIA_RECOMPUTED = "gloria.recomputed"
#: GLoRIA similarity backwards that take the words' gradient (K4b's)
GLORIA_WORDS = "gloria.words"

enabled = torch.autograd._profiler_enabled


class _Off:
    """The span while no profiler records: enters and exits doing
    nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """A context manager around one layer's work: a profiler range named
    ``name`` (one of ``SPANS``) while a profiler records, else the shared
    no-op."""
    if not enabled():
        return _OFF
    if name not in SPANS:
        raise KeyError(f"unknown span {name!r}")
    return torch.profiler.record_function(name)


_HOST: Dict[str, int] = {}
_DEVICE: Dict[str, torch.Tensor] = {}


def count(name: str, n: Union[int, torch.Tensor] = 1) -> None:
    """Add ``n`` to the counter ``name``: an int to a host counter, always;
    a tensor to a device counter (the same shape every time), only while a
    profiler records."""
    if isinstance(n, torch.Tensor):
        if not enabled():
            return
        n = n.detach()
        have = _DEVICE.get(name)
        if have is None:
            _DEVICE[name] = n.clone()
        else:
            have.add_(n.to(have.dtype))
        return
    _HOST[name] = _HOST.get(name, 0) + int(n)


def counters() -> Dict[str, Union[int, float, list]]:
    """Every counter as plain numbers: host counters as ints, device
    counters read once from the device (a scalar as a number, else a
    list)."""
    out: Dict[str, Union[int, float, list]] = dict(_HOST)
    for name, t in _DEVICE.items():
        out[name] = t.tolist()
    return out


def reset() -> None:
    """Clear every counter, host and device."""
    _HOST.clear()
    _DEVICE.clear()


def module_counter(module: str, attr: str) -> int:
    """The launch counter a module attribute names (``LAUNCH_COUNTERS``);
    raises AttributeError for another attribute, as a module does."""
    names = LAUNCH_COUNTERS[module]
    if attr not in names:
        raise AttributeError(f"module 'medmoe_torch.ops.{module}' has no "
                             f"attribute {attr!r}")
    return _HOST.get(names[attr], 0)
