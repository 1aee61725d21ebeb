"""The device trace of a short window, reduced to what the per-layer
metrics read.

``profile(fn, spans)`` runs ``fn`` under ``torch.profiler`` (host and
device activities) inside a ``traced_window`` range, and reduces:

- ``window_s``: the traced window's length (its host range);
- ``busy_s``: the union of the device operations' intervals (kernels,
  copies, sets) within it; the idle share is 1 − busy/window;
- ``kernels``: device seconds by operation name;
- ``gaps``: each idle interval of the device within the window, named by
  the benchmark's innermost span open on the host when it began.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence, Tuple

WINDOW = "traced_window"


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: Dict[str, float]
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps, key=lambda g: -g[1])[:10]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}

    def device_s(self, names: Sequence[str]) -> float:
        """Device seconds of the operations whose name holds one of
        ``names``."""
        return sum(s for k, s in self.kernels.items()
                   if any(n in k for n in names))


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def reduce(events, spans: Sequence[str]) -> TraceSummary:
    """Reduce the profiler's events (``prof.events()``: ``name``,
    ``device_type``, ``time_range`` in microseconds)."""
    from torch.autograd import DeviceType

    host, device = [], []
    window = None
    names = set(spans) | {WINDOW}
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if e.name in names or "#" in e.name:
                continue                    # annotations, not device work
            device.append((e.name, tr.start, tr.end))
        elif e.name == WINDOW:
            window = (tr.start, tr.end)
        elif e.name in names:
            host.append((e.name, tr.start, tr.end))
    if window is None:
        raise RuntimeError("the trace has no traced window")
    w0, w1 = window
    kernels: Dict[str, float] = {}
    clipped = []
    for name, a, b in device:
        a, b = max(a, w0), min(b, w1)
        if b > a:
            kernels[name] = kernels.get(name, 0.0) + (b - a) / 1e6
            clipped.append((a, b))
    busy = _union(clipped)
    gaps = []
    at = w0
    for a, b in busy + [(w1, w1)]:
        if a > at:
            open_spans = [h for h in host if h[1] <= at < h[2]]
            name = max(open_spans, key=lambda h: h[1])[0] if open_spans \
                else "none"
            gaps.append((name, (a - at) / 1e6))
        at = max(at, b)
    return TraceSummary(window_s=(w1 - w0) / 1e6,
                        busy_s=sum(b - a for a, b in busy) / 1e6,
                        kernels=kernels, gaps=gaps)


def profile(fn: Callable[[], None], spans: Sequence[str]) -> TraceSummary:
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    t0 = time.perf_counter()
    summary = reduce(prof.events(), spans)
    print(f"benchmark: trace reduced in {time.perf_counter() - t0:.1f} s "
          f"({len(summary.kernels)} device operation names)",
          file=sys.stderr, flush=True)
    return summary
