"""The device trace put down to the program's own spans.

The port opens ``torch.profiler.record_function`` ranges named
``medmoe#<layer>[.<part>]`` at its layer boundaries
(``medmoe_torch/utils/trace.py``) while a profiler records. ``attribute``
reads the profiler's events (``prof.events()``, the same list that
``trace.reduce`` reads) and gives:

- ``by_span``: device seconds by program label. A device operation's label
  comes from the host op that launched it (the op its
  ``linked_correlation_id`` names, or where the profiler gives none, the
  CUDA runtime call with the operation's own correlation id), in this
  order: a ``medmoe#`` range opened below the op's nearest
  ``autograd::engine::evaluate_function`` ancestor (a checkpointed
  recompute re-enters its own ranges); otherwise, under such an ancestor,
  the range around the latest forward op that recorded the
  ``sequence_nr`` the ancestor carries (on its ``fwd_thread``), with
  ``.bwd`` appended; otherwise
  the innermost ``medmoe#`` range open on the launching thread. An
  operation with no label counts under ``none``.
- ``span_gaps``: each idle interval of the device within the window, named
  by the label of the thread that launches the operation ending the gap,
  as it was at the gap's start (``gap_ends``: that operation's name;
  ``gap_hosts``: the innermost host op open on that thread then).
- ``labeled_s``: the union of the labelled operations' intervals, beside
  ``busy_s``, the union of all of them (``trace.reduce``'s).

Device operations, the window and its clipping are ``trace.reduce``'s.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from benchmark.trace import WINDOW, _union

PREFIX = "medmoe#"
BACKWARD = "autograd::engine::evaluate_function: "
NONE = "none"


@dataclass
class SpanSummary:
    by_span: Dict[str, float]
    span_gaps: List[Tuple[str, float]] = field(default_factory=list)
    busy_s: float = 0.0
    labeled_s: float = 0.0
    #: device seconds whose launching host event was not found
    unlinked_s: float = 0.0
    #: the name of the device operation that ends each gap of ``span_gaps``
    gap_ends: List[str] = field(default_factory=list)
    #: the innermost host op open at each gap's start on the thread that
    #: launches that operation
    gap_hosts: List[str] = field(default_factory=list)

    def idle_by_span(self) -> Dict[str, Tuple[float, int]]:
        """Idle seconds and gap count by label."""
        out: Dict[str, Tuple[float, int]] = {}
        for name, sec in self.span_gaps:
            s, n = out.get(name, (0.0, 0))
            out[name] = (s + sec, n + 1)
        return out

    def breakdown(self) -> dict:
        """The ten largest labels (``device_spans``) and the ten longest
        gaps (``idle_gaps_program``)."""
        spans = sorted(self.by_span.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.span_gaps, key=lambda g: -g[1])[:10]
        return {"device_spans": [[n, s] for n, s in spans],
                "idle_gaps_program": [[n, s] for n, s in gaps]}


class _Open:
    """A host range on a thread's stack: a ``medmoe#`` range (``name``), a
    backward function (``bwd``: its forward's label + ``.bwd``, or None), or
    another op."""

    __slots__ = ("end", "name", "is_backward", "bwd", "op")

    def __init__(self, end, name, is_backward, bwd, op):
        self.end, self.name = end, name
        self.is_backward, self.bwd, self.op = is_backward, bwd, op


def _label(stack: List[_Open]) -> str:
    """Outward from the innermost open range: the first ``medmoe#`` range,
    or a backward function's forward label, whichever comes first."""
    for o in reversed(stack):
        if o.name is not None:
            return o.name
        if o.is_backward and o.bwd is not None:
            return o.bwd
    return NONE


_IN_BACKWARD = object()


def _forward_label(stack: List[_Open]):
    """The innermost ``medmoe#`` range, None where none is open, or
    ``_IN_BACKWARD`` where a backward function is open inside it (the
    backward node's own events record its number too)."""
    for o in reversed(stack):
        if o.is_backward:
            return _IN_BACKWARD
        if o.name is not None:
            return o.name
    return None


def _is_runtime(e) -> bool:
    """A CUDA API call (``cudaLaunchKernel``, ``cuLaunchKernelEx``,
    ``cudaMemcpyAsync``...), which shares its correlation id with the
    device operation it starts."""
    return e.name.startswith("cu")


def kineto_links(prof) -> Dict[int, int]:
    """{device correlation id: the launching op's id} from a finished
    ``torch.profiler.profile``'s own results, for profilers whose events
    (``prof.events()``) do not carry ``linked_correlation_id``."""
    from torch.autograd import DeviceType

    return {k.correlation_id(): k.linked_correlation_id()
            for k in prof.profiler.kineto_results.events()
            if k.device_type() == DeviceType.CUDA
            and k.linked_correlation_id() > 0}


def _launcher(host, links):
    """device event → the host event that launched it: the op its
    ``linked_correlation_id`` (or ``links[id]``) names, else the runtime
    call with the device event's own correlation id (``id``), which the
    profiler puts on the launching op's thread."""
    ops, runtime = {}, {}
    for e in host:
        if _is_runtime(e):
            runtime[e.id] = e
        elif getattr(e, "linked_correlation_id", 0) == 0:
            ops[e.id] = e

    def find(d):
        link = getattr(d, "linked_correlation_id", 0) or links.get(d.id)
        return (ops.get(link) if link else None) or runtime.get(d.id)

    return find


def attribute(events, spans: Sequence[str],
              links: Optional[Dict[int, int]] = None) -> SpanSummary:
    """Device seconds and idle gaps by program label (module docstring);
    ``spans`` are the benchmark's own, as ``trace.reduce`` takes them;
    ``links`` as ``kineto_links`` gives them."""
    from torch.autograd import DeviceType

    names = set(spans) | {WINDOW}
    host, device = [], []
    window = None
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if e.name in names or "#" in e.name:
                continue                    # annotations, not device work
            device.append(e)
        elif e.name == WINDOW:
            window = (e.time_range.start, e.time_range.end)
        elif not getattr(e, "is_async", False):
            host.append(e)
    if window is None:
        raise RuntimeError("the trace has no traced window")
    w0, w1 = window
    ops = []                        # (start, end, launching op, name)
    launcher = _launcher(host, links or {})
    for d in device:
        a, b = max(d.time_range.start, w0), min(d.time_range.end, w1)
        if b > a:
            ops.append((a, b, launcher(d), d.name))
    busy = _union([(a, b) for a, b, _, _ in ops])

    # the points to label: each operation's launch, and each gap's start
    # on the thread that launches the operation ending the gap
    first_at: Dict[float, tuple] = {}
    for op in sorted(ops, key=lambda o: o[0]):
        first_at.setdefault(op[0], op)
    queries = []                            # (time, thread, slot)
    for i, (_, _, launch, _) in enumerate(ops):
        if launch is not None:
            queries.append((launch.time_range.start, launch.thread, i))
    gap_spans = []                          # (gap start, end)
    at = w0
    for a, b in busy + [(w1, w1)]:
        if a > at:
            gap_spans.append((at, a))
        at = max(at, b)
    for j, (g0, g1) in enumerate(gap_spans):
        launch = first_at[g1][2] if g1 in first_at else None
        if launch is not None:
            queries.append((g0, launch.thread, len(ops) + j))
    labels = [NONE] * (len(ops) + len(gap_spans))
    hosts = [""] * len(gap_spans)

    # one sweep in time order over every thread's ranges: a range opens
    # before a query at the same time, outer ranges before inner ones
    items = [(e.time_range.start, 0, -e.time_range.end, n, e)
             for n, e in enumerate(host)]
    items += [(t, 1, 0, slot, th) for t, th, slot in queries]
    items.sort(key=lambda x: x[:4])
    stacks: Dict[int, List[_Open]] = {}
    forward: Dict[Tuple[int, int], str] = {}
    for t, kind, _, n, what in items:
        thread = what.thread if kind == 0 else what
        stack = stacks.setdefault(thread, [])
        while stack and stack[-1].end <= t:
            stack.pop()
        if kind == 1:
            labels[n] = _label(stack)
            if n >= len(ops) and stack:
                hosts[n - len(ops)] = stack[-1].op
            continue
        e = what
        seq = getattr(e, "sequence_nr", -1)
        if e.name.startswith(BACKWARD):
            fwd = forward.get((getattr(e, "fwd_thread", thread), seq))
            stack.append(_Open(e.time_range.end, None, True,
                               fwd + ".bwd" if fwd else None, e.name))
            continue
        owner = _forward_label(stack) if seq >= 0 else _IN_BACKWARD
        if owner is not _IN_BACKWARD:
            # ops that make no autograd node record the number the next
            # node will take: the latest op with a number is the one that
            # made its node, or one nested in it
            forward[(thread, seq)] = owner
        stack.append(_Open(e.time_range.end,
                           e.name if e.name.startswith(PREFIX) else None,
                           False, None, e.name))

    by_span: Dict[str, float] = {}
    labeled = []
    for i, (a, b, _, _) in enumerate(ops):
        by_span[labels[i]] = by_span.get(labels[i], 0.0) + (b - a) / 1e6
        if labels[i] != NONE:
            labeled.append((a, b))
    gaps = [(labels[len(ops) + j], (g1 - g0) / 1e6)
            for j, (g0, g1) in enumerate(gap_spans)]
    return SpanSummary(
        by_span=by_span, span_gaps=gaps,
        busy_s=sum(b - a for a, b in busy) / 1e6,
        labeled_s=sum(b - a for a, b in _union(labeled)) / 1e6,
        unlinked_s=sum(b - a for a, b, launch, _ in ops
                       if launch is None) / 1e6,
        gap_ends=[first_at[g1][3] if g1 in first_at else ""
                  for _, g1 in gap_spans],
        gap_hosts=hosts)
